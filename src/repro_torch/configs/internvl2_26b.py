"""internvl2-26b [vlm] — InternViT (stub frontend) + InternLM2 backbone:
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  [arXiv:2404.16821]

Per the assignment carve-out, the vision encoder + projector are a STUB:
``input_specs`` provides precomputed patch embeddings (B, num_prefix, d_model)
which the language model consumes prepended to the token stream.
"""

from repro_torch.configs.base import ArchConfig, arch_registry


@arch_registry.register("internvl2-26b")
def internvl2_26b() -> ArchConfig:
    return ArchConfig(
        name="internvl2-26b",
        family="vlm",
        source="arXiv:2404.16821",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92553,
        rope_theta=1000000.0,
        frontend="vision_stub",
        num_prefix=256,          # one tile of ViT patch embeddings
        tie_embeddings=False,
        fsdp=True,
    )
