"""phi3-medium-14b [dense] — 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352; RoPE + SwiGLU + GQA.  [arXiv:2404.14219]
"""

from repro_torch.configs.base import ArchConfig, arch_registry


@arch_registry.register("phi3-medium-14b")
def phi3_medium_14b() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b",
        family="dense",
        source="arXiv:2404.14219",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        vocab_size=100352,
        rope_theta=10000.0,
        tie_embeddings=False,
        fsdp=True,
    )
