"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936; qk_norm + GQA.  [hf:Qwen/Qwen3-8B family]
"""

from repro_torch.configs.base import ArchConfig, arch_registry


@arch_registry.register("qwen3-14b")
def qwen3_14b() -> ArchConfig:
    return ArchConfig(
        name="qwen3-14b",
        family="dense",
        source="hf:Qwen/Qwen3-8B",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1000000.0,
        tie_embeddings=False,
        fsdp=True,
    )
