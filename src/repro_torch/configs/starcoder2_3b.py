"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152; GQA + RoPE.  [arXiv:2402.19173]
"""

from repro_torch.configs.base import ArchConfig, arch_registry


@arch_registry.register("starcoder2-3b")
def starcoder2_3b() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-3b",
        family="dense",
        source="arXiv:2402.19173",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab_size=49152,
        rope_theta=100000.0,
        tie_embeddings=True,
    )
