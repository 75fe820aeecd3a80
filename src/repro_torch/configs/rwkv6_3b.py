"""rwkv6-3b [ssm] — RWKV-6 "Finch": 32L d_model=2560 (attention-free,
data-dependent decay WKV), channel-mix d_ff=8960, vocab=65536.
[arXiv:2404.05892]
"""

from repro_torch.configs.base import ArchConfig, arch_registry


@arch_registry.register("rwkv6-3b")
def rwkv6_3b() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-3b",
        family="ssm",
        source="arXiv:2404.05892",
        num_layers=32,
        d_model=2560,
        num_heads=40,            # WKV heads, head_dim 64
        num_kv_heads=40,
        head_dim=64,
        d_ff=8960,
        vocab_size=65536,
        mixer="rwkv6",
        attn_type="none",
        tie_embeddings=True,
    )
