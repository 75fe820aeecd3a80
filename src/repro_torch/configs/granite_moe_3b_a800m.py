"""granite-moe-3b-a800m [moe] — IBM Granite 3.0 MoE family.

32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512 vocab=49155,
MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]
(Assignment note: the structured field says 40e; the bracket note says 32e —
we follow the structured field, recorded in DESIGN.md.)
"""

from repro_torch.configs.base import ArchConfig, arch_registry


@arch_registry.register("granite-moe-3b-a800m")
def granite_moe_3b_a800m() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        num_experts=40,
        num_experts_per_tok=8,
        moe_d_ff=512,
        rope_theta=10000.0,
        tie_embeddings=True,
    )
