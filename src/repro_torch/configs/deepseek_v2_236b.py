"""deepseek-v2-236b [moe] — 60L d_model=5120, MLA with 128 heads
(kv_lora_rank=512, q_lora_rank=1536, nope 128 / rope 64 / v 128),
MoE: 2 shared + 160 routed experts top-6, per-expert d_ff=1536,
vocab=102400.  [arXiv:2405.04434]

Adaptation notes (DESIGN.md): the published model's first layer is dense; we
model it through the always-on shared-expert branch (2 x 1536 = 3072) present
in every layer, keeping the layer stack uniform.
"""

from repro_torch.configs.base import ArchConfig, arch_registry


@arch_registry.register("deepseek-v2-236b")
def deepseek_v2_236b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b",
        family="moe",
        source="arXiv:2405.04434",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,        # MLA: every head has latent-derived K/V
        head_dim=128,
        d_ff=1536,
        vocab_size=102400,
        attn_type="mla",
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        num_experts=160,
        num_experts_per_tok=6,
        moe_d_ff=1536,
        shared_d_ff=3072,        # 2 shared experts
        rope_theta=10000.0,
        tie_embeddings=False,
        fsdp=True,
    )
