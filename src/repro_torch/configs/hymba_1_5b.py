"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504,
parallel attention + mamba heads in every layer, ssm_state=16,
vocab=32001.  [arXiv:2411.13676]

Adaptation (DESIGN.md): Hymba's meta-tokens and per-layer global/local
mix are simplified to sliding-window attention heads (window 1024, as most
Hymba layers use SWA) in parallel with a Mamba branch; outputs are
mean-fused after per-branch normalisation.
"""

from repro_torch.configs.base import ArchConfig, arch_registry


@arch_registry.register("hymba-1.5b")
def hymba_1_5b() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        source="arXiv:2411.13676",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        mixer="hymba",
        sliding_window=1024,
        ssm_state=16,
        mamba_d_inner=1600,
        rope_theta=10000.0,
        tie_embeddings=True,
    )
