"""whisper-medium [audio] — encoder-decoder backbone: 24 enc + 24 dec layers,
d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.  [arXiv:2212.04356]

Per the assignment carve-out the mel-spectrogram + conv frontend is a STUB:
``input_specs`` provides precomputed frame embeddings (B, 1500, d_model).
Positions use a learned table (Whisper uses sinusoidal-enc/learned-dec; we
use learned for both — adaptation noted in DESIGN.md).  long_500k is SKIPPED
for this arch (enc-dec, 1500-frame encoder context — see DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig, arch_registry


@arch_registry.register("whisper-medium")
def whisper_medium() -> ArchConfig:
    return ArchConfig(
        name="whisper-medium",
        family="audio",
        source="arXiv:2212.04356",
        num_layers=24,           # decoder layers
        enc_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51865,
        kind="encdec",
        frontend="audio_stub",
        num_prefix=1500,         # encoder frames
        learned_pos=65536,
        rope_theta=0.0,          # no RoPE
        tie_embeddings=True,
    )
