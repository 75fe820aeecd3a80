"""Architecture + input-shape config system (port of
:mod:`repro.configs.base`).

Every architecture registers an :class:`ArchConfig` (exact published dims)
via ``@arch_registry.register``; ``reduced()`` derives the CPU smoke variant
of the same family (<=2 layers, d_model<=512, <=4 experts).  The configs
are plain data, field for field the reference's; ``param_dtype`` is a
``torch.dtype``.  The execution fields the port does not read yet
(``fsdp``, ``scan_unroll``, ``pure_fsdp``) are kept so that the two
packages' configs compare equal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.utils.registry import Registry

arch_registry = Registry("arch")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    source: str                    # citation for the dims
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # attention
    attn_type: str = "gqa"         # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 = full causal
    learned_pos: int = 0           # >0: learned position table of this size (whisper)

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0           # dense (shared-expert) branch alongside MoE

    # mixer selection
    mixer: str = "attention"       # attention | rwkv6 | hymba
    ssm_state: int = 0
    mamba_d_inner: int = 0

    # structure
    kind: str = "decoder"          # decoder | encdec
    enc_layers: int = 0
    frontend: str = "none"         # none | audio_stub | vision_stub
    num_prefix: int = 0            # precomputed frame/patch embeddings
    tie_embeddings: bool = True

    # numerics / execution
    param_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    fsdp: bool = False             # shard stacked-layer params over `data`
    attn_chunk: int = 1024
    ssm_chunk: int = 32
    capacity_factor: float = 1.25
    scan_unroll: bool = False      # unroll the layer scan (dry-run cost fidelity)
    moe_dispatch: str = "kloop"    # kloop (paper-faithful GSPMD baseline) | einsum (§Perf)
    moe_group: int = 256           # MoE dispatch group size Sg
    pure_fsdp: bool = False        # weight-gathered parallelism: no TP on layer
    #                                weights (embed/unembed stay vocab-TP) —
    #                                wins for non-16-divisible head geometries

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.mixer in ("rwkv6",) and self.attn_type != "none":
            object.__setattr__(self, "attn_type", "none")

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def vocab_pad(self) -> int:
        """Embedding-table rows: vocab padded to a multiple of 256 so the
        vocab axis shards evenly (Megatron-style). Logical vocab stays
        ``vocab_size``; padded logit columns are masked to -inf."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def dec_layers(self) -> int:
        return self.num_layers

    def supports_long_context(self) -> bool:
        """True if decode with a 524k context is sub-quadratic/O(window)."""
        if self.mixer in ("rwkv6", "hymba"):
            return True
        return self.kind == "decoder"   # dense decoders get the sliding-window variant

    def for_shape(self, shape: "InputShape") -> "ArchConfig":
        """Shape-conditioned variant: long-context decode on attention archs
        switches to the sliding-window cache (sub-quadratic requirement)."""
        if shape.name == "long_500k" and self.attn_type in ("gqa", "mla") and self.mixer == "attention":
            return dataclasses.replace(self, sliding_window=8192)
        return self

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/code paths, toy dims."""
        small_heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, small_heads)
        d = min(self.d_model, 256)
        hd = max(d // small_heads, 16)
        return dataclasses.replace(
            self,
            num_layers=2,
            enc_layers=min(self.enc_layers, 2),
            d_model=d,
            num_heads=small_heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            shared_d_ff=min(self.shared_d_ff, 128) if self.shared_d_ff else 0,
            kv_lora_rank=min(self.kv_lora_rank, 64) if self.kv_lora_rank else 0,
            q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
            qk_nope_dim=32 if self.attn_type == "mla" else self.qk_nope_dim,
            qk_rope_dim=16 if self.attn_type == "mla" else self.qk_rope_dim,
            v_head_dim=32 if self.attn_type == "mla" else self.v_head_dim,
            mamba_d_inner=min(self.mamba_d_inner, 256) if self.mamba_d_inner else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            num_prefix=min(self.num_prefix, 8) if self.num_prefix else 0,
            learned_pos=min(self.learned_pos, 4096) if self.learned_pos else 0,
            param_dtype=torch.float32,
            remat=False,
            fsdp=False,
            attn_chunk=8,
            ssm_chunk=4,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    phase: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.phase == "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def get_arch(name: str) -> ArchConfig:
    return arch_registry.get(name)()


def all_arch_names():
    return list(arch_registry.keys())
