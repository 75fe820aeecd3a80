"""Architecture configs (port of :mod:`repro.configs`) — one module per
architecture, the reference's dims field for field.

Importing this package registers every arch in ``arch_registry``; select via
``get_arch("<id>")``.
"""

from repro_torch.configs.base import (
    ArchConfig,
    INPUT_SHAPES,
    InputShape,
    all_arch_names,
    arch_registry,
    get_arch,
)

# Register all assigned architectures (import side effects).
from repro_torch.configs import granite_moe_3b_a800m  # noqa: F401
from repro_torch.configs import phi3_medium_14b  # noqa: F401
from repro_torch.configs import qwen3_14b  # noqa: F401
from repro_torch.configs import rwkv6_3b  # noqa: F401
from repro_torch.configs import llama3_2_1b  # noqa: F401
from repro_torch.configs import internvl2_26b  # noqa: F401
from repro_torch.configs import deepseek_v2_236b  # noqa: F401
from repro_torch.configs import whisper_medium  # noqa: F401
from repro_torch.configs import starcoder2_3b  # noqa: F401
from repro_torch.configs import hymba_1_5b  # noqa: F401

__all__ = [
    "ArchConfig",
    "InputShape",
    "INPUT_SHAPES",
    "arch_registry",
    "get_arch",
    "all_arch_names",
]
