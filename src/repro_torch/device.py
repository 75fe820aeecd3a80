"""Device resolution for the port's entry points.

The card is the default: an entry point asked for ``"cuda"`` without a
CUDA device raises instead of carrying on on the CPU.  The CPU runs only
when the caller passes ``device="cpu"`` (as the parity tests do), and
then every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    no CUDA device is present, and for any device type other than
    ``cuda`` or ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch finds no CUDA device; "
                "pass device='cpu' to run the plain PyTorch path on purpose"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
