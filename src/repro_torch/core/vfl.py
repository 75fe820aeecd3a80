"""Vertical-federated dataset model over torch tensors: one dataset,
feature columns split across T parties; labels (if any) live at party
T-1 (0-indexed; the paper's "party T").

Port of :mod:`repro.core.vfl` for the materialized engine.  Every block
lives on one device, the one :meth:`VFLDataset.from_dense` was given.
The row-block views of the streaming engines wait for that slice.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class StackedParts(NamedTuple):
    """Padded party-major view of a :class:`VFLDataset`.

    ``blocks`` is (T, n, s) with party j's block left-aligned and
    zero-padded to the common width s = max_j d_j (+1 when labels are
    stacked in); ``mask`` is (T, s) bool marking the valid columns.  Zero
    padding is score-transparent: Grams, row norms and quadratic forms
    over the padded axis equal their unpadded values, so one batched call
    scores every party.
    """

    blocks: torch.Tensor           # (T, n, s) float
    mask: torch.Tensor             # (T, s) bool
    dims: Tuple[int, ...]          # valid width per party (incl. label col)

    @property
    def T(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def n(self) -> int:
        return int(self.blocks.shape[1])


def split_columns(d: int, T: int, sizes: Optional[Sequence[int]] = None) -> List[slice]:
    """Column slices for T parties. ``sizes`` overrides the near-even split."""
    if sizes is None:
        base, rem = divmod(d, T)
        sizes = [base + (1 if j < rem else 0) for j in range(T)]
    if len(sizes) != T or sum(sizes) != d:
        raise ValueError(f"bad sizes {sizes} for d={d}, T={T}")
    out, start = [], 0
    for s in sizes:
        out.append(slice(start, start + s))
        start += s
    return out


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    """A float32 tensor on ``device`` (float64 input is narrowed, as the
    reference's jnp arrays are without x64)."""
    t = a if torch.is_tensor(a) else torch.as_tensor(np.array(a))
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(device)


@dataclasses.dataclass
class VFLDataset:
    """X (n, d) vertically partitioned; y optional, held by the last party.

    ``parts`` are tensors on one device; ``y`` lives on the same device.
    """

    parts: List[torch.Tensor]           # party j's local block (n, d_j)
    y: Optional[torch.Tensor] = None    # (n,), stored at party T-1
    validate: bool = True               # NaN/Inf screen at construction

    def __post_init__(self) -> None:
        if not self.parts:
            raise ValueError(
                "VFLDataset needs at least one party (parts is empty)"
            )
        n = self.parts[0].shape[0]
        if n == 0:
            raise ValueError(
                "VFLDataset needs at least one row (n=0); every protocol "
                "downstream scores and samples rows"
            )
        dev = self.parts[0].device
        for j, p in enumerate(self.parts):
            if p.ndim != 2 or p.shape[0] != n:
                raise ValueError(f"party {j}: bad shape {tuple(p.shape)}")
            if p.device != dev:
                raise ValueError(
                    f"party {j} lives on {p.device}, party 0 on {dev}; "
                    f"every block must share one device"
                )
        if self.y is not None:
            if self.y.shape[0] != n:
                raise ValueError("label length mismatch")
            if self.y.device != dev:
                raise ValueError(
                    f"labels live on {self.y.device}, the parties on {dev}")
        if self.validate:
            self._validate_values()

    def _validate_values(self) -> None:
        """NaN/Inf screen: a single non-finite cell poisons every Gram it
        touches downstream, so fail loudly at ingest and name the
        offender.  ``validate=False`` skips it when non-finite values are
        intentional."""
        named = [(f"party {j}", p) for j, p in enumerate(self.parts)]
        if self.y is not None:
            named.append((f"labels (party {self.T - 1})", self.y))
        for name, a in named:
            if not a.is_floating_point():
                continue
            finite = torch.isfinite(a)
            if bool(finite.all()):
                continue
            loc = torch.nonzero(~finite)[0].tolist()
            where = (f"row {loc[0]}, column {loc[1]}" if len(loc) == 2
                     else f"row {loc[0]}")
            bad = float(a[tuple(loc)])
            kind = "NaN" if np.isnan(bad) else "Inf"
            raise ValueError(
                f"non-finite value ({kind}) in {name} at {where}; "
                f"clean the feed or construct with validate=False to "
                f"bypass the ingest screen"
            )

    @property
    def n(self) -> int:
        return int(self.parts[0].shape[0])

    @property
    def T(self) -> int:
        return len(self.parts)

    @property
    def d(self) -> int:
        return int(sum(p.shape[1] for p in self.parts))

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple(int(p.shape[1]) for p in self.parts)

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def full(self) -> torch.Tensor:
        """Server-side concatenation — ONLY for evaluation/tests, never used
        inside communication-accounted protocols."""
        return torch.cat(self.parts, dim=1)

    def stacked_widths(self, with_labels: bool = False) -> Tuple[Tuple[int, ...], int]:
        """(per-party valid widths, common padded width s) of the stacked
        view."""
        if with_labels and self.y is None:
            raise ValueError("with_labels requires labels at party T")
        widths = list(self.dims)
        if with_labels:
            widths[-1] += 1
        return tuple(widths), max(widths)

    def stacked(self, with_labels: bool = False) -> StackedParts:
        """Padded (T, n, s) stacking of the party blocks for one batched
        scoring call.

        With ``with_labels=True`` party T's labels are appended as one extra
        column of its block (the [X^(T), y] basis of Algorithm 2).  Each
        party only ever touches its own slice, so the view is a layout
        change, not a protocol change.
        """
        widths, s = self.stacked_widths(with_labels)
        dtype = functools.reduce(torch.promote_types,
                                 [p.dtype for p in self.parts])
        blocks = torch.zeros((self.T, self.n, s), dtype=dtype,
                             device=self.device)
        for j, p in enumerate(self.parts):
            blocks[j, :, :p.shape[1]] = p
        if with_labels:
            blocks[self.T - 1, :, self.dims[-1]] = self.y.to(dtype)
        mask = torch.arange(s, device=self.device)[None, :] < torch.tensor(
            widths, device=self.device)[:, None]
        return StackedParts(blocks, mask, widths)

    def rows(self, idx: torch.Tensor) -> "VFLDataset":
        y = None if self.y is None else self.y[idx]
        return VFLDataset([p[idx] for p in self.parts], y)

    @staticmethod
    def from_dense(X, y=None, T: int = 3, sizes: Optional[Sequence[int]] = None,
                   device: DeviceLike = "cuda") -> "VFLDataset":
        """Split dense ``X`` (numpy or tensor) into T column blocks on
        ``device`` — the card unless the caller asks for the CPU."""
        dev = resolve_device(device)
        Xt = _as_tensor(X, dev)
        slices = split_columns(Xt.shape[1], T, sizes)
        return VFLDataset([Xt[:, s].contiguous() for s in slices],
                          None if y is None else _as_tensor(y, dev))
