"""Vertical-federated dataset model over torch tensors: one dataset,
feature columns split across T parties; labels (if any) live at party
T-1 (0-indexed; the paper's "party T").

Port of :mod:`repro.core.vfl`.  Every party's block lives on one device,
the one :meth:`VFLDataset.from_dense` was given.  The row-block view
(:meth:`VFLDataset.block`, :meth:`VFLDataset.blocks`) is the streamed
engine's substrate: a dataset held in host memory hands the card one
(T, bs, s) block at a time, staged through a pinned host buffer.
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


def block_geometry(n: int, block_size: int) -> Tuple[int, int]:
    """(num_blocks nb, rows-per-block bs) for a ``block_size`` row chunking
    of n rows — the geometry shared by :meth:`VFLDataset.block` and the
    hierarchical DIS sampler (``repro_torch.core.dis.blocked_geometry``
    delegates here).

    bs clamps to n, so ``block_size >= n`` is exactly one unpadded block;
    the last block is zero-padded up to bs.
    """
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    bs = min(int(block_size), int(n))
    return -(-int(n) // bs), bs


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
    CPU-resident parts are the host-resident substrate of the streamed
    engine: :meth:`block` assembles one (T, bs, s) block on the host and
    only that block goes to the card.  ``staged_bytes`` counts the bytes
    :meth:`block` has copied from the host to another device.
    """

    parts: List[torch.Tensor]           # party j's local block (n, d_j)
    y: Optional[torch.Tensor] = None    # (n,), stored at party T-1
    validate: bool = True               # NaN/Inf screen at construction
    staged_bytes: int = dataclasses.field(default=0, init=False, compare=False)
    # (shape, dtype, pinned) -> [host staging buffer, the event recorded
    # after the last copy out of it, or None]
    _staging: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False, compare=False)

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

    def _stacked_dtype(self) -> torch.dtype:
        return functools.reduce(torch.promote_types,
                                [p.dtype for p in self.parts])

    def stacked(self, with_labels: bool = False) -> StackedParts:
        """Padded (T, n, s) stacking of the party blocks for one batched
        scoring call.

        With ``with_labels=True`` party T's labels are appended as one extra
        column of its block (the [X^(T), y] basis of Algorithm 2).  Each
        party only ever touches its own slice, so the view is a layout
        change, not a protocol change.
        """
        widths, s = self.stacked_widths(with_labels)
        dtype = self._stacked_dtype()
        blocks = torch.zeros((self.T, self.n, s), dtype=dtype,
                             device=self.device)
        for j, p in enumerate(self.parts):
            blocks[j, :, :p.shape[1]] = p
        if with_labels:
            blocks[self.T - 1, :, self.dims[-1]] = self.y.to(dtype)
        # from the shapes alone: no host-to-device copy, so a CUDA graph
        # can capture the view
        cols = torch.arange(s, device=self.device)
        mask = torch.stack([cols < w for w in widths])
        return StackedParts(blocks, mask, widths)

    # -- chunked row-block view (the streamed engine's substrate) ----------

    def block_geometry(self, block_size: int) -> Tuple[int, int]:
        """:func:`block_geometry` of this dataset's n rows."""
        return block_geometry(self.n, block_size)

    def _fill_block(self, out: torch.Tensor, lo: int, hi: int,
                    with_labels: bool) -> None:
        """Write rows [lo, hi) of every party into ``out`` (T, bs, s) in
        :meth:`stacked`'s layout, and zero the rest of it: the padded
        columns of each party and the rows past ``hi - lo``."""
        nv = hi - lo
        for j, p in enumerate(self.parts):
            col = p.shape[1]
            out[j, :nv, :col] = p[lo:hi]
            if with_labels and j == self.T - 1:
                out[j, :nv, col] = self.y[lo:hi]
                col += 1
            out[j, :nv, col:] = 0
        out[:, nv:, :] = 0

    def _staging_buffer(self, shape, dtype: torch.dtype, pin: bool) -> list:
        """The host staging buffer for blocks of ``shape``, once the copy
        out of it that was last issued has finished."""
        entry = self._staging.get((shape, dtype, pin))
        if entry is None:
            entry = [torch.empty(shape, dtype=dtype, pin_memory=pin), None]
            self._staging[(shape, dtype, pin)] = entry
        elif entry[1] is not None:
            entry[1].synchronize()
            entry[1] = None
        return entry

    def block(self, b: int, block_size: int, with_labels: bool = False,
              device: Optional[DeviceLike] = None) -> Tuple[torch.Tensor, int]:
        """Padded (T, bs, s) stacked view of row block ``b`` on ``device``
        (default: the dataset's own) + its valid-row count.

        Rows [b*bs, b*bs + bs) of every party, laid out exactly as the
        matching slice of :meth:`stacked` (labels appended to party T,
        columns zero-padded to the common width); rows past n are zero.

        A dataset on the card is sliced there.  A dataset in host memory
        assembles the block on the host in a staging buffer (pinned when
        the target is CUDA; a CPU-only torch cannot pin), which is copied
        to ``device`` with ``non_blocking=True``; the buffer is written
        again only after an event shows that copy has finished, so one
        block's assembly overlaps the card's work on the one before.
        """
        _, s = self.stacked_widths(with_labels)
        nb, bs = self.block_geometry(block_size)
        if not 0 <= b < nb:
            raise IndexError(f"block {b} out of range [0, {nb})")
        lo = b * bs
        hi = min(lo + bs, self.n)
        dev = self.device if device is None else resolve_device(device)
        shape, dtype = (self.T, bs, s), self._stacked_dtype()
        if self.device.type != "cpu":
            out = torch.empty(shape, dtype=dtype, device=self.device)
            self._fill_block(out, lo, hi, with_labels)
            return out.to(dev), hi - lo
        entry = self._staging_buffer(shape, dtype, pin=dev.type == "cuda")
        buf = entry[0]
        self._fill_block(buf, lo, hi, with_labels)
        out = torch.empty(shape, dtype=dtype, device=dev)
        out.copy_(buf, non_blocking=True)
        if dev.type == "cuda":
            entry[1] = torch.cuda.Event()
            entry[1].record(torch.cuda.current_stream(dev))
        if dev != self.device:
            self.staged_bytes += buf.numel() * buf.element_size()
        return out, hi - lo

    def blocks(self, block_size: int, with_labels: bool = False,
               device: Optional[DeviceLike] = None):
        """Iterate ``(b, block (T, bs, s), nvalid)`` over the row chunking.
        The generator drops its own reference to a block before it stages
        the next, so a consumer that drops its own (``del blk``) keeps one
        block resident."""
        nb, _ = self.block_geometry(block_size)
        for b in range(nb):
            blk, nvalid = self.block(b, block_size, with_labels, device=device)
            yield b, blk, nvalid
            del blk

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


def standardize(ds: VFLDataset, eps: float = 1e-8) -> VFLDataset:
    """Per-feature mean-0 / std-1 normalisation, computed party-locally
    (no cross-party stats needed — matches the paper's preprocessing).
    The standard deviation is the population one (``correction=0``), as
    ``jnp.std`` computes it."""
    parts = []
    for p in ds.parts:
        mu = p.mean(dim=0, keepdim=True)
        sd = p.std(dim=0, keepdim=True, correction=0)
        parts.append((p - mu) / torch.clamp_min(sd, eps))
    return VFLDataset(parts, ds.y)


def as_numpy(ds: VFLDataset) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
    """The party blocks and labels as host numpy arrays."""
    return ([p.cpu().numpy() for p in ds.parts],
            None if ds.y is None else ds.y.cpu().numpy())
