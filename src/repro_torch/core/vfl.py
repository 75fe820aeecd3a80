"""Vertical-federated dataset model over torch tensors: one dataset,
feature columns split across T parties; labels (if any) live at party
T-1 (0-indexed; the paper's "party T").

Port of :mod:`repro.core.vfl`.  Every party's block lives on one device,
the one :meth:`VFLDataset.from_dense` was given.  The row-block views are
the streaming engines' substrate: a dataset held in host memory hands the
card (T, bs, s) blocks through pinned host buffers, one block
(:meth:`VFLDataset.block`, :meth:`VFLDataset.blocks`), a group of blocks
(:meth:`VFLDataset.gather_blocks`, the redraw's) or a superchunk of C
consecutive blocks (:meth:`VFLDataset.blocks_prefetched`, the passes',
double-buffered through two pinned slots and copied on a side CUDA
stream) at a time.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

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
    CPU-resident parts are the host-resident substrate of the streaming
    engines: the block views assemble (T, bs, s) blocks on the host and
    only those go to the card.  ``staged_bytes`` counts the bytes the block
    views have copied from the host to the card.
    """

    parts: List[torch.Tensor]           # party j's local block (n, d_j)
    y: Optional[torch.Tensor] = None    # (n,), stored at party T-1
    validate: bool = True               # NaN/Inf screen at construction
    staged_bytes: int = dataclasses.field(default=0, init=False, compare=False)
    # (shape, dtype, pinned, slot) -> [host staging buffer, the event
    # recorded after the last copy out of it, or None]
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

    def _staging_buffer(self, shape, dtype: torch.dtype, pin: bool,
                        slot: int = 0) -> list:
        """Host staging buffer ``slot`` for blocks of ``shape``, once the
        copy out of it that was last issued has finished."""
        entry = self._staging.get((shape, dtype, pin, slot))
        if entry is None:
            entry = [torch.empty(shape, dtype=dtype, pin_memory=pin), None]
            self._staging[(shape, dtype, pin, slot)] = entry
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
        Staged as :meth:`gather_blocks` stages a group of one.
        """
        batch, nvalids = self.gather_blocks([b], block_size, with_labels, device)
        return batch[0], int(nvalids[0])

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

    # -- superchunk view (the pipelined engine's substrate) -----------------

    def _fill_superchunk(self, out: torch.Tensor, b0: int, bs: int,
                         with_labels: bool) -> np.ndarray:
        """Write blocks b0, b0 + 1, ... (each of them below nb) into ``out``
        (count, T, bs, s), block i exactly as :meth:`block` gives block
        b0 + i (rows past n and the padded columns zero), with one slice of
        each party for the whole range.  Returns the (count,) valid-row
        counts."""
        count = out.shape[0]
        lo = b0 * bs
        hi = min(lo + count * bs, self.n)
        full, rem = divmod(hi - lo, bs)
        for j, p in enumerate(self.parts):
            segs = [p[lo:hi]]
            if with_labels and j == self.T - 1:
                segs.append(self.y[lo:hi, None])
            col = 0
            for seg in segs:
                w = seg.shape[1]
                out[:full, j, :, col:col + w] = seg[:full * bs].reshape(full, bs, w)
                if rem:
                    out[full, j, :rem, col:col + w] = seg[full * bs:]
                col += w
            out[:, j, :, col:] = 0
        if rem:
            out[full, :, rem:, :] = 0
        return np.clip(self.n - (b0 + np.arange(count)) * bs, 0, bs)

    def blocks_prefetched(
        self, block_size: int, with_labels: bool = False,
        chunk_blocks: int = 1, prefetch: bool = True,
        device: Optional[DeviceLike] = None, start_chunk: int = 0,
    ) -> Iterator[Tuple[int, torch.Tensor, np.ndarray]]:
        """Iterate ``(b0, chunk (count, T, bs, s), nvalids (count,))`` over
        superchunks of ``chunk_blocks`` row blocks on ``device`` (default:
        the dataset's own).  ``chunk[i]`` is :meth:`block` ``(b0 + i)`` value
        for value; the last superchunk holds only the blocks that exist
        (count = nb - b0 there), so the pass stages the bytes
        :meth:`blocks` stages.

        A dataset on ``device`` is sliced in place.  A host dataset bound for
        the card assembles each superchunk in a pinned host slot (one slice
        per party) and copies it with ``non_blocking=True`` on a side
        stream; the consumer's stream waits on the event recorded after that
        copy before the chunk is handed over, and a slot is rewritten only
        after the event of its last copy.  The device buffer is allocated on
        the consumer's stream and the side stream waits for the consumer's
        work queued before the copy, so the caching allocator never hands a
        buffer to a copy while kernels still read it.

        With ``prefetch`` two slots alternate and superchunk c + 1 is staged
        and its copy issued before c is yielded, so the copy and the next
        assembly overlap the consumer's kernels on c.  Without it one slot is
        used and c + 1 is staged only after c was consumed.  The generator
        drops its reference to a chunk before it stages the next but one: a
        consumer that drops its own (``del chunk``) keeps at most two
        superchunks resident.

        ``start_chunk`` skips the first superchunks entirely, neither
        filled nor staged (``staged_bytes`` counts only what is copied):
        the checkpointed resume, which continues a scan at its first
        unprocessed superchunk and sees the chunks a full traversal yields
        from there.  The prefetch slots alternate from the first staged
        superchunk."""
        _, s = self.stacked_widths(with_labels)
        nb, bs = self.block_geometry(block_size)
        if chunk_blocks < 1:
            raise ValueError(f"chunk_blocks must be >= 1, got {chunk_blocks}")
        C = int(chunk_blocks)
        nchunks = -(-nb // C)
        if not 0 <= start_chunk <= nchunks:
            raise ValueError(
                f"start_chunk {start_chunk} out of range [0, {nchunks}]"
            )
        dev = self.device if device is None else resolve_device(device)
        dtype = self._stacked_dtype()
        starts = range(start_chunk * C, nb, C)
        if self.device.type != "cpu" or dev.type != "cuda":
            for b0 in starts:
                out = torch.empty((min(C, nb - b0), self.T, bs, s), dtype=dtype,
                                  device=self.device)
                nvalids = self._fill_superchunk(out, b0, bs, with_labels)
                yield b0, out.to(dev), nvalids
                del out
            return
        consumer = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        shape = (C, self.T, bs, s)

        def stage(i: int, b0: int):
            entry = self._staging_buffer(shape, dtype, True,
                                         i % 2 if prefetch else 0)
            host = entry[0][:min(C, nb - b0)]
            nvalids = self._fill_superchunk(host, b0, bs, with_labels)
            out = torch.empty(host.shape, dtype=dtype, device=dev)
            side.wait_stream(consumer)
            with torch.cuda.stream(side):
                out.copy_(host, non_blocking=True)
            entry[1] = torch.cuda.Event()
            entry[1].record(side)
            self.staged_bytes += host.numel() * host.element_size()
            return out, nvalids, entry[1]

        pending = None
        try:
            for i, b0 in enumerate(starts):
                cur = pending if pending is not None else stage(i, b0)
                pending = None
                if prefetch and b0 + C < nb:
                    pending = stage(i + 1, b0 + C)
                consumer.wait_event(cur[2])
                yield b0, cur[0], cur[1]
                del cur
        finally:
            if pending is not None:
                # a consumer that stopped early: its in-flight copy must end
                # before the buffer it writes goes back to the allocator
                consumer.wait_event(pending[2])

    def gather_blocks(
        self, block_ids: Sequence[int], block_size: int,
        with_labels: bool = False, device: Optional[DeviceLike] = None,
    ) -> Tuple[torch.Tensor, np.ndarray]:
        """One (len(ids), T, bs, s) batch of arbitrary row blocks on
        ``device`` (default: the dataset's own), block i :meth:`block`
        ``(ids[i])``, plus their valid-row counts: the gather behind the
        redraw.  A dataset on the card is sliced there.  A dataset in host
        memory assembles the batch on the host in a staging buffer (pinned
        when the target is CUDA), copied to ``device`` with
        ``non_blocking=True``; the buffer is written again only after an
        event shows that copy has finished, so one batch's assembly
        overlaps the card's work on the one before."""
        _, s = self.stacked_widths(with_labels)
        nb, bs = self.block_geometry(block_size)
        ids = [int(b) for b in block_ids]
        for b in ids:
            if not 0 <= b < nb:
                raise IndexError(f"block {b} out of range [0, {nb})")
        dev = self.device if device is None else resolve_device(device)
        shape, dtype = (len(ids), self.T, bs, s), self._stacked_dtype()
        on_host = self.device.type == "cpu" and dev.type == "cuda"
        if on_host:
            entry = self._staging_buffer(shape, dtype, pin=True)
            buf = entry[0]
        else:
            buf = torch.empty(shape, dtype=dtype, device=self.device)
        nvalids = np.zeros((len(ids),), np.int64)
        for i, b in enumerate(ids):
            nvalids[i:i + 1] = self._fill_superchunk(buf[i:i + 1], b, bs,
                                                     with_labels)
        if not on_host:
            return buf.to(dev), nvalids
        out = torch.empty(shape, dtype=dtype, device=dev)
        out.copy_(buf, non_blocking=True)
        entry[1] = torch.cuda.Event()
        entry[1].record(torch.cuda.current_stream(dev))
        self.staged_bytes += buf.numel() * buf.element_size()
        return out, nvalids

    def rows(self, idx: torch.Tensor) -> "VFLDataset":
        y = None if self.y is None else self.y[idx]
        return VFLDataset([p[idx] for p in self.parts], y)

    def select_parties(self, parties: Sequence[int]) -> "VFLDataset":
        """The SAME rows restricted to a party subset — the surviving
        federation of a degraded build (:mod:`repro_torch.core.faults`).
        Labels survive only if the label holder (party T-1) is among
        ``parties``; order follows ``parties`` (keep it sorted to preserve
        the paper's party numbering).  The blocks are the same tensors, so
        the subset stays on this dataset's device: in host memory for a
        host-resident dataset, on the card for one there; they were
        screened (or not) when this dataset was built."""
        ids = [int(j) for j in parties]
        if not ids:
            raise ValueError("select_parties needs at least one party")
        bad = [j for j in ids if not 0 <= j < self.T]
        if bad:
            raise ValueError(f"parties {bad} out of range [0, {self.T})")
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate parties in {ids}")
        y = self.y if (self.T - 1) in ids else None
        return VFLDataset([self.parts[j] for j in ids], y, validate=False)

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
