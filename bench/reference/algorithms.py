"""The plain reference of the benchmark's cells: Algorithms 1-3 of Huang et
al. (NeurIPS 2022) and the downstream fits, written from the paper's
definitions in plain PyTorch, with no kernel, cache or batching.

Every function takes a :class:`Precision`.  ``FLOAT64`` is the reference
proper.  ``TF32`` is the control: the same steps in float32 with every
matrix product's operands rounded to TF32 (10 mantissa bits), the
precision a float32 program would fall to with TF32 switched on.

Semantics kept from the program's specification (not from its code):

* Algorithm 2: g_i^(j) = x_i^T (X^(j)T X^(j))^+ x_i, clipped to [0, 1],
  plus 1/n; party T scores [X^(T), y]; the pseudo-inverse drops
  eigenvalues at or below 1e-6 of the largest.
* Algorithm 3: local k-means (k-means++ D^2 seeding, then Lloyd) per
  party, then g_i = a d_i^2 / cost + a cost_B / (|B| cost) + 2 a / |B|.
* Algorithm 1 (DIS): G_j = sum_i g_i^(j); round 1 m draws of a party
  from log G_j; round 2 party j's first a_j draws of a row from
  log g^(j); weights G / (m sum_j g^(j)_S).  Draws are gumbel-max over
  the threefry words of :mod:`.threefry`, the key chain split as the
  paper's implementation splits it.
* Fits: weighted ridge (closed form), weighted k-means++ and Lloyd.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from . import threefry
from .threefry import Key

RCOND = 1e-6


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    dtype: torch.dtype
    tf32: bool

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return _round_tf32(a) @ _round_tf32(b)
        return a @ b


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even at TF32's 10 mantissa bits."""
    b = x.to(torch.float32).view(torch.int32).to(torch.int64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.to(torch.int32).view(torch.float32)


FLOAT64 = Precision("float64", torch.float64, False)
TF32 = Precision("tf32", torch.float32, True)


# --------------------------------------------------------------------------
# scores
# --------------------------------------------------------------------------

def vrlr_scores(parts: Sequence[torch.Tensor], y: torch.Tensor,
                p: Precision) -> torch.Tensor:
    """Algorithm 2's (T, n) party scores."""
    T, n = len(parts), parts[0].shape[0]
    out = []
    for j, X in enumerate(parts):
        B = p.cast(X)
        if j == T - 1:
            B = torch.cat([B, p.cast(y)[:, None]], dim=1)
        ev, V = torch.linalg.eigh(p.mm(B.T, B))
        keep = ev > RCOND * torch.clamp_min(ev.max(), 0.0)
        inv = torch.where(keep, 1.0 / torch.clamp_min(ev, 1e-30), torch.zeros_like(ev))
        M = p.mm(V * inv[None, :], V.T)
        lev = torch.sum(p.mm(B, M) * B, dim=1)
        out.append(torch.clamp(lev, 0.0, 1.0) + 1.0 / n)
    return torch.stack(out)


def sq_dist(X: torch.Tensor, C: torch.Tensor, p: Precision) -> torch.Tensor:
    """(n, k) squared distances: by the expansion in the control, exactly
    enough in float64."""
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    c2 = torch.sum(C * C, dim=1)[None, :]
    return torch.clamp_min(x2 - 2.0 * p.mm(X, C.T) + c2, 0.0)


def assign(X: torch.Tensor, C: torch.Tensor, p: Precision):
    """(nearest center, its squared distance); ties to the lower index."""
    d2, a = torch.min(sq_dist(X, C, p), dim=1)
    return a, d2


def pick(key: Key, logits: torch.Tensor, p: Precision) -> int:
    """One categorical draw (``shape=()``: a one-row draw)."""
    rows = torch.zeros((1,), dtype=torch.int64, device=logits.device)
    return int(threefry.draw(key, logits, 1, rows, p.dtype)[0])


def kmeans_pp(key: Key, X: torch.Tensor, k: int, w: Optional[torch.Tensor],
              p: Precision) -> torch.Tensor:
    """Weighted D^2 seeding: the first center from log w, each next one
    from log(w d^2) to the nearest center so far."""
    n = X.shape[0]
    ww = (torch.ones((n,), dtype=p.dtype, device=X.device) if w is None
          else torch.clamp_min(p.cast(w), 0.0))
    k0, key = threefry.split(key)
    C = torch.zeros((k, X.shape[1]), dtype=p.dtype, device=X.device)
    C[0] = X[pick(k0, torch.log(torch.clamp_min(ww, 1e-30)), p)]
    d2 = sq_dist(X, C[:1], p)[:, 0]
    if k > 1:
        for l, key_l in enumerate(threefry.split(key, k - 1), start=1):
            C[l] = X[pick(key_l, torch.log(torch.clamp_min(ww * d2, 1e-30)), p)]
            d2 = torch.minimum(d2, sq_dist(X, C[l:l + 1], p)[:, 0])
    return C


def lloyd(X: torch.Tensor, C: torch.Tensor, w: Optional[torch.Tensor],
          iters: int, p: Precision) -> torch.Tensor:
    """Weighted Lloyd; an empty cluster keeps its center."""
    k = C.shape[0]
    ww = torch.ones((X.shape[0],), dtype=p.dtype, device=X.device) if w is None else p.cast(w)
    for _ in range(iters):
        a, _ = assign(X, C, p)
        onehot = torch.nn.functional.one_hot(a, k).to(p.dtype)        # (n, k)
        csum = onehot.T @ (ww[:, None] * X)                            # plain sums
        wsum = onehot.T @ ww
        C = torch.where(wsum[:, None] > 0, csum / torch.clamp_min(wsum, 1e-30)[:, None], C)
    return C


def vkmc_scores(key: Key, parts: Sequence[torch.Tensor], k: int, alpha: float,
                iters: int, p: Precision) -> Tuple[torch.Tensor, Key]:
    """Algorithm 3's (T, n) party scores and the key left for DIS."""
    subs = []
    for _ in parts:
        key, sub = threefry.split(key)
        subs.append(sub)
    key, dis_key = threefry.split(key)
    out = []
    for sub, X in zip(subs, parts):
        Xp = p.cast(X)
        C = lloyd(Xp, kmeans_pp(sub, Xp, k, None, p), None, iters, p)
        a, d2 = assign(Xp, C, p)
        size = torch.clamp_min(torch.bincount(a, minlength=k).to(p.dtype), 1.0)
        ccost = torch.nn.functional.one_hot(a, k).to(p.dtype).T @ d2
        cost = torch.clamp_min(d2.sum(), 1e-30)
        s = size[a]
        out.append(alpha * d2 / cost + alpha * ccost[a] / (s * cost) + 2.0 * alpha / s)
    return torch.stack(out), dis_key


# --------------------------------------------------------------------------
# Algorithm 1
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Dis:
    """One DIS execution's reference state: its key chain, the (T, n)
    scores, the party totals, round 1's candidate values and counts."""

    subs: List[Key]
    scores: torch.Tensor
    totals: torch.Tensor
    round1: torch.Tensor          # (m, T) candidate values of round 1
    counts: torch.Tensor          # (T,) int64
    m: int
    cap: int
    p: Precision

    def row_values(self, party: int, rows: torch.Tensor) -> torch.Tensor:
        """Round 2's candidate values for ``rows`` of ``party``'s stream."""
        logits = torch.log(torch.clamp_min(self.scores[party], 1e-30))
        return threefry.row_values(self.subs[1 + party], logits, self.cap, rows,
                                   self.p.dtype)

    def draw_all(self, chunk: int = 32) -> torch.Tensor:
        """Every index of S, party-major (the control's whole draw)."""
        out = []
        for j, a in enumerate(self.counts.tolist()):
            rows = torch.arange(a, dtype=torch.int64, device=self.scores.device)
            logits = torch.log(torch.clamp_min(self.scores[j], 1e-30))
            out.append(threefry.draw(self.subs[1 + j], logits, self.cap, rows,
                                     self.p.dtype, chunk))
        return torch.cat(out)

    def weights(self, S: torch.Tensor) -> torch.Tensor:
        """w(i) = G / (m sum_j g_i^(j)) at the indices S."""
        g = torch.zeros((S.numel(),), dtype=self.p.dtype, device=S.device)
        for j in range(self.scores.shape[0]):
            g = g + self.scores[j][S]
        return self.totals.sum() / (self.m * torch.clamp_min(g, 1e-30))


def dis(key: Key, scores: torch.Tensor, m: int, cap: int, p: Precision) -> Dis:
    """Algorithm 1's round 1 (the counts) and what round 2 and the weights
    need; round 2 rows are drawn on demand (:meth:`Dis.row_values`)."""
    T = scores.shape[0]
    scores = p.cast(scores)
    subs = threefry.key_chain(key, T + 1)
    totals = scores.sum(dim=1)
    logits = torch.log(torch.clamp_min(totals, 1e-30))
    rows = torch.arange(m, dtype=torch.int64, device=scores.device)
    v = threefry.row_values(subs[0], logits, cap, rows, p.dtype)
    counts = torch.bincount(torch.argmax(v, dim=1), minlength=T)
    return Dis(subs, scores, totals, v, counts, m, cap, p)


def bill(T: int, m: int) -> int:
    """Theorem 2.5's DIS bill: 2T (round 1) + m (indices up) + mT
    (broadcast) + mT (scores up)."""
    return 2 * T + m + 2 * m * T


def fit_bill(T: int, m: int) -> int:
    """The fit's share: m indices down and m row shares up per party."""
    return 2 * m * T


# --------------------------------------------------------------------------
# fits
# --------------------------------------------------------------------------

def ridge(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, lam: float,
          p: Precision) -> Tuple[torch.Tensor, float]:
    """(theta, objective) of argmin sum w (x theta - y)^2 + lam |theta|^2."""
    X, y, w = p.cast(X), p.cast(y), p.cast(w)
    d = X.shape[1]
    G = p.mm((X * w[:, None]).T, X) + lam * torch.eye(d, dtype=p.dtype, device=X.device)
    theta = torch.linalg.solve(G, p.mm(X.T, (w * y)[:, None])[:, 0])
    r = p.mm(X, theta[:, None])[:, 0] - y
    return theta, float(torch.sum(w * r * r) + lam * torch.sum(theta * theta))


def kmeans_fit(key: Key, X: torch.Tensor, w: torch.Tensor, k: int, iters: int,
               p: Precision) -> Tuple[torch.Tensor, float]:
    """(centers, weighted objective): k-means++ under ``fold_in(key, 0)``
    (the first restart), then ``iters`` Lloyd steps."""
    X, w = p.cast(X), p.cast(w)
    C = lloyd(X, kmeans_pp(threefry.fold_in(key, 0), X, k, w, p), w, iters, p)
    _, d2 = assign(X, C, p)
    return C, float(torch.sum(w * d2))
