"""Token pipeline for the LM side (port of :mod:`repro.data.lm`): a
synthetic Zipf-Markov corpus with enough structure that per-example
losses and leverage scores differ (so coreset batch selection has signal).

The corpus is generated with numpy exactly as the reference generates it,
so the same seed gives the same tokens; batches come out as int32 tensors
on the stream's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import rng
from repro_torch.device import DeviceLike, resolve_device


def lm_batch(key: rng.Key, batch: int, seq: int, vocab: int,
             device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """One (tokens, labels) batch from the synthetic corpus distribution;
    the stream's seed is ``randint(key, (), 0, 2**31 - 1)``, the
    reference's draw bit for bit."""
    seed = int(rng.randint(key, (), 0, 2 ** 31 - 1))
    stream = TokenStream(vocab=vocab, seq_len=seq, batch_size=batch, seed=seed,
                         device=device)
    return next(iter(stream))


@dataclasses.dataclass
class TokenStream:
    """Zipf unigram + order-1 Markov 'grammar' + per-sequence difficulty tiers.

    A third of sequences are near-deterministic (low loss), a third mixed,
    a third high-entropy — mirroring real-corpus heterogeneity; this is what
    makes importance-weighted batch selection measurably better than uniform.
    """

    vocab: int
    seq_len: int
    batch_size: int
    seed: int = 0
    device: DeviceLike = "cuda"

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        rng_ = np.random.default_rng(self.seed)
        v = self.vocab
        ranks = np.arange(1, v + 1)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # sparse deterministic successor table for the "grammar"
        self._succ = rng_.integers(0, v, size=v)
        self._rng = rng_

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, torch.Tensor]:
        rng_ = self._rng
        B, S, v = self.batch_size, self.seq_len, self.vocab
        tier = rng_.integers(0, 3, size=B)                  # 0 easy, 2 hard
        p_grammar = np.array([0.95, 0.6, 0.1])[tier]        # (B,)
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng_.choice(v, size=B, p=self._unigram)
        for t in range(1, S + 1):
            use_g = rng_.random(B) < p_grammar
            rand = rng_.choice(v, size=B, p=self._unigram)
            toks[:, t] = np.where(use_g, self._succ[toks[:, t - 1]], rand)
        toks = torch.from_numpy(toks).to(self.device)
        return {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
