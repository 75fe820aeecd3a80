"""Checkpointed resume of the streaming engines: the port's
``StreamCheckpoint``, the scorers' checkpointed passes,
``VFLDataset.blocks_prefetched(start_chunk=)`` and
``CoresetPipeline.build(checkpoint=)``, on the CPU at n <= 1,100 and
block 128, against the port's own uninterrupted builds and against the
reference from the same numpy data and keys.

Tolerances:

- Bit for bit, within the port: every build crashed at a probe and rerun
  with its checkpoint against the uninterrupted build (indices, weights,
  bill), at every probe of a pipelined build and at the reference's crash
  point on both streaming engines; restored carries against saved ones;
  superchunks from ``start_chunk`` against a full traversal's.
- Against the reference: its refusals word for word; a resumed build
  against the reference's uninterrupted one, indices and bill exact,
  weights ``rtol=1e-5`` (the reference's streamed and pipelined engines
  are not bitwise equal on this toolchain, ROADMAP.md queue 3 B.2).

The host-to-card branch of ``start_chunk`` (pinned slots, the side
stream) and ``h2d_bytes`` of a resumed build are held by
``chip_smoke.py`` phase 12 on the card.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import CoresetPipeline as JPipeline
from repro.core import CoresetSpec as JSpec
from repro.core import StreamCheckpoint as JCheckpoint
from repro.core import VFLDataset as JDataset
from repro_torch.convert import dataset_from_numpy, key_from_numpy
from repro_torch.core import CommLedger, CoresetPipeline, CoresetSpec, StreamCheckpoint

BLOCK = 128


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers at once; torch's own thread pool on
    top of them oversubscribes the cores, so these tests use one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def nonpartitionable():
    with jax.threefry_partitionable(False):
        yield


def _np_ds(seed=0, n=600, dims=(3, 2, 2), labels=True):
    """``tests/test_faults.py``'s ``_ds`` as numpy parts and labels."""
    rng = np.random.default_rng(seed)
    parts = [rng.normal(size=(n, d)).astype(np.float32) for d in dims]
    y = None
    if labels:
        theta = np.linspace(1.0, -1.0, dims[0]).astype(np.float32)
        y = parts[0] @ theta + 0.1 * rng.normal(size=n).astype(np.float32)
    return parts, y


def _both(labels=True, **kw):
    parts, y = _np_ds(labels=labels, **kw)
    return JDataset(parts, y), dataset_from_numpy(parts, y, "cpu")


def _keys(seed):
    kj = jax.random.PRNGKey(seed)
    return kj, key_from_numpy(np.asarray(kj), "cpu")


def _spec_kw(engine="pipelined", task="vrlr", m=32, **kw):
    """``tests/test_faults.py``'s ``_spec``."""
    params = {"k": 3} if task == "vkmc" else {}
    params.update(kw.pop("params", {}))
    return dict(task=task, budgets=m, engine=engine, backend="ref", params=params,
                block_size=BLOCK, **kw)


def _build(ds, key, **kw):
    ckw = {k: kw.pop(k) for k in ("checkpoint", "probe", "ledger") if k in kw}
    return CoresetPipeline(ds).build(CoresetSpec(**_spec_kw(**kw)), key=key,
                                     device="cpu", **ckw)


def _same(a, b) -> bool:
    return (torch.equal(a.indices, b.indices) and torch.equal(a.weights, b.weights)
            and (a.comm_units, a.comm_bits) == (b.comm_units, b.comm_bits))


class _Bomb:
    """A probe that raises at its ``at``-th call."""

    def __init__(self, at):
        self.at, self.calls = at, 0

    def __call__(self):
        self.calls += 1
        if self.calls == self.at:
            raise RuntimeError("killed mid-scan")


class _Count:
    def __init__(self):
        self.calls = 0

    def __call__(self):
        self.calls += 1


# --------------------------------------------------------------------------
# tests/test_faults.py's checkpoint tests, restated on the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["streamed", "pipelined"])
@pytest.mark.parametrize("task", ["vrlr", "vkmc"])
def test_checkpoint_resume_draw_identical(engine, task):
    _, ds = _both(n=700, labels=task == "vrlr")
    _, key = _keys(4)
    kw = dict(engine=engine, task=task, chunk_blocks=2)
    cs0 = _build(ds, key, **kw)
    ck = StreamCheckpoint()
    with pytest.raises(RuntimeError, match="killed mid-scan"):
        _build(ds, key, checkpoint=ck, probe=_Bomb(at=2), **kw)
    assert ck.saves > 0              # the crashed pass left resumable state behind
    cs1 = _build(ds, key, checkpoint=ck, **kw)
    assert ck.resumes > 0
    assert _same(cs1, cs0)
    assert ck.signature is None      # a completed build clears its state


def test_checkpoint_signature_mismatch_discards_stale_state():
    _, ds = _both(n=700)
    ck = StreamCheckpoint()
    _, key4 = _keys(4)
    with pytest.raises(RuntimeError):
        _build(ds, key4, checkpoint=ck, probe=_Bomb(at=2), chunk_blocks=2)
    # resuming under a different key must not reuse key 4's accumulators
    _, other = _keys(8)
    cs = _build(ds, other, checkpoint=ck, chunk_blocks=2)
    assert ck.resumes == 0
    assert _same(cs, _build(ds, other, chunk_blocks=2))


def test_checkpoint_refusals_word_for_word():
    """Batched, materialized and jit builds refuse a checkpoint with the
    reference's words."""
    jds, ds = _both()
    kj, kt = _keys(0)
    for spec_kw in (dict(budgets=(16,), engine="batched"), dict(engine="materialized"),
                    dict(engine="materialized", jit=True)):
        kw = dict(task="vrlr", backend="ref", **{"budgets": 16, **spec_kw})
        with pytest.raises(ValueError) as te:
            CoresetPipeline(ds).build(CoresetSpec(**kw), key=kt, device="cpu",
                                      checkpoint=StreamCheckpoint())
        with pytest.raises(ValueError) as je:
            JPipeline(jds).build(JSpec(**kw), key=kj, checkpoint=JCheckpoint())
        assert str(te.value) == str(je.value)
        assert "checkpointed resume" in str(te.value)


# --------------------------------------------------------------------------
# every crash point of a pipelined build
# --------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["vrlr", "vkmc"])
def test_resume_from_every_probe_is_bit_for_bit(task):
    """Crashed at each probe in turn (the passes, ``vkmc``'s centers, the
    redraw groups) and rerun, the build is the uninterrupted one; a rerun
    after both passes completed runs neither again."""
    _, ds = _both(n=700, labels=task == "vrlr")
    _, key = _keys(6)
    kw = dict(task=task, chunk_blocks=2, prefetch=True)
    count = _Count()
    cs0 = _build(ds, key, probe=count, **kw)
    passes = (1 if task == "vkmc" else 0) + 2 * 3         # centers, two passes of 3
    assert count.calls > passes
    for at in range(1, count.calls + 1):
        ck = StreamCheckpoint()
        with pytest.raises(RuntimeError, match="killed mid-scan"):
            _build(ds, key, checkpoint=ck, probe=_Bomb(at), **kw)
        after = _Count()
        led = CommLedger()
        cs = _build(ds, key, checkpoint=ck, probe=after, ledger=led, **kw)
        assert _same(cs, cs0), at
        assert led.total == cs0.comm_units and ck.signature is None
        if at >= passes:              # both passes were saved complete
            assert after.calls == count.calls - passes + (task == "vkmc")


# --------------------------------------------------------------------------
# StreamCheckpoint and start_chunk
# --------------------------------------------------------------------------

def test_checkpoint_saves_host_copies_and_restores_bits():
    ck = StreamCheckpoint()
    ck.bind(("sig", 1))
    G = torch.randn(3, 4, 4, dtype=torch.float32) * 1e-7
    pair = (torch.arange(6, dtype=torch.float32).view(2, 3), torch.full((3,), 0.1))
    ck.save("gram", 2, G)
    ck.save("stats", 5, pair)
    want = G.clone()
    G.add_(1.0)                          # the saved state is a copy
    assert "gram" in ck and "mass" not in ck and ck.saves == 2
    assert ck.load("mass", "cpu") is None and ck.resumes == 0
    done, got = ck.load("gram", "cpu")
    assert done == 2 and got.dtype == torch.float32 and torch.equal(got, want)
    done, (a, b) = ck.load("stats", "cpu")
    assert done == 5 and torch.equal(a, pair[0]) and torch.equal(b, pair[1])
    assert ck.resumes == 2
    ck.bind(("sig", 1))                  # the same signature keeps the state
    assert "gram" in ck
    ck.bind(("sig", 2))                  # a new one discards it
    assert "gram" not in ck and ck.signature == ("sig", 2)
    ck.save("mass", 1, (torch.ones(3, 2),))
    ck.clear()
    assert ck.signature is None and "mass" not in ck


@pytest.mark.parametrize("with_labels", [True, False])
@pytest.mark.parametrize("chunk_blocks,prefetch", [(2, True), (3, False), (1, False),
                                                   (6, True)])
def test_blocks_prefetched_start_chunk(chunk_blocks, prefetch, with_labels):
    """From ``start_chunk`` the superchunks are a full traversal's from
    there, the reference's too; past the end nothing is yielded; out of
    range raises the reference's error."""
    jds, ds = _both(n=700)
    full = list(ds.blocks_prefetched(BLOCK, with_labels, chunk_blocks, prefetch))
    nchunks = len(full)
    for start in range(nchunks + 1):
        got = list(ds.blocks_prefetched(BLOCK, with_labels, chunk_blocks, prefetch,
                                        start_chunk=start))
        want = list(jds.blocks_prefetched(BLOCK, with_labels, chunk_blocks, prefetch,
                                          start_chunk=start))
        assert [b0 for b0, _, _ in got] == [b0 for b0, _, _ in full[start:]] == [
            b0 for b0, _, _ in want]
        for (_, c, nv), (_, fc, fnv), (_, jc, jnv) in zip(got, full[start:], want):
            assert torch.equal(c, fc) and np.array_equal(nv, fnv)
            np.testing.assert_array_equal(c.numpy(), np.asarray(jc)[:c.shape[0]])
    assert ds.staged_bytes == 0                      # nothing left the host
    for bad in (-1, nchunks + 1):
        with pytest.raises(ValueError) as te:
            list(ds.blocks_prefetched(BLOCK, with_labels, chunk_blocks, prefetch,
                                      start_chunk=bad))
        with pytest.raises(ValueError) as je:
            list(jds.blocks_prefetched(BLOCK, with_labels, chunk_blocks, prefetch,
                                       start_chunk=bad))
        assert str(te.value) == str(je.value)


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["vrlr", "vkmc"])
def test_resumed_build_matches_reference_uninterrupted(task):
    """The port crashed inside its mass pass and resumed, against the
    reference's uninterrupted pipelined build: indices and bill exact,
    weights ``rtol=1e-5``."""
    jds, ds = _both(n=1100, labels=task == "vrlr", seed=3)
    kj, kt = _keys(11)
    kw = _spec_kw(task=task, m=64, chunk_blocks=3, prefetch=True)
    ck = StreamCheckpoint()
    at = (1 if task == "vkmc" else 0) + 3 + 2           # the mass pass's 2nd superchunk
    with pytest.raises(RuntimeError, match="killed mid-scan"):
        CoresetPipeline(ds).build(CoresetSpec(**kw), key=kt, device="cpu",
                                  checkpoint=ck, probe=_Bomb(at))
    cs = CoresetPipeline(ds).build(CoresetSpec(**kw), key=kt, device="cpu",
                                   checkpoint=ck)
    ref = JPipeline(jds).build(JSpec(**kw), key=kj)
    assert ck.resumes == 2
    np.testing.assert_array_equal(cs.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(cs.weights.numpy(), np.asarray(ref.weights), rtol=1e-5)
    assert (cs.comm_units, cs.comm_bits) == (ref.comm_units, ref.comm_bits)
