"""A whole run of each cell at a tiny size on the CPU (the kernels' plain
versions), past the look for a chip: set-up, window, metrics, check and
the result line."""

import json
import time

import pytest
import torch

from benchlib import runner, tiny

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]
WORKLOADS = [w["name"] for w in tiny.later()["workloads"]]


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors: the intra-op pool costs more than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_tiny_run_prints_the_contract_keys(workload, trace):
    cell = tiny.cell(workload)
    out = runner.run_cell(cell, 2 ** 31 + 7, 0.3, bool(trace), torch.device("cpu"),
                          time.perf_counter(), tiny.SLICE)
    line = json.loads(json.dumps(runner.result_line(out, {"platform": "cpu"})))
    want = CONTRACT + (["breakdown"] if "breakdown" in line else []) + ["checks"]
    assert list(line) == want                  # the compared numbers come last
    assert trace or "breakdown" not in line
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert {"fits_per_s", "request_p95_s", "setup_s"} <= set(line["metrics"])
        assert "device_peak_gb" not in line["metrics"]       # no device, no reading
    assert set(line["checks"]) == set(cell.config["check"]["limits"]) | {"failed"}


def test_run_without_a_card_prints_no_result(capsys, monkeypatch):
    import run as entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert entry.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_jax_in_the_process_is_found():
    """Top-level names compared whole: the port is not the JAX package."""
    assert runner.forbidden_modules(["torch", "repro.core.api", "jax.numpy"]) == ["jax", "repro"]
    assert runner.forbidden_modules(["repro_torch.core", "jaxtyping", "flax.linen"]) == ["flax"]
