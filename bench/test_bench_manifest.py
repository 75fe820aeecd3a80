"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
promise that a configuration, a mix, a loop, an engine, a judge, an input
maker, a metric or a work count is added by new files only."""

import json
import re
import shutil
import time

import pytest
import torch

from benchlib import manifest, runner, tiny

MANIFEST = manifest.load()
LATER = tiny.later()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_names():
    _keys_and_names(MANIFEST)


def _keys_and_names(MANIFEST):
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["bench"]
    assert not any(w.startswith("/") or ".." in w for w in MANIFEST["command"])
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MANIFEST[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_bounds_and_the_setup_metric():
    _bounds(MANIFEST)


def _bounds(MANIFEST):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_check_time_fits_the_full_benchmark():
    """2 + 14 x 24 runs of run_seconds + 60 s, 24 x 180 s of compiles and
    1200 s spare fit in 43,200 s."""
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("workload", [w["name"] for w in LATER["workloads"]])
def test_workload_resolves_to_its_files(workload):
    """Each cell, and each cell that waits in ``bench/later.json``."""
    _resolves(MANIFEST if workload in WORKLOADS else LATER, workload)


def _resolves(MANIFEST, workload):
    cell = manifest.resolve(MANIFEST, workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.workload["chips"] == 1
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported, f"{m['name']} moves {m['moves']}"
        assert callable(cell.readers[m["name"]].read)
    for kind in ("task_" + cell.config["task"], "fit_" + cell.config["fit"]["kind"]):
        assert callable(cell.work(kind).stages)
    for mod, names in ((cell.loop, ("drive", "warmup")),
                       (cell.engine, ("validate", "capacity", "setup")),
                       (cell.judge, ("judge", "reference_serve")),
                       (cell.inputs, ("make",))):
        assert all(callable(getattr(mod, n)) for n in names), mod


def test_every_metric_moves_an_end_to_end_metric():
    _moves(MANIFEST)


def _moves(MANIFEST):
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    names = [w["name"] for w in MANIFEST["workloads"]]
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        assert set(m.get("workloads", names)) <= set(names)
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}     # each used by a cell


def test_configs_name_their_files_and_reduce_nothing():
    _configs(MANIFEST)


def _configs(MANIFEST):
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("bench/") and c["reduced"] == []
        assert manifest.load_json(manifest.ROOT / c["file"])["name"] == c["name"]


def test_later_cells_extend_the_benchmark():
    """``bench/later.json`` (the cells PERF.md keeps for later) keeps the
    contract, and differs from ``BENCHMARK.json`` only by entries added:
    its cells, their configurations and metrics, the cells they report in."""
    for check in (_keys_and_names, _bounds, _moves, _configs):
        check(LATER)
    for key in ("command", "paths", "run_seconds", "end_to_end"):
        assert LATER[key] == MANIFEST[key]
    for key in ("configs", "workloads"):
        assert all(x in LATER[key] for x in MANIFEST[key])
    later = {m["name"]: m for m in LATER["per_layer"]}
    for m in MANIFEST["per_layer"]:
        grown = dict(later[m["name"]], workloads=m["workloads"])
        assert grown == m and set(m["workloads"]) <= set(later[m["name"]]["workloads"])


def test_a_new_cell_is_new_files_only(tmp_path):
    """A configuration with its own input maker and judge, a mix with its
    own loop and engine, a metric and a work count added as files and
    entries resolve without a change to any file already there."""
    bench = tmp_path / "bench"
    shutil.copytree(manifest.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = manifest.load_json(bench / "configs" / "yearpred-vrlr.json")
    cfg["name"] = "half-rows"
    cfg["n"] = cfg["n"] // 2
    cfg["data"]["recipe"] = "census_like"
    cfg["check"]["judge"] = "train_step"
    (bench / "configs" / "half-rows.json").write_text(json.dumps(cfg))
    (bench / "inputs" / "census_like.py").write_text(
        "def make(cfg, seed, device):\n    return None\n")
    (bench / "judges" / "train_step.py").write_text(
        "def judge(cfg, inputs, judged, seed, failed):\n    return {}\n")
    mix = manifest.load_json(bench / "traffic" / "fused-cycle.json")
    mix["budgets"] = [500, 1500]
    mix["loop"], mix["engine"] = "open", "stream"
    (bench / "traffic" / "small-budgets.json").write_text(json.dumps(mix))
    (bench / "loops" / "open.py").write_text(
        "def drive(window, mix, seed, seconds):\n    pass\n")
    (bench / "engines" / "stream.py").write_text(
        "def setup(cfg, mix, inputs, traced=False):\n    return None\n")
    (bench / "metrics" / "fit_share.py").write_text(
        "def read(run):\n    return None\n")
    (bench / "work" / "fit_lasso.py").write_text(
        "def stages(cell, req):\n    return []\n")
    m = json.loads(json.dumps(LATER))
    m["configs"].append({"name": "half-rows", "source": "x", "file": "bench/configs/half-rows.json",
                         "reduced": ["n"], "why": "x"})
    m["workloads"].append({"name": "half-fused", "config": "half-rows",
                           "traffic": "small-budgets", "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "fit_share", "unit": "%", "better": "lower",
                           "source": "program_span", "layer": "solve",
                           "moves": "fits_per_s", "workloads": ["half-fused"]})
    cell = manifest.resolve(m, "half-fused", bench)
    assert cell.config["n"] == cfg["n"]
    assert cell.mix["budgets"] == [500, 1500]
    assert cell.loop.__file__.endswith("open.py") and cell.engine.__file__.endswith("stream.py")
    assert cell.inputs.make(None, 0, None) is None and cell.judge.judge(0, 0, 0, 0, 0) == {}
    assert "fit_share" in cell.readers and cell.work("fit_lasso").stages(cell, None) == []
    assert all(p.read_bytes() == b for p, b in before.items())


PACED_LOOP = """
import time


def warmup(mix, seed):
    return [-1]


def drive(window, mix, seed, seconds):
    start = time.perf_counter()
    for i in range(mix["requests"]):
        due = start + i / mix["rate_per_s"]
        time.sleep(max(0.0, due - time.perf_counter()))
        window.serve(i, arrived=due)
"""

COUNTER_ENGINE = """
class Counter:
    def __init__(self):
        self.seen = []

    def serve(self, req):
        self.seen.append(req)
        return [req]

    @staticmethod
    def cells(served):
        return served


def validate(mix):
    if mix["rate_per_s"] <= 0:
        raise ValueError("rate")
    return mix


def setup(cfg, mix, inputs, traced=False):
    return Counter()
"""

STEPS_JUDGE = """
def judge(cfg, inputs, done, seed, failed):
    order = [req for req, _ in done]
    return {"step_gap": float(order != list(range(len(order)))), "failed": float(failed)}
"""


def test_a_new_kind_of_cell_runs_from_new_files_only(tmp_path):
    """A cell of another kind than the coreset cells, with requests that
    are not budgets, an open loop that sends them at a rate, its own
    engine, judge and input maker, runs through the runner from new files
    and entries alone."""
    bench = tmp_path / "bench"
    shutil.copytree(manifest.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = {"name": "steps", "data": {"recipe": "zeros"},
           "check": {"judge": "steps", "limits": {"step_gap": 0.0}}}
    (bench / "configs" / "steps.json").write_text(json.dumps(cfg))
    (bench / "inputs" / "zeros.py").write_text(
        "import torch\n\n\ndef make(cfg, seed, device):\n    return torch.zeros(4)\n")
    (bench / "judges" / "steps.py").write_text(STEPS_JUDGE)
    (bench / "loops" / "paced.py").write_text(PACED_LOOP)
    (bench / "engines" / "counter.py").write_text(COUNTER_ENGINE)
    (bench / "traffic" / "paced-steps.json").write_text(json.dumps(
        {"loop": "paced", "engine": "counter", "rate_per_s": 400, "requests": 12}))
    m = json.loads(json.dumps(MANIFEST))
    m["configs"].append({"name": "steps", "source": "x", "file": "bench/configs/steps.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "paced-steps", "config": "steps",
                           "traffic": "paced-steps", "chips": 1, "why": "x"})
    cell = manifest.resolve(m, "paced-steps", bench)
    out = runner.run_cell(cell, 3, 1.0, False, torch.device("cpu"), time.perf_counter())
    assert out["correct"] is True and out["attempted"] == 12 and out["failed"] == 0
    assert {"fits_per_s", "request_p95_s", "setup_s"} <= set(out["metrics"])
    assert out["checks"]["step_gap"] == {"value": 0.0, "limit": 0.0}
    assert all(p.read_bytes() == b for p, b in before.items())
