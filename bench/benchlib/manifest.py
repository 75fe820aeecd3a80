"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration ``<c>``: ``bench/configs/<c>.json``, which names the
  maker of its inputs, ``bench/inputs/<data.recipe>.py``, and its judge,
  ``bench/judges/<check.judge>.py``;
* a traffic mix ``<t>``: ``bench/traffic/<t>.json``, which names the loop
  that sends its requests, ``bench/loops/<loop>.py``, and the engine that
  serves them, ``bench/engines/<engine>.py``;
* a metric ``<m>``, end-to-end or per-layer: the reader
  ``bench/metrics/<m>.py``, whose ``read(run)`` returns the number or
  None when the run has nothing to read;
* a kernel's or a stage's work count ``<w>``: ``bench/work/<w>.py``.

Adding a configuration, a mix, a loop, an engine, a judge, an input
maker, a metric or a work count is adding its file and its entry; nothing
here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import one file by its path, under a name of its folder and stem."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    name = f"bench_{path.parent.name}_{path.stem}".replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of the manifest, with everything its run needs."""

    workload: dict
    config: dict
    mix: dict
    inputs: object                # bench/inputs/<recipe>.py: make(cfg, seed, device)
    judge: object                 # bench/judges/<judge>.py: judge(...), reference_serve(...)
    loop: object                  # bench/loops/<loop>.py: drive(window, mix, seed, seconds)
    engine: object                # bench/engines/<engine>.py: setup(cfg, mix, inputs, traced)
    end_to_end: List[dict]        # the metrics a --trace 0 run reports
    per_layer: List[dict]         # the metrics a --trace 1 run reports
    readers: Dict[str, object]    # metric name -> its reader module
    bench: Path
    _work: Dict[str, object] = dataclasses.field(default_factory=dict, repr=False)

    @property
    def name(self) -> str:
        return self.workload["name"]

    def work(self, name: str):
        """The work-count module ``bench/work/<name>.py``."""
        if name not in self._work:
            self._work[name] = load_module(self.bench / "work" / f"{name}.py")
        return self._work[name]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(manifest: dict, workload: str, bench: Path = BENCH) -> Cell:
    """The cell ``workload`` of ``manifest``, its files loaded."""
    wls = {w["name"]: w for w in manifest["workloads"]}
    if workload not in wls:
        raise KeyError(f"no workload {workload!r} in the manifest; "
                       f"have {sorted(wls)}")
    wl = wls[workload]
    cfgs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = cfgs[wl["config"]]
    config = load_json(bench.parent / cfg_entry["file"])
    mix = load_json(bench / "traffic" / f"{wl['traffic']}.json")
    e2e = [m for m in manifest["end_to_end"] if _applies(m, workload)]
    pl = [m for m in manifest["per_layer"] if _applies(m, workload)]
    readers = {m["name"]: load_module(bench / "metrics" / f"{m['name']}.py")
               for m in e2e + pl}
    return Cell(wl, config, mix,
                load_module(bench / "inputs" / f"{config['data']['recipe']}.py"),
                load_module(bench / "judges" / f"{config['check']['judge']}.py"),
                load_module(bench / "loops" / f"{mix['loop']}.py"),
                load_module(bench / "engines" / f"{mix['engine']}.py"),
                e2e, pl, readers, bench)


def load(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")
