"""``BENCHMARK.json`` and the files it names, each found by its name."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

__all__ = ["PKG", "ROOT", "Cell", "load", "cell", "reader", "reference"]


@dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""
    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    metrics: List[dict]     # the metrics this cell reports, with "kind"
    root: Path = ROOT       # the checkout its files were found in


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload``: its configuration's file (the
    ``file`` of its entry in ``configs``), its traffic mix
    (``traffic/<traffic>.json``) and every metric that lists it, or lists
    no cells at all."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    metrics = [dict(m, kind=kind) for kind in ("end_to_end", "per_layer")
               for m in bench[kind]
               if "workloads" not in m or workload in m["workloads"]]
    return Cell(workload, int(w["chips"]), config, traffic, metrics, root)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_file_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_readers: Dict[Path, Callable] = {}


def reader(name: str, root: Path = ROOT) -> Callable:
    """``read(record)`` of ``metrics/<name>.py``: the metric's value, or
    None where the run holds nothing for it to read."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    if path not in _readers:
        _readers[path] = _module(path).read
    return _readers[path]


def reference(family: str, root: Path = ROOT):
    """The plain float32 forward of ``reference/<family>.py``."""
    return _module(root / "portbench" / "reference" / f"{family}.py")
