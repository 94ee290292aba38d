"""Everything the harness runs is found by name: a cell in
``BENCHMARK.json``, its configuration ``benchmark/configs/<config>.json``
(which names its plain reference, ``benchmark/models/<model>.py``), its
traffic mix ``benchmark/traffic/<traffic>.json``, its limits
``benchmark/limits/<cell>.json`` and each metric's reader
``benchmark/metrics/<metric>.py``, or, for a metric named
``<base>.<part>`` without a file of its own, the reader
``benchmark/metrics/<base>.py`` that it shares (``mfu.train`` and
``mfu.infer`` read ``mfu.py``). Adding a cell, a configuration, a mix
or a metric adds files and entries; no file here changes. A
configuration's ``calls`` table (``sub`` of any odd kernel, ``sub3``
the same op at k 3, ``down2``, ``up2``, ``dense``, global ``attn``,
``patch_attn`` and ``window_attn``, attention within 3D windows of a
level, shifted or not) is what ``harness/work.py`` counts its work from.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, List, NamedTuple, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_file() -> dict:
    return _json(os.path.join(REPO_DIR, "BENCHMARK.json"))


def config(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def limits(cell: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "limits", f"{cell}.json"))


def reference(cfg: dict):
    """The configuration's plain reference module."""
    return importlib.import_module(f"benchmark.models.{cfg['model']}")


def metric_path(name: str) -> str:
    """The reader's file of the metric ``name``."""
    own = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if os.path.exists(own):
        return own
    return os.path.join(BENCH_DIR, "metrics", f"{name.split('.')[0]}.py")


def metric_reader(name: str) -> Callable:
    """``read(ctx)`` of the metric's reader (``metric_path``)."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its configuration, mix and the metrics it
    reports. A per-layer metric without a ``workloads`` list goes to every
    cell that reports the end-to-end metric it moves."""
    bench = bench or benchmark_file()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (_reports(m, name) if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name, config(w["config"]), traffic(w["traffic"]), w["chips"], e2e, per)
