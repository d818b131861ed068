"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each lives in a file of its own (``configs/<config>.json``,
``traffic/<traffic>.json``), as do the cell's correctness limits
(``limits/<workload>.json``), each metric's reader (``metrics/<name>.py``)
and the kernels that implement a counted operation
(``kernels/<operation>/*.json``). Adding a cell, a mix, a metric or a kernel
adds files and edits none.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    with open(path) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json("configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def limits(workload_name: str) -> dict:
    return _json("limits", f"{workload_name}.json")


def kernel_specs(operation: str) -> list:
    """The kernel specs of an operation: every ``kernels/<operation>/*.json``."""
    specs = []
    for path in sorted(glob.glob(os.path.join(HERE, "kernels", operation, "*.json"))):
        with open(path) as f:
            specs.append(json.load(f))
    return specs


def metric_module(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, loaded by path."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(name: str):
    """The adapter of a model family: ``families/<name>.py``."""
    return importlib.import_module(f"portbench.families.{name}")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: with trace off its end-to-end
    metrics, with trace on its per-layer ones. A metric with ``workloads``
    is reported where it lists the cell; an end-to-end metric without it in
    every cell, a per-layer one without it in every cell that reports the
    metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def check_names(bench: dict) -> list:
    """Every name and unit of the manifest that breaks the character rules."""
    bad = []
    for c in bench["configs"]:
        bad += [n for n in [c["name"], *c["reduced"]] if not NAME_RE.match(n)]
    for w in bench["workloads"]:
        bad += [n for n in (w["name"], w["config"], w["traffic"]) if not NAME_RE.match(n)]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not NAME_RE.match(m["name"]):
            bad.append(m["name"])
        if not UNIT_RE.match(m["unit"]):
            bad.append(m["unit"])
    return bad
