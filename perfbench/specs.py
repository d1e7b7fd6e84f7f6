"""Finding what a cell is made of, by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix and lists the metrics; everything else is a file of its
own under ``perfbench/``, found by the name it carries there:

* ``configs/<config>.json``: the configuration's file (its ``file`` in
  ``BENCHMARK.json``), which names its architecture,
  ``architectures/<architecture>.py`` (what the harness knows of one kind
  of model: the mapping onto the port, the weights' layout, the work
  arithmetic, the faults of its cache), and its plain reference,
  ``references/<reference>.py``;
* ``traffic/<traffic>.json``: the mix's parameters, read by
  :mod:`perfbench.traffic`;
* ``cells/<cell>.json``: what belongs to one cell alone: the limit of each
  number the check compares, the readings it was set from, the tuning
  budget and the size of the check's sample;
* ``metrics/<metric>.py``: one reader per metric, a ``read(ctx)`` that
  returns the value or None where it finds nothing to read.

A later change adds an architecture, a configuration, a mix, a cell or a
metric as new files and entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Optional

__all__ = ["ROOT", "BENCH_DIR", "Cell", "load_benchmark", "load_cell", "metric_reader",
           "metrics_for", "load_reference", "load_architecture", "architecture_of"]

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    architecture: object  # the module architectures/<config's architecture>.py
    traffic: dict  # the mix's file
    check: dict  # cells/<name>.json
    end_to_end: list  # BENCHMARK.json's metric entries this cell reports
    per_layer: list


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def metrics_for(entries: list, cell: str) -> list:
    """The metric entries a cell reports: those that list it, and those
    that list no cells at all."""
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR,
              bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its files read."""
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    check = _read_json(os.path.join(bench_dir, "cells", f"{name}.json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                architecture=architecture_of(config, bench_dir), traffic=traffic, check=check,
                end_to_end=metrics_for(bench["end_to_end"], name),
                per_layer=metrics_for(bench["per_layer"], name))


def _load_module(path: str, mod_name: str):
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    return _load_module(path, "perfbench_metric_" + name.replace(".", "_").replace("-", "_")).read


def load_reference(name: str, bench_dir: str = BENCH_DIR):
    """The plain reference module ``references/<name>.py``."""
    path = os.path.join(bench_dir, "references", f"{name}.py")
    return _load_module(path, "perfbench_reference_" + name.replace("-", "_"))


def load_architecture(name: str, bench_dir: str = BENCH_DIR):
    """The architecture module ``architectures/<name>.py``."""
    path = os.path.join(bench_dir, "architectures", f"{name}.py")
    return _load_module(path, "perfbench_architecture_" + name.replace("-", "_"))


def architecture_of(config: dict, bench_dir: str = BENCH_DIR):
    """The architecture module that a configuration's file names under
    ``architecture``; a file that names none is refused."""
    if "architecture" not in config:
        raise KeyError(f"configuration {config.get('name')!r} has no 'architecture' key: "
                       "it names architectures/<architecture>.py")
    return load_architecture(config["architecture"], bench_dir)
