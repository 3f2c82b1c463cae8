"""Find every piece of a cell by its name in ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix.  Its
pieces are files, one per name, so that a later change adds a
configuration, a mix, a cell or a metric as new files and new entries:

* ``configs/<config>.json``  the configuration's sizes (``file`` in
  ``BENCHMARK.json``), and ``configs/<config>.py`` beside it: the port's
  registry entry, the weights' tree and the work counted from shapes;
* ``reference/<config>.py``   the plain float32 reference;
* ``traffic/<mix>.json``      the mix's parameters;
* ``limits/<cell>.json``      the numbers compared and their limits;
* ``metrics/<metric>.py``     one reader per per-layer metric.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from types import ModuleType
from typing import Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, name: str) -> ModuleType:
    """The Python file at ``path`` as a module named ``name`` (file names
    carry ``-`` and ``.``, so they are loaded by path, not imported)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


def _ident(name: str) -> str:
    """A module name for a file name, one to one (``-`` and ``.`` coded)."""
    return "".join(c if c.isalnum() else f"_{ord(c):x}_" for c in name)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config_doc: dict          # configs/<config>.json
    config: ModuleType        # configs/<config>.py
    reference: ModuleType     # reference/<config>.py
    traffic: dict             # traffic/<mix>.json
    limits: dict              # limits/<cell>.json
    end_to_end: list          # BENCHMARK.json entries this cell reports
    per_layer: list


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """A metric without ``workloads`` is reported in every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> ModuleType:
    return load_module(bench_dir / "metrics" / f"{name}.py",
                       f"portbench_metric_{_ident(name)}")


def config_parts(config_name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """(sizes, configuration module, reference module) of a configuration."""
    doc = load_json(bench_dir / "configs" / f"{config_name}.json")
    cfg = load_module(bench_dir / "configs" / f"{config_name}.py",
                      f"portbench_config_{_ident(config_name)}")
    ref = load_module(bench_dir / "reference" / f"{config_name}.py",
                      f"portbench_reference_{_ident(config_name)}")
    return doc, cfg, ref


def cell(name: str, bench: Optional[dict] = None,
         bench_dir: pathlib.Path = BENCH_DIR) -> Cell:
    bench = benchmark(bench_dir.parent) if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")
    w = found[0]
    doc, cfg, ref = config_parts(w["config"], bench_dir)
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]), config_doc=doc, config=cfg, reference=ref,
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)])
