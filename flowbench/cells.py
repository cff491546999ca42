"""A cell by its name: ``BENCHMARK.json``'s entry and the files it names.

A cell ``<config>.<mix>`` resolves to ``configs/<config>.json`` (the
deployment), ``traffic/<mix>.json`` (the traffic mix, which names its law
``traffic/<law>.py`` and its entry ``entries/<entry>.py``) and
``limits/<cell>.json`` (the limit of each number the comparison reads);
each per-layer metric ``<metric>`` to ``layer_metrics/<metric>.py``.  A
later change adds files and entries here and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib
from typing import NamedTuple, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]


class Cell(NamedTuple):
    name: str
    entry: dict          # the cell's entry of BENCHMARK.json's workloads
    conf: dict           # configs/<config>.json
    spec: dict           # traffic/<mix>.json
    limits: dict         # limits/<cell>.json
    per_layer: list      # BENCHMARK.json's per-layer metrics of this cell
    end_to_end: list


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, root: Optional[pathlib.Path] = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` (root: the checkout)."""
    root = pathlib.Path(root or ROOT)
    bench = _json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(there are {sorted(entries)})")
    w = entries[name]
    here = root / "flowbench"

    def listed(metrics):
        return [m for m in metrics
                if "workloads" not in m or name in m["workloads"]]

    return Cell(name, w, _json(here / "configs" / f"{w['config']}.json"),
                _json(here / "traffic" / f"{w['traffic']}.json"),
                _json(here / "limits" / f"{name}.json"),
                listed(bench["per_layer"]), listed(bench["end_to_end"]))


def module(kind: str, name: str):
    """``flowbench/<kind>/<name>.py``: a traffic law, an entry or a
    per-layer metric's reader."""
    return importlib.import_module(f"flowbench.{kind}.{name}")


def program_config(port, conf: dict, **changes):
    """The program's configuration of a deployment: its operating point at
    its width (``operating_point(op, width=W)``), which must state every
    value of the file's ``dis`` object; ``changes`` (the control's
    precision) are applied after the check."""
    cfg = port.operating_point(conf["operating_point"], width=conf["width"])
    stated = dataclasses.asdict(cfg)
    wrong = {k: (v, stated.get(k)) for k, v in conf["dis"].items()
             if stated.get(k) != v}
    if wrong:
        raise ValueError(f"the program's operating point "
                         f"{conf['operating_point']} at width "
                         f"{conf['width']} differs from the configuration "
                         f"(stated, program's): {wrong}")
    return dataclasses.replace(cfg, **changes)
