"""A cell by its name: ``BENCHMARK.json``'s entry and the files it names.

A cell ``<config>.<mix>`` resolves to ``configs/<config>.json`` (the
deployment), ``traffic/<mix>.json`` (the traffic mix, which names its law
``traffic/<law>.py`` and its entry ``entries/<entry>.py``) and
``limits/<cell>.json`` (the limit of each number the comparison reads);
each per-layer metric ``<metric>`` to ``layer_metrics/<metric>.py``; the
configuration's judge (its ``reference``, default ``check``) to
``reference/<reference>.py``.  A later change adds files and entries here
and edits none, also for a configuration that departs from its operating
point's preset (its ``departs``) and brings the reference that computes
that mode.
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
    """``flowbench/<kind>/<name>.py``: a traffic law, an entry, a
    per-layer metric's reader or a judge."""
    return importlib.import_module(f"flowbench.{kind}.{name}")


def program_config(port, conf: dict, **changes):
    """The program's configuration of a deployment: its operating point at
    its width (``operating_point(op, width=W)``) with the keys of the
    file's ``departs`` (a ``dis`` key -> a one-line reason) replaced by
    its ``dis`` values, which must then state every value of the file's
    ``dis`` object; ``changes`` (the control's precision) are applied
    after the check."""
    cfg = port.operating_point(conf["operating_point"], width=conf["width"])
    preset = dataclasses.asdict(cfg)
    departs = conf.get("departs", {})
    for key, why in departs.items():
        if key not in preset:
            raise ValueError(f"departs: {key!r} is no field of the "
                             f"program's configuration")
        if key not in conf["dis"]:
            raise ValueError(f"departs: {key!r} is not stated in dis")
        if conf["dis"][key] == preset[key]:
            raise ValueError(f"departs: {key!r} = {preset[key]!r} is the "
                             f"preset's own value")
        if not isinstance(why, str) or not why.strip() or "\n" in why:
            raise ValueError(f"departs: {key!r} needs a one-line reason")
    cfg = dataclasses.replace(cfg, **{k: conf["dis"][k] for k in departs})
    stated = dataclasses.asdict(cfg)
    wrong = {k: (v, stated.get(k)) for k, v in conf["dis"].items()
             if stated.get(k) != v}
    if wrong:
        raise ValueError(f"the program's operating point "
                         f"{conf['operating_point']} at width "
                         f"{conf['width']} differs from the configuration "
                         f"(stated, program's): {wrong}; a departure is "
                         f"listed under departs with its reason")
    return dataclasses.replace(cfg, **changes)
