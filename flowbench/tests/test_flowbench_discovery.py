"""A configuration, a traffic mix, a per-layer metric and a judge are files
found by name: a copy of the benchmark gains a cell by new files and a
new entry of BENCHMARK.json alone, and the new reader and judge are
called.  A configuration states how it departs from its operating
point's preset, and the harness refuses any other departure, and what
the judge does not compute, before the warm-up."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import types

import pytest

import flowonthego_tpu_torch
from flowbench import cells
from flowbench.reference import check
from flowbench.run import run_cell

from conftest import TINY_CONFIGS, make_root, write_json

HERE = pathlib.Path(__file__).resolve().parents[1]

RECORDED = '''"""check's judge, recording each call."""
from . import check

CALLS = []


def check_params(dis):
    CALLS.append("check_params")
    check.check_params(dis)


def stream(*args):
    CALLS.append("stream")
    return check.stream(*args)


def pairs(*args):
    CALLS.append("pairs")
    return check.pairs(*args)
'''


def copy_of_the_benchmark(tmp_path, cells=("tiny-op2.ring",)):
    root = make_root(tmp_path, cells=cells)
    shutil.copytree(HERE, root / "flowbench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root, root / "flowbench"


def test_new_files_are_found_by_name(tmp_path):
    root, here = copy_of_the_benchmark(tmp_path)
    conf = json.loads((here / "configs" / "tiny-op2.json").read_text())
    write_json(here / "configs" / "other-op2.json", conf)
    mix = json.loads((here / "traffic" / "ring.json").read_text())
    write_json(here / "traffic" / "other-mix.json", dict(mix, ring=5))
    write_json(here / "limits" / "other-op2.other-mix.json",
               {"epe_ref_p99": {"limit": 1e-4}})
    (here / "layer_metrics" / "frames_seen.py").write_text(
        "def read(summary):\n    return float(summary['frames'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="other-op2.other-mix",
                                   config="other-op2", traffic="other-mix",
                                   chips=1, why="test"))
    bench["per_layer"].append(dict(name="frames_seen", unit="frames",
                                   better="higher", source="device_trace",
                                   layer="test", moves="frames_per_s",
                                   workloads=["other-op2.other-mix"]))
    write_json(root / "BENCHMARK.json", bench)
    code = (
        "import sys; from flowbench import cells\n"
        "c = cells.load('other-op2.other-mix')\n"
        "law = cells.module('traffic', c.spec['law'])\n"
        "ring = law.make(c.spec, c.conf, 1)\n"
        "names = [m['name'] for m in c.per_layer]\n"
        "reader = cells.module('layer_metrics', 'frames_seen')\n"
        "print(len(ring), 'frames_seen' in names,\n"
        "      reader.read({'frames': 3}), cells.__file__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(root), "PATH": "/usr/bin"})
    assert out.returncode == 0, out.stderr
    n, listed, value, where = out.stdout.split()
    assert (n, listed, value) == ("5", "True", "3.0")
    assert where.startswith(str(root))


def test_a_departing_config_and_its_judge_are_new_files(tmp_path):
    root, here = copy_of_the_benchmark(tmp_path)
    conf = json.loads((here / "configs" / "tiny-op2.json").read_text())
    assert conf["dis"]["use_var_ref"] is True
    conf["dis"]["use_var_ref"] = False
    conf.update(departs={"use_var_ref": "the densified flow alone"},
                reference="recorded")
    write_json(here / "configs" / "bare-op2.json", conf)
    (here / "reference" / "recorded.py").write_text(RECORDED)
    write_json(here / "limits" / "bare-op2.ring.json",
               {"epe_ref_p99": {"limit": 1e-4}})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="bare-op2.ring", config="bare-op2",
                                   traffic="ring", chips=1, why="test"))
    write_json(root / "BENCHMARK.json", bench)
    code = (
        "import json, torch; torch.set_num_threads(1)\n"
        "import flowonthego_tpu_torch as port\n"
        "from flowbench import cells\n"
        "from flowbench.run import run_cell\n"
        "from flowbench.reference import recorded\n"
        "cfg = cells.program_config(port, cells.load('bare-op2.ring').conf)\n"
        "r = run_cell('bare-op2.ring', 2 ** 31 + 9, 0.5, False,"
        " device='cpu')\n"
        "print(json.dumps(dict(correct=r['correct'], calls=recorded.CALLS,"
        " var_ref=cfg.use_var_ref, where=recorded.__file__)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": f"{root}:{HERE.parent}",
                              "PATH": "/usr/bin"})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["correct"] is True
    assert got["calls"] == ["check_params", "stream"]
    assert got["var_ref"] is False
    assert got["where"].startswith(str(root))


def tiny_conf(**dis):
    op, h, w = TINY_CONFIGS["tiny-op2"]
    preset = flowonthego_tpu_torch.operating_point(op, width=w)
    return dict(operating_point=op, height=h, width=w, channels=3,
                dis=dict(dataclasses.asdict(preset), **dis))


@pytest.mark.parametrize("departs,dis,drop,says", [
    ({}, {"use_var_ref": False}, None, "use_var_ref"),
    ({"use_var_ref": "why"}, {}, None, "preset's own value"),
    ({"no_such_key": "why"}, {"no_such_key": 1}, None, "no field"),
    ({"cost_fn": "why"}, {}, "cost_fn", "not stated in dis"),
    ({"use_var_ref": "two\nlines"}, {"use_var_ref": False}, None,
     "one-line reason"),
], ids=["unlisted", "equal-to-preset", "not-a-field", "not-in-dis",
        "no-reason"])
def test_program_config_refuses_a_departure(departs, dis, drop, says):
    conf = tiny_conf(**dis)
    conf["departs"] = departs
    if drop:
        del conf["dis"][drop]
    with pytest.raises(ValueError, match=says):
        cells.program_config(flowonthego_tpu_torch, conf)


def test_a_listed_departure_replaces_the_preset():
    conf = tiny_conf(use_var_ref=False, cost_fn="huber")
    conf["departs"] = {"use_var_ref": "no refinement",
                       "cost_fn": "robust cost"}
    cfg = cells.program_config(flowonthego_tpu_torch, conf,
                               dtype="bfloat16")
    assert (cfg.use_var_ref, cfg.cost_fn, cfg.dtype) == (
        False, "huber", "bfloat16")
    del conf["departs"]
    with pytest.raises(ValueError, match="cost_fn"):
        cells.program_config(flowonthego_tpu_torch, conf)


class Watched:
    """The program, with every attribute the harness reads recorded."""

    def __init__(self):
        self.read = set()

    def __getattr__(self, name):
        self.read.add(name)
        return getattr(flowonthego_tpu_torch, name)


def only_pairs():
    judge = types.ModuleType("flowbench.reference.only_pairs")
    judge.check_params, judge.pairs = check.check_params, check.pairs
    return judge


@pytest.mark.parametrize("departs,reference,says", [
    ({"cost_fn": "huber"}, "check", "cost_fn"),
    ({}, "only_pairs", "'stream'"),
], ids=["mode-not-computed", "kind-not-judged"])
def test_a_judge_refuses_before_the_warm_up(tiny_root, monkeypatch, capsys,
                                            departs, reference, says):
    monkeypatch.setitem(sys.modules, "flowbench.reference.only_pairs",
                        only_pairs())
    path = tiny_root / "flowbench" / "configs" / "tiny-op2.json"
    conf = json.loads(path.read_text())
    conf["dis"].update(departs)
    conf.update(departs={k: "test" for k in departs}, reference=reference)
    write_json(path, conf)
    port = Watched()
    with pytest.raises(ValueError, match=says):
        run_cell("tiny-op2.ring", 3, 0.5, False, device="cpu",
                 root=tiny_root, port=port)
    assert port.read == {"operating_point"}
    assert capsys.readouterr().out == ""


def test_each_cell_names_a_number_between_its_readings():
    from flowbench import cells
    from flowbench.reference.check import STATS
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        limits = cells.load(w["name"]).limits
        assert limits and set(limits) <= set(STATS), w["name"]
        for v in limits.values():
            assert v["lower"] < v["limit"] < v["upper"], w["name"]
