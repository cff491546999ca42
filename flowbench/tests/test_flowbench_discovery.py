"""A configuration, a traffic mix and a per-layer metric are files found by
name: a copy of the benchmark gains a cell by new files and a new entry
of BENCHMARK.json alone, and the new reader is called."""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

from conftest import make_root, write_json

HERE = pathlib.Path(__file__).resolve().parents[1]


def test_new_files_are_found_by_name(tmp_path):
    root = make_root(tmp_path, cells=("tiny-op2.ring",))
    shutil.copytree(HERE, root / "flowbench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = root / "flowbench"
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


def test_each_cell_names_a_number_between_its_readings():
    from flowbench import cells
    from flowbench.reference.check import STATS
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        limits = cells.load(w["name"]).limits
        assert limits and set(limits) <= set(STATS), w["name"]
        for v in limits.values():
            assert v["lower"] < v["limit"] < v["upper"], w["name"]
