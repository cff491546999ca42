"""No process of the benchmark loads JAX or the JAX package, compared by
whole top-level module names, and the reference's loads nothing of the
program either."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

LOADED = ("import sys, json; print(json.dumps(sorted("
          "{m.split('.')[0] for m in sys.modules})))")


def top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\n" + LOADED],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_and_entries_load_no_jax():
    names = top_names(
        "import flowbench.run, flowbench.calibrate, flowbench.cells\n"
        "import flowonthego_tpu_torch\n"
        "import pathlib, importlib\n"
        "for kind in ('entries', 'traffic', 'layer_metrics', 'yardstick',"
        " 'reference'):\n"
        "    for p in sorted(pathlib.Path('flowbench', kind).glob('*.py')):\n"
        "        importlib.import_module(f'flowbench.{kind}.{p.stem}')\n")
    assert "flowonthego_tpu_torch" in names and "flowbench" in names
    assert not names & {"jax", "jaxlib", "flax", "flowonthego_tpu"}


def test_reference_loads_nothing_of_the_program():
    """Every module under ``flowbench/reference/``, a judge added later
    too."""
    names = top_names(
        "import pathlib, importlib\n"
        "found = sorted(pathlib.Path('flowbench', 'reference').glob('*.py'))\n"
        "assert {'check.py', 'plain_dis.py'} <= {p.name for p in found}\n"
        "for p in found:\n"
        "    importlib.import_module(f'flowbench.reference.{p.stem}')\n")
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "flowonthego_tpu",
                        "flowonthego_tpu_torch"}


def test_forbidden_compares_whole_names():
    from flowbench.run import forbidden_modules
    fakes = ("flowonthego_tpu_torchlike", "jaxlib_like", "jaxlib.fake",
             "flowonthego_tpu.fake")
    for name in fakes:
        sys.modules[name] = sys
    try:
        found = set(forbidden_modules())
        assert {"jaxlib.fake", "flowonthego_tpu.fake"} <= found
        assert not found & {"flowonthego_tpu_torchlike", "jaxlib_like"}
    finally:
        for name in fakes:
            del sys.modules[name]
