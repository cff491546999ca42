"""Tiny cells for the CPU tests: a root with its own ``BENCHMARK.json`` and
configuration, traffic and limit files, read by ``cells.load(root=...)``;
the laws, entries and readers are the benchmark's own modules."""

from __future__ import annotations

import dataclasses
import json
import pathlib

import pytest
import torch

# the tests' own setting, not the benchmark's: several test processes
# share the host, and each tiny run is faster on one thread
torch.set_num_threads(1)

# (operating point, height, width): op 4 keeps finest scale 0; op 2 at
# width 192 has scales 3..1, so its flows are upsampled
TINY_CONFIGS = {"tiny-op4": (4, 44, 128), "tiny-op2": (2, 60, 192)}
TINY_MIXES = {
    "ring": dict(law="split_ring", entry="stream", ring=6, amplitude_px=2,
                 texture_factor=8, frames_on="host", fetch=True,
                 warmup_frames=3, chained=7, sampled=2, trace_frames=4),
    "ring-device": dict(law="split_ring", entry="stream", ring=6,
                        amplitude_px=2, texture_factor=8, frames_on="device",
                        fetch=False, warmup_frames=3, chained=7, sampled=2,
                        trace_frames=4),
    "pairs": dict(law="cold_pairs", entry="pairs", pairs=4,
                  magnitude_px=[2, 5], texture_factor=8, warmup_frames=2,
                  sampled=2, trace_frames=4),
}
TINY_CELLS = ("tiny-op4.ring", "tiny-op2.ring", "tiny-op4.pairs",
              "tiny-op2.ring-device")
LIMIT = 1e-4


def write_json(path: pathlib.Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_root(root: pathlib.Path, cells=TINY_CELLS) -> pathlib.Path:
    import flowonthego_tpu_torch as port
    here = root / "flowbench"
    for name, (op, h, w) in TINY_CONFIGS.items():
        dis = dataclasses.asdict(port.operating_point(op, width=w))
        write_json(here / "configs" / f"{name}.json",
                   dict(source="test", operating_point=op, height=h, width=w,
                        channels=3, dis=dis, reduced=[], assumed={}))
    for name, spec in TINY_MIXES.items():
        write_json(here / "traffic" / f"{name}.json", spec)
    for cell in cells:
        write_json(here / "limits" / f"{cell}.json",
                   {"epe_ref_p99": {"limit": LIMIT}})
    bench = json.loads((pathlib.Path(__file__).resolve().parents[2]
                        / "BENCHMARK.json").read_text())
    bench["configs"] = []
    bench["workloads"] = [dict(name=c, config=c.split(".")[0],
                               traffic=c.split(".")[1], chips=1, why="test")
                          for c in cells]
    for m in bench["per_layer"] + bench["end_to_end"]:
        m.pop("workloads", None)
    write_json(root / "BENCHMARK.json", bench)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
