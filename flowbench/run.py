"""Run one cell of the benchmark once.

    python -m flowbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): the frames of
the cell's traffic mix from ``--seed`` on the host, the program's
kernels loaded from its build directory in the checkout (built there by
the first run), and the warm-up, which runs the cell's only shape eagerly
once and records its graph.  Then a closed-loop window of ``--seconds``:
one caller, the next frame when the last flow is in hand.  With
``--trace 0`` the last line of standard output is the cell's end-to-end
metrics; with ``--trace 1`` the first frames of the window run under
``torch.profiler`` and the line holds the per-layer metrics, the device's
busy and window seconds and a breakdown.  Once the window has closed, the
program's state is freed and the configuration's judge, the plain
reference it names (``reference/<reference>.py``, default
``reference/check.py``), judges the kept flows; each number compared is
printed beside its limit, last on standard error and last in the result's
line.  A configuration its judge does not compute, or traffic of a kind
the judge has no function for, is refused before the warm-up.

The run needs a CUDA device (it exits 2 without one, printing no result)
and refuses to print a result if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from . import cells  # noqa: E402
from .keep import Kept  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "flowonthego_tpu")
TRACE_TRIES = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root=None, port=None,
             changes=None, memo=None, readings_out=None,
             mix_changes=None) -> dict:
    """One run of the cell ``name``: the result's line as a dict.
    ``port``: the program's package (default: ``flowonthego_tpu_torch``);
    ``changes``: fields of the program's configuration to replace (the
    control's precision), ``memo``: the reference chain's flows shared by
    runs of one seed, ``readings_out``: a list the comparison's readings
    are appended to, ``mix_changes``: keys of the traffic mix to replace
    (all four for ``calibrate.py``)."""
    import torch

    cell = cells.load(name, root)
    if port is None:
        import flowonthego_tpu_torch as port
    on_card = torch.device(device).type == "cuda"
    cfg = cells.program_config(port, cell.conf, **(changes or {}))
    # the judge: check_params(dis) raises on what it does not compute;
    # stream(...) and pairs(...) return check.Readings
    judge = cells.module("reference", cell.conf.get("reference", "check"))
    judge.check_params(cell.conf["dis"])
    spec = dict(cell.spec, **(mix_changes or {}))
    t_imported = time.perf_counter()
    seed %= 2 ** 64                 # numpy's generators take no negatives
    traffic = cells.module("traffic", spec["law"]).make(spec, cell.conf,
                                                        seed)
    if not callable(getattr(judge, traffic.kind, None)):
        raise ValueError(f"the judge {judge.__name__} has no function for "
                         f"{traffic.kind!r} traffic")
    t_made = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    entry = cells.module("entries", spec["entry"]).Entry(
        port, cfg, traffic, spec, device)
    kept = Kept(traffic.kind, int(spec.get("chained", 0)),
                int(spec["sampled"]), len(traffic), seed)
    kept.warm(entry.warm())
    if trace:
        from .yardstick.trace import Tracer
        Tracer().warm()         # the tracer's own set-up, out of the window
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s: imports {t_imported - T_START:.3f}, "
        f"frames {t_made - t_imported:.3f}, warm-up "
        f"{T_START + setup_s - t_made:.3f}")

    window = Window(entry, kept, spec, seconds, trace)
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    lat, ends, t_open, t_close, summary, profiled = window.run()
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    n = len(lat)
    d = {k: (getattr(use1, k) - getattr(use0, k)) / n
         for k in ("ru_minflt", "ru_majflt", "ru_utime", "ru_stime",
                   "ru_nivcsw")}
    log(f"host over the window, a frame: {d['ru_minflt']:.1f} minor and "
        f"{d['ru_majflt']:.2f} major page faults, user "
        f"{d['ru_utime'] * 1e3:.3f} ms, system {d['ru_stime'] * 1e3:.3f} ms"
        f" (all threads), {d['ru_nivcsw']:.2f} involuntary context switches")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    entry.close()
    del entry, window

    lat_ms = np.asarray(lat) * 1e3
    per_s = np.bincount(((np.asarray(ends) - t_open)).astype(int))
    log(f"frames delivered in each second of the window: {per_s.tolist()}")
    p95 = float(np.percentile(lat_ms, 95))
    log(f"{name}: seed {seed}, {n} frames in {t_close - t_open:.3f} s; "
        f"frame ms median {np.median(lat_ms):.4f}, p95 {p95:.4f} "
        f"({int(np.sum(lat_ms > p95))} frames beyond it), max "
        f"{lat_ms.max():.4f}; set-up {setup_s:.3f} s; device memory peak "
        f"{peak} B")
    t_ref = time.perf_counter()
    readings = getattr(judge, traffic.kind)(traffic, cell.conf["dis"], kept,
                                            device, memo)
    for label, st in readings.flows:
        log(f"  {label}: EPE vs the reference mean {st['mean']:.4g}, p90 "
            f"{st['p90']:.4g}, p99 {st['p99']:.4g}, p99.9 {st['p999']:.4g},"
            f" max {st['max']:.4g} px; {100 * st['over']:.4g}% of pixels "
            f"over 0.01 px")
    log(f"reference: {len(readings.flows)} flows compared in "
        f"{time.perf_counter() - t_ref:.3f} s; mean EPE vs the true motion "
        f"(known pixels) {np.mean(readings.true):.4f} px")
    if readings_out is not None:
        readings_out.append(readings)

    checks = {k: {"value": readings.worst(k), "limit": v["limit"]}
              for k, v in cell.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": n, "failed": 0}
    if not trace:
        values = {"frames_per_s": n / (t_close - t_open),
                  "frame_ms_p95": p95,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        if not summary["complete"]:
            log("trace: every profile lost throw-away kernels; the last is "
                "read as it is")
        summary.update(counts=readings.counts, params=cell.conf["dis"],
                       frames_counted=readings.frames_counted,
                       shape=pipeline_shape(traffic, cell.conf["dis"]),
                       frame_ms=lat_ms[~np.asarray(profiled, bool)])
        metrics = {}
        for m in cell.per_layer:
            v = cells.module("layer_metrics", m["name"]).read(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {
            "device_ops": top(summary["device_s"]),
            "idle_gaps": top(summary["idle_s"])}
        log(f"trace: {summary['frames']} frames in {summary['window_s']:.4f} "
            f"s, device busy {summary['busy_s']:.4f} s, launch calls "
            f"{summary['launch_calls']}")
        log("trace: host ms a frame by operation (own time): " + ", ".join(
            f"{k} {v / summary['frames'] * 1e3:.4g}"
            for k, v in top(summary["host_s"], 12)))
    result["device"] = dev
    result["checks"] = checks
    return result


class Window:
    """The measured window: one caller in a closed loop for ``seconds``,
    every frame's latency and delivery time kept, every flow offered to
    ``kept``; with ``trace`` the first ``trace_frames`` frames once a
    stream's chained flows are kept run under the profiler (keeping them
    makes the allocator take fresh device memory for each: that is no
    frame's work), taken again (up to :data:`TRACE_TRIES` times) where a
    profile lost throw-away kernels."""

    def __init__(self, entry, kept: Kept, spec: dict, seconds: float,
                 trace: bool):
        self.entry, self.kept, self.spec = entry, kept, spec
        self.seconds, self.trace = seconds, trace

    def run(self):
        """(latencies, delivery times, open, close, trace summary, whether
        each frame ran under the profiler)."""
        from .yardstick.trace import Tracer
        tracer = summary = None
        tries = traced = 0
        lat, ends, profiled = [], [], []
        t_open = time.perf_counter()
        deadline = t_open + self.seconds
        while True:
            if self.trace and tracer is None and tries < TRACE_TRIES and (
                    summary is None or not summary["complete"]) and (
                    self.kept.chain_full):
                tracer, traced = Tracer(), 0
                tracer.start()
            profiled.append(tracer is not None)
            t_in, t_out, i, flow = self.entry.call()
            lat.append(t_out - t_in)
            ends.append(t_out)
            self.kept.offer(i, flow)
            if tracer is not None:
                traced += 1
                if traced == self.spec["trace_frames"] or t_out >= deadline:
                    summary, tracer = tracer.stop(traced), None
                    tries += 1
            if t_out >= deadline:
                return lat, ends, t_open, t_out, summary, profiled


def pipeline_shape(traffic, params: dict) -> tuple:
    """(H, W, C) of the padded frames the pipeline runs on."""
    if traffic.kind == "stream":
        return tuple(traffic.frames[0].shape)
    from .reference.plain_dis import pads_for
    h, w, c = traffic.pair(0)[0].shape
    pt, pb, pl, pr = pads_for(h, w, params["coarsest_scale"])
    return h + pt + pb, w + pl + pr, c


def top(seconds: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(seconds.items(),
                                      key=lambda kv: -kv[1])[:n]]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return (out.stdout.strip().splitlines() or ["nvidia-smi: no answer"])[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.entry["chips"]):
        log(f"{args.workload} needs {cell.entry['chips']} CUDA device(s); "
            f"torch sees {torch.cuda.device_count()}: no result")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process, and forbidden: {bad}: no result")
        return 3
    log(f"card: {card_line()}")
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']:.6g} (limit {c['limit']:.6g})"
            f" -> {'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
