"""Streamed-video demo (port of the JAX package's
``examples/stream_alley.py``): dense flow over a directory of frames,
each pair warm-started from the previous one.

    python -m flowonthego_tpu_torch.tools.stream_alley FRAME_DIR \\
        [--save-dir OUT] [--frames N] [--op-point K] [--no-fetch] \\
        [--device cuda|cpu]

Frames are decoded ahead by the native threaded prefetcher where it is
built (else one by one in Python); ``--save-dir`` writes each flow as
.flo; ``--no-fetch`` keeps the flows on the device and syncs once at the
end.
"""

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("frames_dir", help="directory of frames (sorted)")
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--op-point", type=int, default=2)
    ap.add_argument("--no-fetch", action="store_true",
                    help="keep flows on the device (the device's streaming "
                         "rate, without the copy to the host)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..cli import resolve_device
    from ..config import operating_point, pad_to_divisible
    from ..io.native import write_flo_native
    from ..parallel import stream_flow
    from ..utils.timing import synchronize
    from .flow_stream import frame_paths, frame_source

    device = resolve_device(args.device)
    paths = frame_paths(args.frames_dir, args.frames)
    print(f"streaming {len(paths)} frames")
    frames = frame_source(args.frames_dir, args.frames, prefetch_threads=2)
    first = next(frames, None)
    if first is None:
        raise SystemExit("no frames")
    h, w = first.shape[:2]
    cfg = operating_point(args.op_point, width=w)
    pt, pb, pl, pr = pad_to_divisible(w, h, cfg.coarsest_scale)
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)

    def padded_frames():
        yield np.pad(first, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
        for frame in frames:
            yield np.pad(frame, ((pt, pb), (pl, pr), (0, 0)), mode="edge")

    n = 0
    t0 = None
    last = None
    for flow in stream_flow(padded_frames(), cfg, fetch=not args.no_fetch,
                            device=device):
        if t0 is None:
            t0 = time.perf_counter()   # the first pair builds the kernels
        n += 1
        last = flow
        if args.save_dir and not args.no_fetch:
            out = flow[pt:pt + h, pl:pl + w]
            write_flo_native(f"{args.save_dir}/flow_{n:04d}.flo", out)
    if last is None:
        raise SystemExit("a stream needs two frames")
    if args.no_fetch:
        synchronize(last.device)
        _ = float(last.sum())          # sync once at the end
    dt = time.perf_counter() - t0
    mode = ("device-resident" if args.no_fetch
            else "includes full-flow host fetch per frame")
    print(f"{n} flows; steady-state {dt / max(n - 1, 1) * 1e3:.2f} ms/frame "
          f"({(n - 1) / dt:.1f} fps) [{mode}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
