"""Streaming loop (port of the JAX package's ``tools/flow_stream.py``):
frames in a loop, warm-started dense flow, per-frame timing.

Sources (positional argument):
  * a directory of frames (sorted .png, .jpg, .jpeg, .ppm files);
  * a video file or a webcam index (what ``cv2.VideoCapture`` opens; this
    needs OpenCV, and without it the command stops with an error).

Consecutive pairs go through ``stream_flow`` (the previous flow seeds the
coarsest scale).  Per-frame wall time is printed as the JAX script prints
it; ``--out DIR`` writes colour-wheel PNGs, ``--flo DIR`` the .flo
fields.  ``--device cuda|cpu`` (default cuda) is where the flow runs;
with ``cuda`` and no GPU the command stops with an error.

Usage:
  python -m flowonthego_tpu_torch.tools.flow_stream FRAME_DIR --op 2 --flo OUT
  python -m flowonthego_tpu_torch.tools.flow_stream video.mp4 --max-frames 100
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

FRAME_EXTS = (".png", ".jpg", ".jpeg", ".ppm")


def frame_paths(directory: str, max_frames: int) -> list:
    """The frame files of ``directory``, sorted, at most ``max_frames``."""
    names = sorted(n for n in os.listdir(directory)
                   if n.lower().endswith(FRAME_EXTS))
    return [os.path.join(directory, n) for n in names][:max_frames]


def frame_source(src: str, max_frames: int, prefetch_threads: int = 3):
    """Yield BGR float32 [H, W, 3] frames from a directory, a video file or
    a camera.  A directory goes through the native threaded prefetcher
    (``io.native.FrameStream``), or, where that library is not built,
    through ``load_image`` frame by frame."""
    if os.path.isdir(src):
        from ..io.native import FrameStream
        names = frame_paths(src, max_frames)
        try:
            stream = FrameStream(names, n_threads=prefetch_threads)
        except RuntimeError:
            stream = None
        if stream is not None:
            yield from stream
            stream.close()
        else:
            from ..io.images import load_image
            for n in names:
                yield load_image(n)
        return
    try:
        import cv2
    except ImportError:
        raise SystemExit(
            f"error: source {src!r} is not a directory; a video file or a "
            "camera needs OpenCV (cv2), which is not installed") from None
    cap = cv2.VideoCapture(int(src) if src.isdigit() else src)
    if not cap.isOpened():
        raise SystemExit(f"cannot open video source {src!r}")
    count = 0
    while count < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        yield frame.astype(np.float32)
        count += 1
    cap.release()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="streaming optical flow (webcam-loop analogue)")
    ap.add_argument("source", help="frame directory, video file, or cam index")
    ap.add_argument("--op", type=int, default=2, help="operating point 1-4")
    ap.add_argument("--out", help="write color-wheel PNGs to this directory")
    ap.add_argument("--flo", help="write .flo fields to this directory")
    ap.add_argument("--max-frames", type=int, default=10 ** 9)
    ap.add_argument("--no-fetch", action="store_true",
                    help="keep flows on the device (no per-frame copy to "
                         "the host; one sync at the end)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.no_fetch and (args.out or args.flo):
        raise SystemExit("--no-fetch cannot write per-frame outputs")

    from ..cli import resolve_device
    from ..config import operating_point, pad_to_divisible
    from ..io.color import flow_to_color
    from ..io.flo import write_flo
    from ..io.images import save_image
    from ..parallel.frame_parallel import stream_flow
    from ..utils.timing import synchronize, warmup

    device = resolve_device(args.device)
    frames = frame_source(args.source, args.max_frames)
    first = next(frames, None)
    if first is None:
        raise SystemExit("no frames")
    h, w = first.shape[:2]
    cfg = operating_point(args.op, width=w)
    pt, pb, pl, pr = pad_to_divisible(w, h, cfg.coarsest_scale)

    def padded():
        yield np.pad(first, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
        for f in frames:
            yield np.pad(f, ((pt, pb), (pl, pr), (0, 0)), mode="edge")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.flo:
        os.makedirs(args.flo, exist_ok=True)

    warmup(device)
    print(f"streaming {w}x{h} at operating point {args.op} "
          f"(cs={cfg.coarsest_scale}, fs={cfg.finest_scale})")
    t_prev = time.perf_counter()
    n = 0
    total_ms = 0.0
    last = None
    for i, flow_p in enumerate(stream_flow(padded(), cfg,
                                           fetch=not args.no_fetch,
                                           device=device)):
        if args.no_fetch:
            last = flow_p                 # on the device; no sync here
            now = time.perf_counter()
            ms = (now - t_prev) * 1e3
            t_prev = now
            n += 1
            if n > 1:
                total_ms += ms
            print(f"frame {i + 1:4d}: {ms:8.2f} ms (dispatch)", flush=True)
            continue
        flow = flow_p[pt:pt + h, pl:pl + w]
        now = time.perf_counter()
        ms = (now - t_prev) * 1e3
        t_prev = now
        n += 1
        if n > 1:           # the first pair pays the kernels' build
            total_ms += ms
        mag = np.sqrt((flow ** 2).sum(-1))
        print(f"frame {i + 1:4d}: {ms:8.2f} ms  |flow| mean "
              f"{mag.mean():6.3f} max {mag.max():6.2f}", flush=True)
        if args.out:
            save_image(os.path.join(args.out, f"flow_{i + 1:04d}.png"),
                       flow_to_color(flow)[..., ::-1])
        if args.flo:
            write_flo(os.path.join(args.flo, f"flow_{i + 1:04d}.flo"), flow)
    if args.no_fetch and last is not None:
        t0 = time.perf_counter()
        synchronize(last.device)
        last.cpu().numpy()
        print(f"final sync + fetch: {(time.perf_counter() - t0) * 1e3:.2f} ms")
    if n > 1:
        avg = total_ms / (n - 1)
        what = "dispatch-limited" if args.no_fetch else "incl. host I/O"
        print(f"{n} flows, steady-state {avg:.2f} ms/frame "
              f"({1000.0 / avg:.1f} fps {what})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
