"""The command line: ``python -m flowonthego_tpu_torch img1 img2 out.flo [...]``.

The argument surface of ``python -m flowonthego_tpu``:

    flow img1 img2 out.flo                 # operating point 2
    flow img1 img2 out.flo <op_point>      # 1..4
    flow img1 img2 out.flo <coarsest> <finest> <gd_iter> <patch_size>
         <patch_stride> <use_mean_norm> <use_var_ref> <alpha> <gamma>
         <delta> <var_iter> <sor_omega> <verbosity>

Output: Middlebury .flo at the input resolution.  ``--viz out.ppm``
additionally writes the color-wheel visualization.  Verbosity 2 prints
per-scale phase timing lines.

``--mode depth`` switches to 1-D stereo disparity and writes a PFM file
(img1 = left, img2 = right; ``--cam 1`` for the mirrored pair).
``--channels rgb|gray|gradmag`` selects the input channels.
``--min-iter N``: past N iterations the dp/dr convergence clauses may stop
a patch before <gd_iter> trips.  ``--fb`` enables forward-backward
consistency; ``--cost l2|l1|huber`` selects the patch cost;
``--densify-weight squared|abs`` the aggregation weighting.

``--device cuda|cpu`` (default cuda) is where the pipeline runs; with
``cuda`` and no usable GPU the command stops with an error instead of
running on the CPU.  Binary PPM/PGM frames need no Pillow; other image
formats do.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from .config import DISConfig, operating_point
from .io.color import flow_to_color
from .io.flo import write_flo
from .io.images import load_image, save_image
from .io.pfm import write_pfm
from .models.dis_flow import as_image, compute_flow, compute_flow_timed
from .models.stereo import compute_disparity
from .ops.channels import prepare_input
from .utils import graphs
from .utils.timing import warmup


def _exit_2(msg: str = "", usage: bool = True):
    if msg:
        print(f"error: {msg}\n")
    if usage:
        print(__doc__)
    sys.exit(2)


def _pop_flag(argv, name, has_value=True, default=None):
    if name not in argv:
        return argv, default
    i = argv.index(name)
    if has_value:
        if i + 1 >= len(argv):
            _exit_2(f"{name} requires a value")
        return argv[:i] + argv[i + 2:], argv[i + 1]
    return argv[:i] + argv[i + 1:], True


@dataclasses.dataclass(frozen=True)
class Command:
    """One parsed command line.  The config needs the image width (the
    operating points pick their scales by it), so it is built by
    :meth:`config` once the first frame is loaded."""
    img1: str
    img2: str
    out: str
    params: tuple = ()          # () / (op_point,) / the 13-param form
    overrides: dict = dataclasses.field(default_factory=dict)
    viz: Optional[str] = None
    mode: str = "flow"
    cam: int = 0
    channels: str = "rgb"
    device: str = "cuda"

    @property
    def verbosity(self) -> int:
        return int(self.params[12]) if len(self.params) > 12 else 1

    def config(self, width: int) -> DISConfig:
        vals = self.params
        if len(vals) <= 1:
            cfg = operating_point(int(vals[0]) if vals else 2, width=width)
        else:
            cfg = DISConfig(
                coarsest_scale=int(vals[0]),
                finest_scale=int(vals[1]),
                grad_descent_iter=int(vals[2]),
                patch_size=int(vals[3]),
                patch_stride=float(vals[4]),
                use_mean_normalization=bool(int(vals[5])),
                use_var_ref=bool(int(vals[6])),
                var_ref_alpha=float(vals[7]),
                var_ref_gamma=float(vals[8]),
                var_ref_delta=float(vals[9]),
                var_ref_iter=int(vals[10]),
                var_ref_sor_weight=float(vals[11]),
            )
        return dataclasses.replace(cfg, **self.overrides)


def parse_command(argv) -> Command:
    """Parse an argument list (without the program name); a bad flag value
    or argument count exits with status 2."""
    argv = list(argv)
    argv, viz = _pop_flag(argv, "--viz")
    argv, mode = _pop_flag(argv, "--mode", default="flow")
    argv, cam = _pop_flag(argv, "--cam", default="0")
    argv, channels = _pop_flag(argv, "--channels", default="rgb")
    argv, min_iter = _pop_flag(argv, "--min-iter")
    argv, use_fb = _pop_flag(argv, "--fb", has_value=False, default=False)
    argv, cost_fn = _pop_flag(argv, "--cost")
    argv, densify_w = _pop_flag(argv, "--densify-weight")
    argv, device = _pop_flag(argv, "--device", default="cuda")
    if cost_fn is not None and cost_fn not in ("l2", "l1", "huber"):
        _exit_2(f"--cost must be l2|l1|huber, got {cost_fn}", usage=False)
    if densify_w is not None and densify_w not in ("squared", "abs"):
        _exit_2(f"--densify-weight must be squared|abs, got {densify_w}",
                usage=False)
    if len(argv) < 3:
        _exit_2()
    params = tuple(argv[3:])
    if 1 < len(params) < 12:
        _exit_2(f"the parameter form takes 12 or 13 values, got "
                f"{len(params)}")

    overrides = {}
    if min_iter is not None:
        overrides["min_iter"] = int(min_iter)
    if use_fb:
        overrides["use_fb_consistency"] = True
    if cost_fn is not None:
        overrides["cost_fn"] = cost_fn
    if densify_w is not None:
        overrides["densify_weight"] = densify_w
    return Command(img1=argv[0], img2=argv[1], out=argv[2], params=params,
                   overrides=overrides, viz=viz, mode=mode, cam=int(cam),
                   channels=channels, device=device)


def resolve_device(name: str) -> torch.device:
    """``name`` as a torch device; exits with status 2 when it is a CUDA
    device and no GPU is usable (never runs quietly on the CPU)."""
    try:
        dev = torch.device(name)
    except RuntimeError:
        print(f"error: unknown --device {name!r} (expected cuda or cpu)",
              file=sys.stderr)
        sys.exit(2)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {name} needs a CUDA GPU, but "
              "torch.cuda.is_available() is false; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        sys.exit(2)
    return dev


def run(cmd: Command) -> int:
    """Load the pair, compute flow (or disparity) on ``cmd.device`` and
    write the outputs; prints the TIME and summary lines."""
    dev = resolve_device(cmd.device)
    t0 = time.perf_counter()
    I0 = as_image(load_image(cmd.img1), dev)
    I1 = as_image(load_image(cmd.img2), dev)
    cfg = cmd.config(I0.shape[1])
    if cmd.channels != "rgb":
        I0 = prepare_input(I0, cmd.channels)
        I1 = prepare_input(I1, cmd.channels)

    verbosity = cmd.verbosity
    if verbosity > 1:
        print(f"TIME (Image loading) (ms): "
              f"{(time.perf_counter() - t0) * 1e3:.3g}")
        print(f"config: {cfg}")

    warmup(dev)
    t1 = time.perf_counter()
    if cmd.mode == "depth":
        cfg_d = dataclasses.replace(cfg, use_var_ref=False)
        with graphs.eager():        # one pair a process: see graphs.ENTRIES
            disp = compute_disparity(I0, I1, cfg=cfg_d,
                                     cam_lr=cmd.cam).cpu().numpy()
        if verbosity > 0:
            print(f"TIME (Depth Run-Time incl. compile) (ms): "
                  f"{(time.perf_counter() - t1) * 1e3:.3g}")
        write_pfm(cmd.out, disp)
        print(f"disparity {disp.shape[1]}x{disp.shape[0]} -> {cmd.out}")
        return 0
    if verbosity > 1:
        flow = compute_flow_timed(I0, I1, cfg=cfg)
    else:
        with graphs.eager():        # one pair a process: see graphs.ENTRIES
            flow = compute_flow(I0, I1, cfg=cfg)
    flow = flow.cpu().numpy()
    if verbosity > 0:
        print(f"TIME (O.Flow Run-Time incl. compile) (ms): "
              f"{(time.perf_counter() - t1) * 1e3:.3g}")

    write_flo(cmd.out, flow)
    if cmd.viz:
        save_image(cmd.viz, flow_to_color(flow)[..., ::-1])  # RGB -> BGR
    if verbosity > 0:
        mag = np.sqrt((flow ** 2).sum(-1))
        print(f"flow {flow.shape[1]}x{flow.shape[0]}  "
              f"|flow| mean {mag.mean():.3f} max {mag.max():.3f}  "
              f"-> {cmd.out}")
    return 0


def main(argv=None) -> int:
    return run(parse_command(sys.argv[1:] if argv is None else argv))
