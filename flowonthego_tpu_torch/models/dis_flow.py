"""DIS optical flow: the coarse-to-fine orchestrator (port of
``flowonthego_tpu/models/dis_flow.py``).

    pad to 2^coarsest divisibility -> image+gradient pyramids ->
    per scale (coarse to fine):
        extract templates+Hessians -> warm start from the coarser flow ->
        inverse-search optimize (K2, or the reference form for robust
        costs) -> densify -> variational refinement (warp K5, then K3 or
        K4 by field size); with forward-backward consistency the same for
        the backward grid, merged in densify
    -> upsample the finest flow to input resolution -> crop the padding.

The pipeline runs on a batch of B frame pairs with a leading batch axis
(``dis_flow_padded``, ``dis_flow_from_pyramids``): each kernel launches
once per scale (and direction) for the whole batch, as a ``vmap`` of the
JAX pipeline adds one grid axis to each Pallas call.  The single-pair
entry points (``compute_flow``, ``compute_flow_timed``, ``DISFlow``) run
it with B = 1.

``flow_full_padded`` is the JAX package's function of that name, padded
frames in and full-resolution flow out.  There it is one compiled
program; here, on the card, it is one CUDA graph per (shape, ``cfg``,
device), recorded after the first call of a path and replayed as one
launch from then on (``utils/graphs.py``); ``batched_flow`` goes through
it, and so do ``compute_flow`` and ``DISFlow``, whose padding and crop
are part of the recorded path (``flow_padded``'s ``pads``).  On the CPU,
and inside ``graphs.eager()``, it runs the same Python eagerly.  The building blocks
(``dis_flow_padded``, ``dis_flow_from_pyramids``) always run eagerly: a
capture records them.  The pipeline functions run on the device their
input tensors lie on, and the entry points put host (numpy) inputs on the
GPU unless the caller names a device (``utils/device.py``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import DISConfig, operating_point, pad_to_divisible, pool_backend
from ..ops import densify as densify_mod
from ..ops import dis as dis_mod
from ..ops import variational as var_mod
from ..ops.patches import PatchGrid, extract_templates_and_hessians
from ..ops.pyramid import build_pyramid, pad_replicate
from ..ops.resize import resize_matmul
from ..utils import graphs, profiling
from ..utils.device import resolve_device, to_host, upload
from ..utils.timing import PhaseTimer


def pin_fp32() -> None:
    """Keep every float32 matmul and convolution in full float32 on the
    card (cuDNN convolutions default to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dis_flow_padded(I0: torch.Tensor, I1: torch.Tensor, cfg: DISConfig,
                    init_flow: Optional[torch.Tensor] = None,
                    level_offset: int = 0) -> torch.Tensor:
    """DIS on B pairs of divisibility-padded images I0, I1 [B, H, W, C]
    float32 (H, W divisible by 2**coarsest_scale).

    init_flow: optional warm start [B, H/2^(cs+1), W/2^(cs+1), 2].
    level_offset shifts the level index that sets the variational
    inner-iteration count (inner_iter = level + 1).
    Returns flows [B, H/2^fs, W/2^fs, 2] at the finest processed scale.
    """
    pin_fp32()
    if I0.dim() != 4 or I0.shape != I1.shape:
        raise ValueError(f"dis_flow_padded takes two [B, H, W, C] batches "
                         f"of one shape, got {tuple(I0.shape)} and "
                         f"{tuple(I1.shape)}")
    H, W = I0.shape[1], I0.shape[2]
    div = 2 ** cfg.coarsest_scale
    if H % div or W % div:
        raise ValueError(f"image {H}x{W} not divisible by 2^{cfg.coarsest_scale}")
    n_levels = cfg.coarsest_scale + 1
    kw = dict(start_level=cfg.finest_scale, backend=pool_backend(cfg))
    with profiling.span("pyramid"):
        pyr0 = build_pyramid(I0, n_levels, cfg.padding, **kw)
        pyr1 = build_pyramid(I1, n_levels, cfg.padding, **kw)
    return dis_flow_from_pyramids(pyr0, pyr1, cfg, init_flow=init_flow,
                                  level_offset=level_offset)


# the device spans' leaves (utils/profiling.span) of an entry call
LEAVES = ("pyramid", "pad", "warm_start", "upsample", "extract", "coarse",
          "opti", "aggregate", "var_ref", "extract_bw", "coarse_bw",
          "opti_bw", "fb_merge", "aggregate_bw", "var_ref_bw")
_SCALE_PHASES = ("extract", "coarse", "opti", "aggregate", "var_ref")
# the leaves each phase of the reference's TIME line holds: both
# directions' work, and the fb merges in the aggregation
_PHASE_LEAVES = {"extract": ("extract", "extract_bw"),
                 "coarse": ("coarse", "coarse_bw"),
                 "opti": ("opti", "opti_bw"),
                 "aggregate": ("fb_merge", "aggregate", "aggregate_bw"),
                 "var_ref": ("var_ref", "var_ref_bw")}


def dis_flow_from_pyramids(pyr0, pyr1, cfg: DISConfig,
                           init_flow: Optional[torch.Tensor] = None,
                           level_offset: int = 0,
                           timer: Optional[PhaseTimer] = None,
                           printer=print) -> torch.Tensor:
    """DIS on prebuilt pyramids of B frames each (see
    :func:`dis_flow_padded`); video streaming builds each frame's pyramid
    once and uses it for two pairs.

    Each scale is the device span ``scale <sl>`` and each of its five
    phases a leaf inside it (``utils/profiling``); with forward-backward
    consistency the backward grid's phases are leaves of their own
    (``extract_bw``, ``coarse_bw``, ``opti_bw``, ``aggregate_bw``,
    ``var_ref_bw``) and both merges one leaf, ``fb_merge``, before the
    aggregation.  Each scale counts the patches each direction solves
    (``patches_fw``, ``patches_bw``).  With a ``timer``, the leaves feed
    it (each ends with a device sync) and ``printer`` gets the
    reference's line ``TIME (Sc: %i, #p:%6i, pconst, pinit, poptim,
    cflow, tvopt, total)`` per scale, each phase the work of both
    directions (:data:`_PHASE_LEAVES`)."""
    lvl_c = pyr0[cfg.coarsest_scale]
    B = lvl_c.image.shape[0]
    H = lvl_c.image.shape[1] - 2 * cfg.padding << cfg.coarsest_scale
    W = lvl_c.image.shape[2] - 2 * cfg.padding << cfg.coarsest_scale
    span = profiling.span

    # Forward-backward consistency: the complementary I1->I0 grid is
    # optimized beside the forward one, each densification merges the
    # other's reversed flow, and the backward chain (warm-started only from
    # its own coarser flow) stops at the finest scale, where nothing reads
    # it.
    fb = cfg.use_fb_consistency

    def make_state(lvl, grid):
        templates, gx, gy, Hs = extract_templates_and_hessians(
            lvl.image, lvl.grad_x, lvl.grad_y, grid, cfg)
        return dis_mod.init_state(templates, gx, gy, Hs, grid)

    def one_scale(sl, flow, flow_bw):
        w_sl, h_sl = W >> sl, H >> sl
        grid = PatchGrid.create(cfg, w_sl, h_sl)
        lvl0, lvl1 = pyr0[sl], pyr1[sl]
        go_bw = fb and sl > cfg.finest_scale
        profiling.count("patches_fw", B * grid.n_patches)

        with span("extract"):
            state = make_state(lvl0, grid)
        with span("coarse"):
            warm = flow if flow is not None else init_flow
            if warm is not None:
                state = dis_mod.init_from_coarser(state, warm, grid)
        with span("opti"):
            state = dis_mod.optimize(state, lvl1.image, grid, cfg)
        merge = merge_bw = None
        if fb:
            profiling.count("patches_bw", B * grid.n_patches)
            with span("extract_bw"):
                state_bw = make_state(lvl1, grid)
            with span("coarse_bw"):
                if flow_bw is not None:
                    state_bw = dis_mod.init_from_coarser(state_bw, flow_bw,
                                                         grid)
            with span("opti_bw"):
                state_bw = dis_mod.optimize(state_bw, lvl0.image, grid, cfg)
            with span("fb_merge"):
                merge = densify_mod.fb_merge(state_bw, grid, cfg)
                if go_bw:
                    merge_bw = densify_mod.fb_merge(state, grid, cfg)
        with span("aggregate"):
            flow = densify_mod.densify(state, grid, cfg, merge=merge)
        if go_bw:
            with span("aggregate_bw"):
                flow_bw = densify_mod.densify(state_bw, grid, cfg,
                                              merge=merge_bw)

        if cfg.use_var_ref:
            p = cfg.padding
            im1 = lvl0.image[:, p:p + h_sl, p:p + w_sl, :]
            im2 = lvl1.image[:, p:p + h_sl, p:p + w_sl, :]
            level = sl + level_offset
            with span("var_ref"):
                flow = var_mod.variational_refine_auto(flow, im1, im2, cfg,
                                                       level)
            if go_bw:
                with span("var_ref_bw"):
                    flow_bw = var_mod.variational_refine_auto(
                        flow_bw, im2, im1, cfg, level)
        return flow, flow_bw, grid

    flow = None
    flow_bw = None
    with profiling.phases(timer):
        for sl in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
            with profiling.scale(sl):
                flow, flow_bw, grid = one_scale(sl, flow, flow_bw)
            if timer is not None:
                ms = [sum(timer.last.pop(leaf, 0.0)
                          for leaf in _PHASE_LEAVES[name])
                      for name in _SCALE_PHASES]
                printer(f"TIME (Sc: {sl}, #p:{grid.n_patches:6d}, pconst, "
                        "pinit, poptim, cflow, tvopt, total): "
                        + " ".join(f"{t:8.2f}" for t in ms)
                        + f" -> {sum(ms):8.2f} ms.")
    return flow


def upsample_flow_to_full(flow: torch.Tensor, cfg: DISConfig,
                          out_h: int, out_w: int) -> torch.Tensor:
    """Finest-level flows [..., h, w, 2] x2^fs, bilinearly resized to full
    resolution."""
    if cfg.finest_scale == 0:
        return flow
    return resize_matmul(flow * float(2 ** cfg.finest_scale), out_h, out_w)


def flow_padded(I0: torch.Tensor, I1: torch.Tensor, cfg: DISConfig,
                full_res: bool = True, pads=(0, 0, 0, 0)) -> torch.Tensor:
    """Flows of a batch of padded pairs [B, H, W, C] on the tensors'
    device: [B, H, W, 2] (``full_res``: :func:`dis_flow_padded`, then
    :func:`upsample_flow_to_full`) or the finest-scale flows.  With
    ``pads`` (top, bottom, left, right) the pairs are edge-padded by them
    first and the full-resolution flows cropped back
    (:func:`compute_flow`).  On the card one CUDA graph per (shape,
    ``cfg``, ``full_res``, ``pads``, device), see :mod:`..utils.graphs`;
    eagerly on the CPU."""
    pin_fp32()
    if I0.dim() != 4 or I0.shape != I1.shape:
        raise ValueError(f"flow_padded takes two [B, H, W, C] batches of "
                         f"one shape, got {tuple(I0.shape)} and "
                         f"{tuple(I1.shape)}")
    pads = tuple(pads)
    return graphs.run("flow_full_padded" if full_res else "dis_flow_padded",
                      lambda a, b: _flow_padded(a, b, cfg, full_res, pads),
                      (I0, I1), static=(cfg, pads))


def _flow_padded(I0, I1, cfg: DISConfig, full_res: bool,
                 pads) -> torch.Tensor:
    """:func:`flow_padded`, eagerly (what a capture records)."""
    h, w = I0.shape[1], I0.shape[2]
    if any(pads):
        with profiling.span("pad"):
            I0, I1 = pad_replicate(I0, pads), pad_replicate(I1, pads)
    flow = dis_flow_padded(I0, I1, cfg)
    if not full_res:
        return flow
    with profiling.span("upsample"):
        flow = upsample_flow_to_full(flow, cfg, I0.shape[1], I0.shape[2])
    if not any(pads):
        return flow
    with profiling.span("pad"):
        return flow[:, pads[0]:pads[0] + h, pads[2]:pads[2] + w, :]


def flow_full_padded(I0: torch.Tensor, I1: torch.Tensor,
                     cfg: DISConfig) -> torch.Tensor:
    """Full-resolution flow for an already-padded pair [H, W, C] -> [H, W,
    2], or a batch of pairs [B, H, W, C] -> [B, H, W, 2] (H, W divisible
    by 2**coarsest_scale), on the tensors' device (:func:`flow_padded`)."""
    if I0.dim() == 3:
        return flow_full_padded(I0[None], I1[None], cfg)[0]
    return flow_padded(I0, I1, cfg, full_res=True)


def validate_image_pair(I0, I1, what: str = "image") -> None:
    """Fail fast with a clear error on a malformed input pair."""
    s0, s1 = tuple(I0.shape), tuple(I1.shape)
    if len(s0) != 3:
        raise ValueError(
            f"{what} must be [H, W, C] (3-dimensional), got shape {s0}")
    if s0 != s1:
        raise ValueError(
            f"{what} pair shapes differ: {s0} vs {s1} — both frames must "
            "share height, width, and channel count")
    if s0[2] not in (1, 3):
        raise ValueError(
            f"{what} must have 1 (gray/gradmag) or 3 (RGB/BGR) channels, "
            f"got {s0[2]}")
    if s0[0] < 2 or s0[1] < 2:
        raise ValueError(f"{what} too small: {s0[0]}x{s0[1]}")


def as_image(x, device) -> torch.Tensor:
    """A numpy array or tensor as a float32 tensor on ``device`` (the
    entry points choose it with :func:`..utils.device.resolve_device`):
    the host span ``ingest`` of a traced call.  It crosses to the card,
    if it does, in its own dtype (a host array through pinned staging,
    :func:`..utils.device.upload`) and is converted there."""
    with profiling.host_span("ingest"):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return upload(x, device).float()


def compute_flow(I0, I1, cfg: Optional[DISConfig] = None, op_point: int = 2,
                 device=None) -> torch.Tensor:
    """End-to-end dense flow [H, W, 2] at input resolution.

    I0, I1: [H, W, C] images (numpy or tensors).  Pads to 2^coarsest
    divisibility by edge replication, runs the pipeline on ``device``,
    upsamples and crops back to [H, W, 2].  With ``device=None`` tensors
    run where I0 lies and numpy inputs run on the GPU; without a GPU
    that raises (:func:`..utils.device.resolve_device`), so pass
    ``device="cpu"`` to run on the CPU.
    """
    validate_image_pair(I0, I1)
    device = resolve_device(device, I0, I1)
    with profiling.call():
        I0 = as_image(I0, device)
        I1 = as_image(I1, device)
        h, w = I0.shape[0], I0.shape[1]
        if cfg is None:
            cfg = operating_point(op_point, width=w)
        pin_fp32()
        pads = pad_to_divisible(w, h, cfg.coarsest_scale)
        return flow_padded(I0[None], I1[None], cfg, pads=pads)[0]


def compute_flow_timed(I0, I1, cfg: Optional[DISConfig] = None,
                       op_point: int = 2, device=None,
                       printer=print) -> torch.Tensor:
    """Verbosity-2 diagnostic run: per-scale phase timing.

    Prints the reference's per-scale line ``TIME (Sc: %i, #p:%6i, pconst,
    pinit, poptim, cflow, tvopt, total)`` (see
    :func:`dis_flow_from_pyramids`), the pyramid and run-time lines and
    the phase totals of :meth:`..utils.timing.PhaseTimer.report`.  Each
    phase ends with a device sync, so phase costs are honest and the
    run-time line carries the syncs.  Returns :func:`compute_flow`'s flow,
    on the device :func:`compute_flow` would choose.
    """
    validate_image_pair(I0, I1)
    device = resolve_device(device, I0, I1)
    I0 = as_image(I0, device)
    I1 = as_image(I1, device)
    h, w = I0.shape[0], I0.shape[1]
    if cfg is None:
        cfg = operating_point(op_point, width=w)
    pin_fp32()
    pads = pad_to_divisible(w, h, cfg.coarsest_scale)
    I0p = pad_replicate(I0, pads)[None]
    I1p = pad_replicate(I1, pads)[None]
    timer = PhaseTimer(I0p.device)

    t_all = time.perf_counter()
    with profiling.phases(timer):
        with profiling.span("pyramid"):
            kw = dict(start_level=cfg.finest_scale, backend=pool_backend(cfg))
            pyr0 = build_pyramid(I0p, cfg.coarsest_scale + 1, cfg.padding,
                                 **kw)
            pyr1 = build_pyramid(I1p, cfg.coarsest_scale + 1, cfg.padding,
                                 **kw)
        printer(f"TIME (Pyramide+Gradients) (ms): "
                f"{timer.totals['pyramid']:.3f}")
        flow = dis_flow_from_pyramids(pyr0, pyr1, cfg, timer=timer,
                                      printer=printer)
        with profiling.span("upsample"):
            flow = upsample_flow_to_full(flow[0], cfg, I0p.shape[1],
                                         I0p.shape[2])
            pt, _, pl, _ = pads
            flow = flow[pt:pt + h, pl:pl + w, :]
    printer(f"TIME (O.Flow Run-Time   ) (ms): "
            f"{(time.perf_counter() - t_all) * 1000.0:.3f}")
    printer(timer.report())
    return flow


class DISFlow:
    """Object-style API: configure once, ``calc`` many pairs.  Holds only
    the config and the device (``None``: :func:`compute_flow`'s default,
    the GPU for numpy inputs); every call is stateless."""

    def __init__(self, cfg: Optional[DISConfig] = None, op_point: int = 2,
                 device=None):
        self.cfg = cfg
        self.op_point = op_point
        self.device = device

    def config_for(self, width: int) -> DISConfig:
        return self.cfg if self.cfg is not None else operating_point(
            self.op_point, width=width)

    def calc(self, I0, I1) -> np.ndarray:
        """Flow for one frame pair as numpy [H, W, 2]: from the card, in
        page-locked host memory while the caller keeps it, as
        :func:`..parallel.frame_parallel.stream_flow`'s fetched flows
        (``utils.device.to_host``)."""
        out = compute_flow(I0, I1, cfg=self.cfg, op_point=self.op_point,
                           device=self.device)
        return to_host(out)
