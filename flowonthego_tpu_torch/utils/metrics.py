"""Flow evaluation metrics (Middlebury methodology), numpy only."""

from __future__ import annotations

import numpy as np

from ..io.flo import UNKNOWN_FLOW_THRESH


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def endpoint_error(flow, gt) -> np.ndarray:
    """Per-pixel endpoint error |flow - gt|_2, NaN where gt is unknown."""
    flow = _numpy(flow)
    gt = _numpy(gt)
    err = np.sqrt(((flow - gt) ** 2).sum(-1))
    unknown = (np.abs(gt) > UNKNOWN_FLOW_THRESH).any(-1) | np.isnan(gt).any(-1)
    err[unknown] = np.nan
    return err


def average_epe(flow, gt) -> float:
    """Average endpoint error over known pixels."""
    return float(np.nanmean(endpoint_error(flow, gt)))


def angular_error(flow, gt) -> np.ndarray:
    """Per-pixel angular error (degrees) in the (u, v, 1) space."""
    flow = _numpy(flow)
    gt = _numpy(gt)
    num = (flow * gt).sum(-1) + 1.0
    den = np.sqrt((flow ** 2).sum(-1) + 1.0) * np.sqrt((gt ** 2).sum(-1) + 1.0)
    return np.degrees(np.arccos(np.clip(num / den, -1.0, 1.0)))
