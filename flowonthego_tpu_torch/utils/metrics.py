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
