"""Split scenes: a frame whose left and right halves are crops of one
texture at origins of their own, so that each half follows its own
whole-pixel motion and the true flow is known but at the seam and the
borders (as ``synthetic_split_pair`` in the program's ``utils/synth.py``
makes one pair)."""

from __future__ import annotations

import numpy as np


def split_frame(tex: np.ndarray, left, right, height: int,
                width: int) -> np.ndarray:
    """[height, width, C]: columns left of the seam ``width // 2`` show
    ``tex`` at origin ``left`` = (x, y), the others at ``right``."""
    seam = width // 2
    (lx, ly), (rx, ry) = left, right
    return np.concatenate([tex[ly:ly + height, lx:lx + seam],
                           tex[ry:ry + height, rx + seam:rx + width]], axis=1)


def split_truth(height: int, width: int, s_left, s_right):
    """(flow [H, W, 2] float32, known [H, W] bool) from a split frame to the
    next, whose halves' origins moved by ``-s_left`` and ``-s_right``: a
    pixel's content moves by its half's (sx, sy); the flow is known where
    the content lands inside the frame on its own side of the seam."""
    seam = width // 2
    jj, ii = np.mgrid[0:height, 0:width]
    left = ii < seam
    s = np.where(left[..., None], np.asarray(s_left), np.asarray(s_right))
    tx, ty = ii + s[..., 0], jj + s[..., 1]
    known = (np.where(left, tx < seam, tx >= seam) & (tx >= 0) & (tx < width)
             & (ty >= 0) & (ty < height))
    return s.astype(np.float32), known


def pad_edge(frame: np.ndarray, pads) -> np.ndarray:
    """``frame`` replicate-padded by (top, bottom, left, right)."""
    pt, pb, pl, pr = pads
    return np.pad(frame, ((pt, pb), (pl, pr), (0, 0)), mode="edge")


def pad_truth(flow: np.ndarray, known: np.ndarray, pads):
    """The truth of a padded frame: zero flow, not known, on the pads."""
    pt, pb, pl, pr = pads
    return (np.pad(flow, ((pt, pb), (pl, pr), (0, 0))),
            np.pad(known, ((pt, pb), (pl, pr))))
