"""Configuration of the DIS optical-flow engine (PyTorch port).

A copy in substance of ``flowonthego_tpu/config.py``: the same frozen
dataclass, field for field, so a config can move between the two packages
as ``dataclasses.asdict`` (see :mod:`.convert`).  It is copied rather than
imported because importing ``flowonthego_tpu`` pulls in JAX.

Backend fields keep the JAX vocabulary.  ``gn_backend`` and
``varref_backend`` each take ``"auto"`` (the hand-written CUDA kernel for
a CUDA tensor, the plain PyTorch version for a CPU tensor), ``"xla"``
(always the plain version) or ``"pallas"`` (always the kernel; raises on a
CPU tensor).  A config with both set to ``"xla"`` runs the plain version
everywhere, the pyramid pool included (:func:`pool_backend`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


def auto_coarsest_scale(width: int, patch_size: int, f_ratio: int = 5) -> int:
    """Auto-select the coarsest pyramid scale.

    ``floor(log2(2*width / (f_ratio * patch_size)))``, clamped at 0;
    ``1/f_ratio * width`` is the maximum expected motion magnitude.
    """
    scale = (2.0 * float(width)) / (float(f_ratio) * float(patch_size))
    return max(0, int(math.floor(math.log2(scale))))


@dataclasses.dataclass(frozen=True)
class DISConfig:
    """Static parameters of the DIS pipeline.

    Defaults correspond to operating point 2 with the scale range left to
    :func:`operating_point` / :meth:`with_auto_scales` to fill in.
    """

    patch_size: int = 8
    patch_stride: float = 0.4
    coarsest_scale: int = 5
    finest_scale: int = 3
    grad_descent_iter: int = 12
    use_mean_normalization: bool = True
    use_var_ref: bool = True
    var_ref_iter: int = 3          # SOR iterations per inner fixed-point iter
    var_ref_alpha: float = 10.0    # smoothness weight
    var_ref_gamma: float = 10.0    # gradient-constancy weight
    var_ref_delta: float = 5.0     # color-constancy weight
    var_ref_sor_weight: float = 1.6  # SOR over-relaxation omega

    # Termination thresholds.  With res_thresh == 0 and min_iter ==
    # grad_descent_iter the Gauss-Newton loop runs a fixed number of trips.
    dp_thresh: float = 0.05 * 0.05
    dr_thresh: float = 0.95
    res_thresh: float = 0.0
    min_iter: "Optional[int]" = None

    min_errval: float = 2.0
    norm_outlier: float = 5.0    # pseudo-Huber width b

    cost_fn: str = "l2"
    densify_weight: str = "squared"
    dtype: str = "float32"

    varref_backend: str = "auto"
    gn_backend: str = "auto"

    use_fb_consistency: bool = False

    def __post_init__(self):
        if self.patch_size % 2 != 0:
            raise ValueError("patch_size must be even")
        if not (0.0 < self.patch_stride < 1.0):
            raise ValueError("patch_stride must be in (0, 1)")
        if self.finest_scale > self.coarsest_scale:
            raise ValueError("finest_scale must be <= coarsest_scale")
        if self.finest_scale < 0:
            raise ValueError("finest_scale must be >= 0")

    @property
    def steps(self) -> int:
        """Distance in px between patch centers."""
        return max(1, int(math.floor(self.patch_size * (1.0 - self.patch_stride))))

    @property
    def n_vals(self) -> int:
        """Values per RGB patch (3 * ps^2)."""
        return 3 * self.patch_size * self.patch_size

    @property
    def n_scales(self) -> int:
        return self.coarsest_scale - self.finest_scale + 1

    @property
    def outlier_thresh(self) -> float:
        """Displacement (px) beyond which a patch resets to its init flow."""
        return float(self.patch_size) / 2.0

    @property
    def padding(self) -> int:
        """Image padding on all sides: replicate for images, zero for
        gradients."""
        return self.patch_size

    def with_auto_scales(self, width: int, f_ratio: int = 5,
                         depth: Optional[int] = None) -> "DISConfig":
        """Return a config whose scale range is auto-selected for ``width``;
        ``depth`` is the number of scales below the coarsest."""
        if depth is None:
            depth = self.coarsest_scale - self.finest_scale
        coarsest = auto_coarsest_scale(width, self.patch_size, f_ratio)
        finest = max(coarsest - depth, 0)
        return dataclasses.replace(self, coarsest_scale=coarsest,
                                   finest_scale=finest)


def operating_point(op_point: int, width: Optional[int] = None,
                    f_ratio: int = 5) -> DISConfig:
    """The four published operating points.  If ``width`` is given, the
    scale range is auto-selected for that image width."""
    if op_point == 1:
        cfg = DISConfig(patch_size=8, patch_stride=0.3, grad_descent_iter=16,
                        use_var_ref=False)
        depth = 2
    elif op_point == 2:
        cfg = DISConfig(patch_size=8, patch_stride=0.4, grad_descent_iter=12,
                        use_var_ref=True)
        depth = 2
    elif op_point == 3:
        cfg = DISConfig(patch_size=12, patch_stride=0.75, grad_descent_iter=16,
                        use_var_ref=True)
        depth = 4
    elif op_point == 4:
        cfg = DISConfig(patch_size=12, patch_stride=0.75, grad_descent_iter=128,
                        use_var_ref=True)
        depth = 5
    else:
        raise ValueError(f"unknown operating point {op_point} (expected 1-4)")

    if width is not None:
        cfg = cfg.with_auto_scales(width, f_ratio=f_ratio, depth=depth)
    else:
        cfg = dataclasses.replace(
            cfg, coarsest_scale=5, finest_scale=max(5 - depth, 0))
    return cfg


def pad_to_divisible(width: int, height: int, coarsest_scale: int):
    """Padding so width/height divide evenly down the pyramid: a multiple
    of ``2**coarsest_scale``, split floor/ceil between the two sides.
    Returns ``(pad_top, pad_bottom, pad_left, pad_right)``."""
    max_scale = 2 ** coarsest_scale
    padw = (-width) % max_scale
    padh = (-height) % max_scale
    return (padh // 2, padh - padh // 2, padw // 2, padw - padw // 2)


def pool_backend(cfg: DISConfig) -> str:
    """Backend of the pyramid pool: the plain version when the config asks
    for the plain version of both other kernels, else by device."""
    if cfg.gn_backend == "xla" and cfg.varref_backend == "xla":
        return "xla"
    return "auto"


def use_kernel(backend: str, x) -> bool:
    """Resolve a backend field for tensor ``x``.

    ``"auto"``: the kernel for a CUDA tensor, the plain version otherwise.
    ``"xla"``: the plain version.  ``"pallas"``: the kernel, which raises
    on a CPU tensor rather than quietly running the plain version.
    """
    return use_kernel_on(backend, x.device.type)


def use_kernel_on(backend: str, device_type: str) -> bool:
    """:func:`use_kernel` for a tensor on a device of ``device_type``."""
    if backend == "auto":
        return device_type == "cuda"
    if backend == "xla":
        return False
    if backend == "pallas":
        if device_type != "cuda":
            raise ValueError("backend 'pallas' selects the CUDA kernel, but "
                             f"the tensor lies on a {device_type} device")
        return True
    raise ValueError(f"unknown backend {backend!r} "
                     "(expected 'auto', 'xla' or 'pallas')")
