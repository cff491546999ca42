"""Device events by kind, and the layer each kind belongs to.

``CATEGORIES`` is a frozen copy of ``CATEGORIES`` in
``flowonthego_tpu_torch/profile_paths.py`` at commit 5c83323 (each
fragment, its row, the first match wins), with the copies split by
direction: a host transfer (HtoD, DtoH) is the host I/O layer's, a copy
on the device is glue.  ``LAYERS`` maps each category to the per-layer
metric that counts it; a kernel no fragment names is one of the small
PyTorch kernels (``torch kernels``).  ``LAUNCH_CALLS`` are the host's
runtime calls that put work on the device (``chip_smoke.LAUNCH_CALLS``
at the same commit), and ``THROW_AWAY`` the kernels a profile spends
before what it measures (``chip_smoke.THROW_AWAY``).
"""

from __future__ import annotations

CATEGORIES = (("dis_gn_kernel", "K2 gn"),
              ("fb_merge_warp_kernel", "G5 fb merge cells"),   # not K5
              ("varref_cluster_kernel", "K4 cluster"),
              ("varref_tiled_kernel", "K4 grid"),
              ("varref_kernel", "K3"), ("warp_kernel", "K5 warp"),
              ("pool2x2_kernel", "K1 pool"),
              ("glue_level_kernel", "G1 level"),
              ("glue_extract_kernel", "G2 extract"),
              ("glue_densify_kernel", "G3 densify"),
              ("glue_derivs_kernel", "G4 derivs"),
              ("fb_merge_bin", "G5 fb merge bins"),
              ("fb_merge_kernel", "G5 fb merge cells"),
              ("dis_ref_1d_kernel", "G6 dis_ref 1-D"),
              ("dis_ref_kernel", "G6 dis_ref"),
              ("Memcpy HtoD", "copy HtoD"), ("Memcpy DtoH", "copy DtoH"),
              ("Memcpy", "copy DtoD"),
              ("memcpy", "copy DtoD"),     # CUDA's own copy kernels
              ("Memset", "memset"), ("gemm", "GEMM"),
              ("indexing_backward_kernel", "index_put sort+sum"),
              ("RadixSort", "index_put sort+sum"))

TORCH_KERNELS = "torch kernels"

LAYERS = {
    "transfer_ms": ("copy HtoD", "copy DtoH"),
    "pyramid_ms": ("K1 pool", "G1 level"),
    "patch_solve_ms": ("G2 extract", "K2 gn", "G6 dis_ref",
                       "G6 dis_ref 1-D"),
    "densify_ms": ("G3 densify", "G5 fb merge bins", "G5 fb merge cells"),
    "varref_ms": ("K3", "K4 cluster", "K4 grid", "K5 warp", "G4 derivs"),
    "upsample_ms": ("GEMM",),
    "torch_kernels_ms": (TORCH_KERNELS, "copy DtoD", "memset",
                         "index_put sort+sum"),
}

LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                "cudaGraphLaunch")
THROW_AWAY = 32


def category(name: str) -> str:
    """The category of a device event's name."""
    for frag, cat in CATEGORIES:
        if frag in name:
            return cat
    return TORCH_KERNELS


def layer_ms(summary: dict, metric: str):
    """Device ms a frame of the categories ``LAYERS[metric]`` counts in a
    traced summary, or None where none of them ran."""
    cats = [c for c in LAYERS[metric] if c in summary["device_s"]]
    if not cats:
        return None
    return 1e3 * sum(summary["device_s"][c] for c in cats) / summary["frames"]
