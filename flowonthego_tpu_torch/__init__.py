"""flowonthego_tpu_torch — the DIS dense optical-flow engine in PyTorch.

A port of ``flowonthego_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100:
the same module names and tensor layouts, plain PyTorch for tensor code,
and hand-written CUDA kernels (``csrc/``, built with ``nvcc`` for
``sm_90a`` at first use) in place of the TPU package's Pallas kernels.
A CUDA tensor goes through the kernels; a CPU tensor through their plain
PyTorch versions.  This package never imports JAX.
"""

from .config import DISConfig, auto_coarsest_scale, operating_point, pad_to_divisible
from .io import (FrameStream, flow_to_color, flow_to_color_native,
                 load_image, load_image_native, read_flo, read_flo_native,
                 read_pfm, save_image, unknown_flow_mask, write_flo,
                 write_flo_native, write_pfm)
from .models.dis_flow import (DISFlow, compute_flow, compute_flow_timed,
                              dis_flow_padded, flow_full_padded)
from .models.stereo import compute_disparity
from .ops.channels import prepare_input
from .parallel import (MultiStream, batched_flow, make_data_parallel_flow,
                       make_mesh, stream_flow, stream_video_chunks)
from .utils import graphs
from .utils.metrics import angular_error, average_epe, endpoint_error
from .utils.profiling import annotate, device_memory_stats, trace

__all__ = [
    "DISConfig", "operating_point", "auto_coarsest_scale", "pad_to_divisible",
    "DISFlow", "compute_flow", "compute_flow_timed", "dis_flow_padded",
    "flow_full_padded",
    "stream_flow", "batched_flow", "MultiStream", "stream_video_chunks",
    "make_data_parallel_flow", "make_mesh", "graphs",
    "trace", "annotate", "device_memory_stats",
    "FrameStream", "read_flo_native", "write_flo_native",
    "load_image_native", "flow_to_color_native",
    "compute_disparity", "prepare_input",
    "read_flo", "write_flo", "read_pfm", "write_pfm", "load_image",
    "save_image", "flow_to_color", "unknown_flow_mask", "average_epe",
    "endpoint_error", "angular_error",
]
