from .color import compute_color, flow_to_color, make_color_wheel
from .flo import (TAG_FLOAT, UNKNOWN_FLOW_THRESH, read_flo, unknown_flow_mask,
                  write_flo)
from .images import load_image, save_image
from .native import (FrameStream, ensure_built, flow_to_color_native,
                     get_lib, load_image_native, read_flo_native,
                     write_flo_native)
from .pfm import read_pfm, write_pfm

__all__ = [
    "read_flo", "write_flo", "unknown_flow_mask", "TAG_FLOAT",
    "UNKNOWN_FLOW_THRESH", "load_image", "save_image", "flow_to_color",
    "make_color_wheel", "compute_color", "read_pfm", "write_pfm",
    "FrameStream", "ensure_built", "get_lib", "read_flo_native",
    "write_flo_native", "load_image_native", "flow_to_color_native",
]
