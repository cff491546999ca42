"""Render a .flo file to a colour-wheel image (port of the JAX package's
``tools/color_flow.py``):

    python -m flowonthego_tpu_torch.tools.color_flow in.flo out.png [max_motion]

A .ppm output needs no Pillow; other formats do.
"""

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 2
    from ..io.flo import read_flo
    from ..io.images import save_image
    from ..io.native import flow_to_color_native

    flow = read_flo(argv[0])
    max_motion = float(argv[2]) if len(argv) > 2 else 0.0
    rgb = flow_to_color_native(flow, max_motion)
    save_image(argv[1], rgb[..., ::-1])  # save_image takes BGR
    print(f"{argv[0]} ({flow.shape[1]}x{flow.shape[0]}) -> {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
