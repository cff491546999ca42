"""Compare two .flo files, average endpoint and angular error (port of
the JAX package's ``tools/flow_eval.py``):

    python -m flowonthego_tpu_torch.tools.flow_eval computed.flo reference.flo
"""

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 2
    import numpy as np

    from ..io.flo import read_flo
    from ..utils.metrics import angular_error, endpoint_error

    flow = read_flo(argv[0])
    gt = read_flo(argv[1])
    if flow.shape != gt.shape:
        print(f"size mismatch: {flow.shape} vs {gt.shape}")
        return 1
    epe = endpoint_error(flow, gt)
    ang = angular_error(flow, gt)
    gt_mag = np.sqrt((gt ** 2).sum(-1))
    print(f"avg EPE        : {np.nanmean(epe):.4f} px")
    print(f"EPE p50 / p90  : {np.nanpercentile(epe, 50):.4f} / "
          f"{np.nanpercentile(epe, 90):.4f} px")
    print(f"avg AE         : {np.nanmean(ang):.3f} deg")
    print(f"normalized EPE : {100 * np.nanmean(epe) / max(gt_mag.mean(), 1e-9):.2f}%"
          f"  (mean |gt| = {gt_mag.mean():.3f} px)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
