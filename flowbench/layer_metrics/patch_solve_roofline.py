"""Patch solve: the share of their roofline that G2 and K2 reach, in
percent.  Their least time a frame (``yardstick/bounds``: G2 on each
scale's padded level, K2 with the inverse-search steps the patches take)
over their device ms a frame.  The steps are counted by the plain
reference on the frames it computed in this run (a sample of the
window's pairs): the work a frame of these inputs needs, the same
motion law on the same texture as the traced frames."""

from ..yardstick import bounds


def read(summary: dict):
    counts, p = summary.get("counts"), summary["params"]
    dev = summary["device_s"]
    if not counts or "K2 gn" not in dev or "G2 extract" not in dev:
        return None
    H, W, C = summary["shape"]
    ps, n = p["patch_size"], summary["frames_counted"]
    least_ms = 0.0
    for sl, (patches, started, steps) in counts.items():
        Hp, Wp = (H >> int(sl)) + 2 * ps, (W >> int(sl)) + 2 * ps
        P = patches // n
        least_ms += bounds.gn_bound(1, P, ps, C, Hp, Wp,
                                    p["grad_descent_iter"],
                                    patch_iters=steps / n,
                                    n_started=started / n).bound_ms
        least_ms += bounds.extract_bound(1, Hp, Wp, C, P, ps).bound_ms
    spent_ms = 1e3 * (dev["K2 gn"] + dev["G2 extract"]) / summary["frames"]
    return 100.0 * least_ms / spent_ms
