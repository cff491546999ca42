"""Densify: the share of its roofline that G5, the fb merge, reaches, in
percent.  Its least time a frame (``yardstick/fb_bounds``: each merge of
each scale, on the patches merged and the (pixel, corner) contributions
that landed) over its device ms a frame (the categories ``G5 fb merge
bins`` and ``G5 fb merge cells``).  The merges are counted by the fb
judge's reference (``reference/fb.py``: the readings' ``counts.merge``)
on the frames it computed in this run, a sample of the window's pairs of
the same motion law on the same texture as the traced frames."""

from ..yardstick import fb_bounds

CATEGORIES = ("G5 fb merge bins", "G5 fb merge cells")


def read(summary: dict):
    merges = getattr(summary.get("counts"), "merge", None)
    dev = summary["device_s"]
    spent = sum(dev.get(c, 0.0) for c in CATEGORIES)
    if not merges or not spent:
        return None
    H, W, C = summary["shape"]
    ps, n = summary["params"]["patch_size"], summary["frames_counted"]
    least_ms = 0.0
    for sl, (n_merges, patches, landed) in merges.items():
        each = fb_bounds.fb_merge_bound(1, patches // n_merges, ps, C,
                                        H >> int(sl), W >> int(sl),
                                        landed / n_merges)
        least_ms += each.bound_ms * n_merges / n
    spent_ms = 1e3 * spent / summary["frames"]
    return 100.0 * least_ms / spent_ms
