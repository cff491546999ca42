"""Device: the share of the traced window in which no device event runs,
in percent (the union of the events' intervals, so overlaps count
once)."""


def read(summary: dict):
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
