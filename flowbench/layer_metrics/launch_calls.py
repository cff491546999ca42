"""Capture: the host's runtime calls that put work on the card (graph
launches, kernel launches, copies and memsets), a frame."""


def read(summary: dict):
    return summary["launch_calls"] / summary["frames"]
