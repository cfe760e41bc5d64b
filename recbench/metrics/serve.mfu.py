"""The whole request path's share of the chip's peak: the least time of
the window's requests (as ``crossbar_roofline`` counts it) over the
window's wall time (host clock)."""


def read(run):
    least = run["least_time_s"]
    return least / run["window_s"] * 100 if least and run["trace"] is not None else None
