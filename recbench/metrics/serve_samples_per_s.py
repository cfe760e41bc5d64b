"""Samples whose reductions completed in every table, over the whole
window: from the first request's issue to the last one's results complete
on the device (host clock)."""


def read(run):
    return run["samples"] / run["window_s"] if run["samples"] else None
