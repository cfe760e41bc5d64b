"""The 95th percentile of every request's latency in the window, from its
issue to its results complete on the device (host clock), by linear
interpolation between order statistics (numpy's default).  A failed
request counts as missing: where the percentile reaches one, there is no
reading."""

import math

import numpy as np


def read(run):
    lat = np.sort(np.asarray(run["latencies_s"], dtype=np.float64))
    if not lat.size:
        return None
    pos = 0.95 * (lat.size - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    if not math.isfinite(lat[hi]):
        return None
    return float(lat[lo] + (lat[hi] - lat[lo]) * (pos - lo)) * 1e3
