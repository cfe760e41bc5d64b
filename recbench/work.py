"""The work a request needs, counted from its queries and widths alone.

Nothing here reads what the program made of the queries (its grouping,
replicas, tiles or bitmaps), so a change to the plan or the compile does
not move the yardstick.  A request reduces, in every table, each of its
bags to one row of ``dim`` values.  The least it needs:

* bytes: each distinct row it looks up read once (``dim`` values), each
  looked-up id read once (4 bytes: an int32 holds every row id of these
  tables), each output row written once;
* operations: one add a looked-up value.

Its least time on the card is the larger of bytes over the memory
bandwidth and operations over the compute peak.
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "flops_per_s": {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12},
}
ID_BYTES = 4
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def request_work(request: dict[str, list[np.ndarray]], dim: int, dtype: str) -> tuple[int, int]:
    """``(bytes, operations)`` one request needs."""
    width = DTYPE_BYTES[dtype]
    nbytes = ops = 0
    for bags in request.values():
        ids = np.concatenate(bags) if bags else np.empty(0, dtype=np.int64)
        distinct = np.unique(ids).size
        nbytes += distinct * dim * width + ids.size * ID_BYTES + len(bags) * dim * width
        ops += ids.size * dim
    return nbytes, ops


def least_time_s(nbytes: int, ops: int, dtype: str) -> float:
    """The least time of ``nbytes`` and ``ops`` on one H100."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops / PEAKS["flops_per_s"][dtype])
