"""The plain reference of the served reductions, and the comparison that
decides ``correct``.

The reference is a gather and a sum: for every served bag, the sum of its
rows of the logical table, in float64, with plain PyTorch operations.  It
takes the tables and the bags that the harness made and handed to the
server, and nothing that the server derived from them.  It imports
nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: requests compared at a time, so that the gathered rows stay small
BLOCK_REQUESTS = 64


def reduce_bags(table: torch.Tensor, bags: list[np.ndarray]) -> torch.Tensor:
    """``(len(bags), dim)`` float64 sums of each bag's distinct rows."""
    device = table.device
    bags = [np.unique(b) for b in bags]
    lens = torch.tensor([b.size for b in bags], dtype=torch.int64, device=device)
    ids = torch.from_numpy(np.concatenate(bags).astype(np.int64)).to(device)
    owner = torch.repeat_interleave(torch.arange(len(bags), device=device), lens)
    out = torch.zeros((len(bags), table.shape[1]), dtype=torch.float64, device=device)
    out.index_add_(0, owner, table.index_select(0, ids).to(torch.float64))
    return out


def served_ok(output, request: dict, width: int) -> bool:
    """Whether a request's output holds one ``(bags, width)`` row block for
    each of its tables."""
    if not isinstance(output, dict):
        return False
    for name, bags in request.items():
        got = output.get(name)
        if not isinstance(got, torch.Tensor) or tuple(got.shape) != (len(bags), width):
            return False
    return True


def compare(tables: dict[str, torch.Tensor], requests: list[dict], outputs: list,
            width: int) -> dict[str, float]:
    """Holds every served row against the reference.

    ``tables`` maps each name to its logical ``(rows, dim)`` table,
    ``requests[i]`` and ``outputs[i]`` are the i-th request and what the
    server returned for it (``None`` when it raised), and ``width`` is the
    served row width (``dim`` plus zero padding).  Returns the readings:

    * ``failed_requests``: requests that raised or whose output lacks a
      table or has the wrong shape;
    * ``max_abs_err``: the largest gap between a served value and the
      reference's, over every row of every request that did not fail;
    * ``pad_nonzero``: served values in the padding columns that are not 0.
    """
    ok = [served_ok(o, r, width) for o, r in zip(outputs, requests)]
    err, pad = 0.0, 0
    for name, table in tables.items():
        dim = table.shape[1]
        for start in range(0, len(requests), BLOCK_REQUESTS):
            idx = [i for i in range(start, min(start + BLOCK_REQUESTS, len(requests))) if ok[i]]
            if not idx:
                continue
            bags = [b for i in idx for b in requests[i][name]]
            got = torch.cat([outputs[i][name] for i in idx]).to(table.device)
            want = reduce_bags(table, bags)
            gap = (got[:, :dim].to(torch.float64) - want).abs().max()
            # a NaN compares false with everything: count it as no bound
            err = max(err, float(gap) if torch.isfinite(gap) else math.inf)
            pad += int(torch.count_nonzero(got[:, dim:]))
    return {"failed_requests": float(len(ok) - sum(ok)), "max_abs_err": err,
            "pad_nonzero": float(pad)}


def judge(readings: dict[str, float], limits: dict[str, float]) -> bool:
    """True when every reading is at or under its limit."""
    return all(readings[k] <= limits[k] for k in limits)
