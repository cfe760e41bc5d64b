"""Energy-aware dynamic switching (ReCross §III-D).

The dynamic-switch ADC decides per crossbar activation, from a popcount of
the wordline bitmap, whether to run the cheap READ path (one active row —
no MAC needed, low-resolution conversion) or the full MAC path.

Here that decision is expressed three ways, all sharing one predicate:

  * :func:`popcount` / :func:`select_mode` — the host/NumPy oracle used by
    the simulator and benchmarks;
  * :func:`torch_select_mode` — the torch form, for tensors on any device;
  * the same predicate is inlined in the CUDA kernel
    (``repro_torch/kernels/csrc/crossbar_reduce.cu``) where it picks a
    single-row read instead of the tile MAC.

The energy trade-off is *runtime* information: the decision threshold can
be generalized beyond popcount==1 via :func:`energy_breakeven_rows`, which
computes when a sequence of READs stops being cheaper than one MAC (with
the paper's constants the breakeven is at 2 rows, i.e. the paper's
popcount==1 rule is exactly the energy-optimal threshold).

A copy of ``repro.core.dynamic_switch`` (NumPy, with a torch twin of
``jnp_select_mode``); the port never imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.energy import ReRAMCostModel, DEFAULT_RERAM

READ_MODE = 0
MAC_MODE = 1


def popcount(bitmap: np.ndarray) -> np.ndarray:
    """Number of activated wordlines per tile. bitmap: (..., tile_rows)."""
    return np.asarray(bitmap, dtype=np.int32).sum(axis=-1)


def select_mode(counts: np.ndarray, *, threshold: int = 1) -> np.ndarray:
    """READ_MODE where popcount <= threshold (and > 0), else MAC_MODE.

    counts == 0 tiles are not activated at all; they are reported as
    READ_MODE but charged nothing by the simulator.
    """
    counts = np.asarray(counts)
    return np.where(counts > threshold, MAC_MODE, READ_MODE).astype(np.int8)


def torch_select_mode(counts: torch.Tensor, *, threshold: int = 1) -> torch.Tensor:
    """torch twin of :func:`select_mode`: ``torch.int8`` on the device of
    ``counts``."""
    return torch.where(counts > threshold, MAC_MODE, READ_MODE).to(torch.int8)


def energy_breakeven_rows(model: ReRAMCostModel = DEFAULT_RERAM) -> int:
    """Smallest row count for which one MAC beats serialized READs on energy.

    The dynamic switch takes the READ path while
    ``rows * E_read < E_mac(rows)``.  The paper switches at popcount==1;
    with the flash-ADC energy model the actual energy breakeven is *higher*
    (≈9 rows: one full 6-bit conversion costs ~8.6× a 3-bit read) — i.e.
    an extended "multi-read" policy (serialize 2..breakeven-1 rows through
    the low-res path) saves further energy at a latency cost.  This
    beyond-paper observation is evaluated in benchmarks and §Perf.
    """
    for rows in range(1, model.rows + 1):
        _, e_mac = model.crossbar_mac_event(rows)
        _, e_read = model.crossbar_read_event()
        if rows * e_read >= e_mac:
            return rows
    return model.rows + 1


def mode_statistics(counts: np.ndarray, *, threshold: int = 1) -> dict:
    """Activation-mix stats (paper Fig. 6): share of single-row activations."""
    counts = np.asarray(counts)
    active = counts[counts > 0]
    if active.size == 0:
        return {"activations": 0, "read_fraction": 0.0, "mac_fraction": 0.0,
                "mean_active_rows": 0.0}
    read = int((active <= threshold).sum())
    return {
        "activations": int(active.size),
        "read_fraction": read / active.size,
        "mac_fraction": 1.0 - read / active.size,
        "mean_active_rows": float(active.mean()),
    }
