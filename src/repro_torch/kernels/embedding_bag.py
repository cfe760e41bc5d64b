"""Padded embedding bag (gather + sum): the CUDA wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/embedding_bag.py``
(``embedding_bag_pallas`` and its body ``_kernel``) with the hand-written
CUDA C++ kernel in ``csrc/embedding_bag.cu``.  It is the naive / nMARS
datapath that the ReCross crossbar reduction is measured against: each
query gathers its rows by row id and sums them.

What bounds it on an H100: memory.  Each valid lookup reads one row and
does one add per element; the least bytes are the valid rows, the
indices and one write of the output.  The kernel reads exactly those:
one warp per (bag, 128-column chunk), four neighbouring columns per lane
(one coalesced request per row chunk), padding indices skipped by the
whole warp, the sum in f32 registers and the output written once.

On a CPU tensor the wrapper runs the plain version in
:mod:`repro_torch.kernels.ref`; on a CUDA tensor it launches the kernel
or raises.  ``embedding_bag_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._build import load_embedding_bag

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16  # bytes: the kernel's vector loads need an aligned table


def _check_shapes(table, indices) -> None:
    """Validates the reference contract."""
    if table.ndim != 2 or indices.ndim != 2:
        raise ValueError(
            f"table must be (rows, dim) and indices (batch, bag), got "
            f"{tuple(table.shape)} / {tuple(indices.shape)}"
        )
    if table.shape[1] % 128 != 0:
        raise ValueError(f"dim={table.shape[1]} must be a multiple of 128")


def embedding_bag_cuda(
    table: torch.Tensor,    # (rows, dim)
    indices: torch.Tensor,  # (batch, bag) int32, -1 padding
) -> torch.Tensor:
    """``embedding_bag_pallas`` counterpart (no autograd; see ops).

    ``out[b] = Σ_k table[indices[b, k]]`` over ``indices >= 0``; an index
    at or past ``rows`` reads the last row, as the plain version clamps.
    Returns ``(batch, dim)`` in the table dtype, summed in float32.
    """
    _check_shapes(table, indices)
    tensors = (table, indices)
    if all(t.device.type == "cpu" for t in tensors):
        return _ref.embedding_bag_ref(table, indices)
    device = table.device
    if device.type != "cuda" or indices.device != device:
        raise ValueError(
            f"table and indices must share one device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"table dtype {table.dtype} not in {list(_DTYPE_CODE)}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices dtype {indices.dtype} must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("table and indices must be contiguous")
    if table.data_ptr() % _ALIGN != 0:
        raise ValueError(f"table data must be {_ALIGN}-byte aligned")
    rows, dim = table.shape
    batch, bag = indices.shape
    if rows == 0:
        raise ValueError("table holds no rows")
    out = torch.empty((batch, dim), dtype=table.dtype, device=device)
    if batch == 0:
        return out
    lib = load_embedding_bag()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.embedding_bag_launch(
            table.data_ptr(), indices.data_ptr(), out.data_ptr(),
            rows, dim, batch, bag, _DTYPE_CODE[table.dtype], stream,
        )
    if err != 0:
        msg = lib.embedding_bag_error_string(err).decode()
        raise RuntimeError(f"embedding_bag kernel launch failed: {msg} ({err})")
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
