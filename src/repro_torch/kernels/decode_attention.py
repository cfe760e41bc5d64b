"""Fused flash-decode attention over an int8 K/V cache: the CUDA wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``fused_decode_attention_pallas`` :94 and its body ``_kernel`` :43)
with the hand-written CUDA C++ kernels in ``csrc/decode_attention.cu``:
the cache half of one decode step's attention, which
``models.attention.decode_attention_readonly`` merges with the new
token's own K/V.

What bounds it on an H100: bytes (the int8 cache read once).  The two
products run on the tensor cores (bf16 ``mma.sync``, f32 accumulate),
whose rate is far above the work's 29 flop a byte at g = 16.  S is split
across blocks: ``n_split`` blocks per (sequence, KV head) each take a
contiguous range of the chunks that the device-side ``length`` needs and
write a partial ``(out, m, l)``; a second kernel merges them in a fixed
order.  ``length`` is read only on the device, so a decode step never
waits on the host.

On CPU tensors the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.fused_decode_attention_ref`); on CUDA
tensors it launches the kernels or raises; on meta tensors (the dry run)
it returns outputs of the right shapes and computes nothing.
``fused_decode_attention_cuda.launches`` counts calls that launched;
:func:`kernels_per_call` says how many device kernels one such call runs.
"""

from __future__ import annotations

import torch

import functools
import math

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._build import KernelError, load_decode_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)
_MAX_G = 16       # query rows per KV head one CUDA block holds
_MAX_BATCH = 65_535  # the grid's y dimension
_ALIGN = 16       # bytes: the kernel reads cache rows as 16-byte vectors
_BLOCKS_PER_SM = 2   # the split rule aims at about this many blocks an SM


def choose_n_split(b: int, kvh: int, S: int, sm_count: int) -> int:
    """Blocks per (sequence, KV head): enough for about two blocks an SM,
    at most one per chunk of the cache.  Never from ``length``, which
    stays on the device."""
    want = math.ceil(_BLOCKS_PER_SM * sm_count / max(1, b * kvh))
    return max(1, min(want, math.ceil(S / _ref.DECODE_CHUNK)))


def kernels_per_call(n_split: int) -> int:
    """Device kernels one call launches: the split kernel, and the merge
    when there is more than one split."""
    return 1 if n_split == 1 else 2


@functools.cache
def _sm_count(index: int) -> int:
    n = load_decode_attention().decode_attention_sm_count(index)
    if n <= 0:
        raise KernelError(f"cannot read the SM count of cuda:{index}")
    return n


def _check_shapes(q, k_q, k_s, v_q, v_s, length, block_s) -> None:
    """Validates the reference contract (on every device)."""
    if q.ndim != 4 or k_q.ndim != 4:
        raise ValueError(
            f"q must be (b, kvh, g, hd) and k_q (b, S, kvh, hd), got "
            f"{tuple(q.shape)} / {tuple(k_q.shape)}"
        )
    b, kvh, _, hd = q.shape
    S = k_q.shape[1]
    if tuple(k_q.shape) != (b, S, kvh, hd) or v_q.shape != k_q.shape:
        raise ValueError(
            f"k_q and v_q must be (b, S, kvh, hd) = ({b}, S, {kvh}, {hd}), got "
            f"{tuple(k_q.shape)} / {tuple(v_q.shape)}"
        )
    if tuple(k_s.shape) != (b, S, kvh) or v_s.shape != k_s.shape:
        raise ValueError(
            f"k_s and v_s must be (b, S, kvh) = ({b}, {S}, {kvh}), got "
            f"{tuple(k_s.shape)} / {tuple(v_s.shape)}"
        )
    if length.numel() != 1:
        raise ValueError(f"length must hold one value, got shape {tuple(length.shape)}")
    if S == 0 or S % block_s != 0:
        raise ValueError(f"S={S} must be a positive multiple of block_s={block_s}")


def fused_decode_attention_cuda(
    q: torch.Tensor,       # (b, kvh, g, hd) f32 or bf16
    k_q: torch.Tensor,     # (b, S, kvh, hd) int8
    k_s: torch.Tensor,     # (b, S, kvh) f32 or bf16
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    length: torch.Tensor,  # 0-d int32: positions >= length are masked
    *,
    block_s: int = 512,
    n_split: int | None = None,
):
    """``fused_decode_attention_pallas`` counterpart (inference only: the
    TPU kernel has no VJP).

    Returns the unnormalized ``out`` (b, kvh, g, hd) f32 with the row max
    ``m`` and denominator ``l`` (b, kvh, g) f32.  ``block_s`` is the TPU
    kernel's S tile: it is checked (``S % block_s``) as the reference
    checks it; the CUDA kernel's own tile is fixed.  ``n_split`` forces
    the number of S splits (tests and ``chip_smoke.py`` only); ``None``
    takes :func:`choose_n_split`.  The plain version on CPU tensors has
    no splits.
    """
    _check_shapes(q, k_q, k_s, v_q, v_s, length, block_s)
    if n_split is not None and n_split < 1:
        raise ValueError(f"n_split={n_split} must be >= 1")
    tensors = (q, k_q, k_s, v_q, v_s, length)
    if all(t.device.type == "cpu" for t in tensors):
        return _ref.fused_decode_attention_ref(q, k_q, k_s, v_q, v_s, length)
    if all(t.device.type == "meta" for t in tensors):
        b, kvh, g, hd = q.shape
        return (torch.empty((b, kvh, g, hd), dtype=torch.float32, device="meta"),
                torch.empty((b, kvh, g), dtype=torch.float32, device="meta"),
                torch.empty((b, kvh, g), dtype=torch.float32, device="meta"))
    device = q.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            f"all inputs must share one CUDA device, got {[str(t.device) for t in tensors]}"
        )
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE_CODE)}")
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise TypeError(f"k_q and v_q must be int8, got {k_q.dtype} / {v_q.dtype}")
    if k_s.dtype not in _DTYPE_CODE or v_s.dtype != k_s.dtype:
        raise TypeError(
            f"k_s and v_s must share one dtype in {list(_DTYPE_CODE)}, got "
            f"{k_s.dtype} / {v_s.dtype}"
        )
    if length.dtype != torch.int32:
        raise TypeError(f"length dtype {length.dtype} must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    b, kvh, g, hd = q.shape
    S = k_q.shape[1]
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim={hd} not in {_HEAD_DIMS}")
    if not 1 <= g <= _MAX_G:
        raise ValueError(f"g={g} query rows per KV head must be in 1..{_MAX_G}")
    if b > _MAX_BATCH:
        raise ValueError(f"batch {b} exceeds {_MAX_BATCH}")
    if k_q.data_ptr() % _ALIGN or v_q.data_ptr() % _ALIGN:
        raise ValueError(f"k_q and v_q data must be {_ALIGN}-byte aligned")
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=device)
    m = torch.empty((b, kvh, g), dtype=torch.float32, device=device)
    l = torch.empty((b, kvh, g), dtype=torch.float32, device=device)
    if b == 0 or kvh == 0:
        return out, m, l
    lib = load_decode_attention()
    if n_split is None:
        n_split = choose_n_split(b, kvh, S, _sm_count(device.index or 0))
    n_split = min(n_split, math.ceil(S / _ref.DECODE_CHUNK))
    ws = (None, None, None)
    if n_split > 1:
        # f32 partials of every split, merged by the second kernel: out
        # (n_split, b, kvh, g, hd), then m and l (n_split, b, kvh, g) each
        rows = n_split * b * kvh * g
        work = torch.empty(rows * (hd + 2), dtype=torch.float32, device=device)
        base = work.data_ptr()
        ws = (base, base + 4 * rows * hd, base + 4 * rows * (hd + 1))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), _DTYPE_CODE[q.dtype], k_q.data_ptr(), k_s.data_ptr(),
            v_q.data_ptr(), v_s.data_ptr(), _DTYPE_CODE[k_s.dtype],
            length.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(), *ws,
            b, S, kvh, g, hd, n_split, 1.0 / (hd ** 0.5), stream,
        )
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise KernelError(f"decode_attention kernel launch failed: {msg} ({err})")
    fused_decode_attention_cuda.launches += 1
    return out, m, l


fused_decode_attention_cuda.launches = 0
