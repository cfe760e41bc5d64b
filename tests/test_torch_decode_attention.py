"""The int8 flash-decode attention of the port against the JAX package, on
the CPU.

* ``repro_torch.kernels.ref.fused_decode_attention_ref`` against JAX's
  ``fused_decode_attention_ref`` at ``tests/test_decode_kernel.py``'s four
  shapes, lengths 0, 1 and ragged, f32 and bf16 scales;
* the wrapper ``fused_decode_attention_cuda`` on CPU tensors (its plain
  version) against ``fused_decode_attention_pallas`` in interpret mode, at
  two small shapes (interpret mode is slow);
* the wrapper's contract errors and its launch count on the CPU;
* the CUDA kernel's split-S rule and fixed-order merge
  (``fused_decode_attention_split_ref``) and its tensor-core arithmetic
  (``tensor_core=True``: bf16 terms, f32 sums, scales after the
  products) against JAX's oracle at every n_split and length the
  kernel distinguishes, length 0 included; the bf16 term split; the
  wrapper's split rule.

Tolerances are the JAX kernel test's: ``m`` atol 1e-5; ``l`` and
``out / l`` rtol 1e-4, atol 1e-4 (both sides f32, summed in other orders).
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_decode_attention_pallas
from repro.kernels import fused_decode_attention_ref as j_ref
from repro_torch.convert import _tensor
from repro_torch.kernels import fused_decode_attention_cuda, fused_decode_attention_ref
from repro_torch.kernels.ref import fused_decode_attention_split_ref, split_bf16

SHAPES = [  # (b, S, kvh, g, hd, block_s): tests/test_decode_kernel.py's
    (1, 256, 1, 1, 128, 128),
    (2, 1024, 2, 4, 128, 256),
    (2, 512, 4, 2, 64, 128),
    (1, 512, 2, 8, 256, 512),
]


def _case(b, S, kvh, g, hd, seed, scale_dtype=np.float32):
    """tests/test_decode_kernel.py's inputs as host arrays; scales cast to
    ``scale_dtype`` (bf16 as the cache stores them)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kvh, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, S, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, S, kvh, hd)).astype(np.float32)
    k_s = (np.abs(k).max(-1) / 127 + 1e-8).astype(np.float32)
    v_s = (np.abs(v).max(-1) / 127 + 1e-8).astype(np.float32)
    k_q = np.round(k / k_s[..., None]).astype(np.int8)
    v_q = np.round(v / v_s[..., None]).astype(np.int8)
    if scale_dtype != np.float32:
        k_s = np.asarray(jnp.asarray(k_s, jnp.bfloat16))
        v_s = np.asarray(jnp.asarray(v_s, jnp.bfloat16))
    return q, k_q, k_s, v_q, v_s


def _both(arrays, length):
    jx = [jnp.asarray(a) for a in arrays] + [jnp.asarray(length, jnp.int32)]
    tt = [_tensor(a, "cpu") for a in arrays] + [torch.tensor(length, dtype=torch.int32)]
    return jx, tt


def _check(got, want):
    out_t, m_t, l_t = (np.asarray(x, np.float32) for x in got)
    out_j, m_j, l_j = (np.asarray(x, np.float32) for x in want)
    np.testing.assert_allclose(m_t, m_j, atol=1e-5)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out_t / l_t[..., None], out_j / l_j[..., None],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scales", ["f32", "bf16"])
@pytest.mark.parametrize("which", ["zero", "one", "ragged"])
@pytest.mark.parametrize("b,S,kvh,g,hd,block_s", SHAPES)
def test_ref_matches_jax_ref(b, S, kvh, g, hd, block_s, which, scales):
    length = {"zero": 0, "one": 1, "ragged": S // 3 + 7}[which]
    arrays = _case(b, S, kvh, g, hd, seed=S + hd,
                   scale_dtype=np.float32 if scales == "f32" else jnp.bfloat16)
    jx, tt = _both(arrays, length)
    got = fused_decode_attention_ref(*tt)
    assert all(x.dtype == torch.float32 for x in got)
    assert got[0].shape == (b, kvh, g, hd) and got[1].shape == got[2].shape == (b, kvh, g)
    _check([x.numpy() for x in got], j_ref(*jx))


def test_ref_length_zero_is_every_weight_one():
    """length 0: m = -1e30, l = S and out = Σ v (the sentinel, never -inf)."""
    b, S, kvh, g, hd = 1, 64, 2, 2, 16
    q, k_q, k_s, v_q, v_s = _case(b, S, kvh, g, hd, seed=5)
    _, tt = _both((q, k_q, k_s, v_q, v_s), 0)
    out, m, l = fused_decode_attention_ref(*tt)
    assert torch.all(m == -1e30)
    assert torch.all(l == S)
    v = v_q.astype(np.float32) * v_s[..., None]
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(
        v.sum(1)[:, :, None, :], (b, kvh, g, hd)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,S,kvh,g,hd,block_s,length", [
    (1, 256, 1, 1, 128, 128, 100),
    (2, 256, 2, 4, 64, 128, 256),
])
def test_wrapper_on_cpu_matches_pallas_interpret(b, S, kvh, g, hd, block_s, length):
    arrays = _case(b, S, kvh, g, hd, seed=S + hd)
    jx, tt = _both(arrays, length)
    before = fused_decode_attention_cuda.launches
    got = fused_decode_attention_cuda(*tt, block_s=block_s)
    assert fused_decode_attention_cuda.launches == before  # the plain version ran
    want = fused_decode_attention_pallas(*jx, block_s=block_s, interpret=True)
    _check([x.numpy() for x in got], want)


def _tensors(b=1, S=256, kvh=2, g=2, hd=64, length=10):
    return _both(_case(b, S, kvh, g, hd, seed=1), length)[1]


@pytest.mark.parametrize("mutate,err", [
    (lambda t: t.__setitem__(0, t[0][0]), ValueError),                       # q not 4-D
    (lambda t: t.__setitem__(1, t[1][:, :128]), ValueError),                 # k_q S ≠ v_q S
    (lambda t: t.__setitem__(2, t[2][..., :1]), ValueError),                 # scale shape
    (lambda t: t.__setitem__(5, torch.tensor([1, 2], dtype=torch.int32)), ValueError),
])
def test_wrapper_rejects_bad_shapes(mutate, err):
    tt = _tensors()
    mutate(tt)
    with pytest.raises(err):
        fused_decode_attention_cuda(*tt)


def test_wrapper_checks_block_s_as_the_reference_does():
    tt = _tensors(S=384)
    with pytest.raises(ValueError, match="block_s"):
        fused_decode_attention_cuda(*tt)                 # 384 % 512
    out, m, l = fused_decode_attention_cuda(*tt, block_s=128)
    assert out.shape == (1, 2, 2, 64)


def test_wrapper_refuses_a_device_that_is_neither_cpu_nor_cuda():
    # all on the meta device is the dry run's shape-only path (below), so
    # the refused case is a meta query beside CPU caches
    tt = list(_tensors())
    tt[0] = tt[0].to("meta")
    before = fused_decode_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        fused_decode_attention_cuda(*tt, block_s=256)
    assert fused_decode_attention_cuda.launches == before


def test_wrapper_on_meta_tensors_gives_shapes_and_launches_nothing():
    tt = [t.to("meta") for t in _tensors()]
    before = fused_decode_attention_cuda.launches
    out, m, l = fused_decode_attention_cuda(*tt, block_s=256)
    b, kvh, g, hd = tt[0].shape
    assert [t.device.type for t in (out, m, l)] == ["meta"] * 3
    assert out.shape == (b, kvh, g, hd) and m.shape == l.shape == (b, kvh, g)
    assert out.dtype == m.dtype == l.dtype == torch.float32
    assert fused_decode_attention_cuda.launches == before


# --- the CUDA kernel's split-S rule and tensor-core arithmetic, in plain torch

SPLIT_SHAPE = (2, 512, 2, 4, 64)     # b, S, kvh, g, hd: 8 chunks of 64
SPLIT_LENGTHS = [0, 1, 63, 64, 65, 512 // 3 + 7, 512]


def _split_inputs(dtype, seed=11):
    """SPLIT_SHAPE's inputs; ``dtype`` "bf16" casts q and the scales."""
    b, S, kvh, g, hd = SPLIT_SHAPE
    q, k_q, k_s, v_q, v_s = _case(b, S, kvh, g, hd, seed=seed)
    if dtype == "bf16":
        q, k_s, v_s = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k_s, v_s))
    return q, k_q, k_s, v_q, v_s


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("length", SPLIT_LENGTHS)
@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 512 // 64])
def test_split_ref_matches_jax_ref(n_split, length, dtype):
    jx, tt = _both(_split_inputs(dtype), length)
    got = fused_decode_attention_split_ref(*tt, n_split)
    _check([x.numpy() for x in got], j_ref(*jx))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("length", SPLIT_LENGTHS)
@pytest.mark.parametrize("n_split", [1, 3, 512 // 64])
def test_tensor_core_ref_matches_jax_ref(n_split, length, dtype):
    """bf16 terms (q: 1 if bf16 else 3; weights: 2), f32 sums, scales
    after the products: within the kernel test's tolerances."""
    jx, tt = _both(_split_inputs(dtype), length)
    got = fused_decode_attention_split_ref(*tt, n_split, tensor_core=True)
    assert all(x.dtype == torch.float32 for x in got)
    _check([x.numpy() for x in got], j_ref(*jx))


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 8])
def test_split_length_zero_is_every_weight_one(n_split):
    """At length 0 every split covers its slice with m = -1e30, so each
    merge correction is exp(0) = 1 and l = S."""
    b, S, kvh, g, hd = SPLIT_SHAPE
    _, tt = _both(_split_inputs("f32"), 0)
    for tc in (False, True):
        out, m, l = fused_decode_attention_split_ref(*tt, n_split, tensor_core=tc)
        assert torch.all(m == -1e30)
        torch.testing.assert_close(l, torch.full_like(l, float(S)), rtol=0, atol=0)


@pytest.mark.parametrize("length,n_split,want", [
    (0, 1, [(0, 512)]),
    (0, 3, [(0, 192), (192, 384), (384, 512)]),
    (574, 17, [(i * 64, i * 64 + 64) for i in range(9)]),   # the served shape
    (1, 8, [(0, 64)]),
    (65, 7, [(0, 64), (64, 128)]),
    (600, 2, [(0, 256), (256, 512)]),                       # length past S
])
def test_split_ranges(length, n_split, want):
    from repro_torch.kernels.ref import decode_split_ranges

    S = 512 if length != 574 else 4096
    assert decode_split_ranges(length, S, n_split) == want


def test_split_bf16_three_terms_reconstruct_f32():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32) * 40)
    terms = split_bf16(x, 3)
    assert all(t.dtype == torch.bfloat16 for t in terms)
    back = sum(t.double() for t in terms)
    rel = ((back - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0 ** -24
    one = split_bf16(x, 1)[0].double()     # one term: only bf16's 8 bits
    assert ((one - x.double()).abs() / x.double().abs()).max().item() > 2.0 ** -10


@pytest.mark.parametrize("b,kvh,S,sms,want", [
    (128, 2, 32_768, 132, 2),      # one decode_32k layer
    (8, 2, 4_096, 132, 17),        # chatglm3-6b at the served shape
    (1, 1, 256, 132, 4),           # capped at one split a chunk
    (512, 8, 4_096, 132, 1),
])
def test_choose_n_split(b, kvh, S, sms, want):
    from repro_torch.kernels.decode_attention import choose_n_split, kernels_per_call

    assert choose_n_split(b, kvh, S, sms) == want
    assert kernels_per_call(want) == (1 if want == 1 else 2)


@pytest.mark.parametrize("n_split", [1, 3])
def test_split_ref_matches_pallas_interpret(n_split):
    b, S, kvh, g, hd, block_s, length = 2, 256, 2, 4, 64, 128, 150
    arrays = _case(b, S, kvh, g, hd, seed=S + hd)
    jx, tt = _both(arrays, length)
    want = fused_decode_attention_pallas(*jx, block_s=block_s, interpret=True)
    _check([x.numpy() for x in fused_decode_attention_split_ref(*tt, n_split)], want)
    _check([x.numpy() for x in fused_decode_attention_split_ref(*tt, n_split, tensor_core=True)],
           want)


def test_wrapper_takes_n_split_and_checks_it():
    tt = _tensors()
    before = fused_decode_attention_cuda.launches
    got = fused_decode_attention_cuda(*tt, block_s=256, n_split=3)
    assert fused_decode_attention_cuda.launches == before  # the plain version ran
    want = fused_decode_attention_ref(*tt)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="n_split"):
        fused_decode_attention_cuda(*tt, block_s=256, n_split=0)


@pytest.mark.parametrize("length", [0, 1, 200])
def test_ref_in_f64_agrees_with_f32(length):
    """``dtype=torch.float64``: the same plain version in f64 (the
    reference ``chip_smoke.py`` holds the kernel to at its timed shapes)."""
    _, tt = _both(_case(2, 256, 2, 4, 64, seed=9), length)
    got = fused_decode_attention_ref(*tt)
    want = fused_decode_attention_ref(*tt, dtype=torch.float64)
    assert all(x.dtype == torch.float64 for x in want)
    _check([x.numpy() for x in got], [x.numpy() for x in want])
