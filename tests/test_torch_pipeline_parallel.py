"""GPipe pipeline parallelism of the port (``repro_torch.dist.
pipeline_parallel``) against the reference's schedule math and the
sequential product.

The reference's ``pipelined_apply`` fails under the installed jax
(``tests/test_pipeline_parallel.py::test_single_stage_equals_sequential``),
so the port is held to that test's oracle, ``jax.vmap(body(w[0], ·))``
on the same numpy inputs, at one stage in a gloo world of 1 in this
process; and at 2 and 4 stages in one spawned world of 4 gloo ranks on
the CPU (``tests/_torch_lm_mesh_worlds.py``) to the sequential product of
every stage (atol 1e-6, float32).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import _torch_lm_mesh_worlds as W
from repro.dist.pipeline_parallel import bubble_fraction as j_bubble_fraction
from repro_torch.dist.pipeline_parallel import bubble_fraction, pipelined_apply

ATOL = 1e-6


@pytest.fixture(scope="module")
def world1():
    """A gloo world of one process (this one), ended after the module."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases = [
        ("s4", "pipeline", {"S": 4, "shape": (4,), "names": ("stage",)}),
        # two pipelines of 2 stages side by side: stage ranks are not 0..S-1
        ("s2", "pipeline", {"S": 2, "shape": (2, 2), "names": ("rep", "stage")}),
        ("s2_sub", "pipeline", {"S": 2, "shape": (2,), "names": ("stage",), "M": 3}),
    ]
    return W.run(4, cases, tmp_path_factory.mktemp("pp4"), wait_s=180.0)


@pytest.mark.parametrize("m,s", [(8, 4), (1, 1), (64, 8), (3, 2), (1, 5), (16, 1)])
def test_bubble_fraction_matches_reference(m, s):
    assert bubble_fraction(m, s) == j_bubble_fraction(m, s)


@pytest.mark.parametrize("m,s", [(0, 1), (1, 0), (-2, 3)])
def test_bubble_fraction_raises_where_reference_raises(m, s):
    with pytest.raises(ValueError):
        j_bubble_fraction(m, s)
    with pytest.raises(ValueError):
        bubble_fraction(m, s)


def test_single_stage_equals_reference_oracle(world1):
    """tests/test_pipeline_parallel.py:12-26 on the same numpy inputs."""
    from torch.distributed.device_mesh import init_device_mesh

    S, L, D, M, MB = 1, 4, 16, 3, 8
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, L, D, D)) * 0.25).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)

    def body(w_stage, h):
        def layer(c, wl):
            return jnp.tanh(c @ wl), None
        out, _ = jax.lax.scan(layer, h, w_stage)
        return out

    ref = jax.vmap(lambda xb: body(jnp.asarray(w[0]), xb))(jnp.asarray(x))
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("stage",))
    out = pipelined_apply(torch.from_numpy(w), torch.from_numpy(x), W.stage_body, mesh)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_mesh_without_stage_axis_raises(world1):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    w, x = W.pipeline_inputs(1, 2, 4, 8, 1)
    with pytest.raises(ValueError, match="no 'stage' axis"):
        pipelined_apply(w, x, W.stage_body, mesh)


def test_wrong_stage_count_raises(world1):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("stage",))
    w, x = W.pipeline_inputs(2, 2, 4, 8, 1)
    with pytest.raises(ValueError, match="2 stages"):
        pipelined_apply(w, x, W.stage_body, mesh)


@pytest.mark.parametrize("case", ["s4", "s2", "s2_sub"])
def test_stages_equal_sequential_product(world4, case):
    status, err = world4[case]
    assert status == "ok", err
    assert err <= ATOL
