"""Sharding rules of the port (``repro_torch.dist.sharding``,
``repro_torch.launch.mesh``) against ``repro.dist.sharding`` on the same
inputs.

Specs are compared as tuples (``tuple(port_spec) == tuple(jax_spec)``).
Every passing case of ``tests/test_dist.py`` is mirrored; its two cases
on a real JAX mesh fail under the installed jax, so the port is held to
what they assert (``maybe_shard`` inside a context times 2 is ``2·x``;
``maybe_shard_any`` keeps the shape) on a (1, 1) ``DeviceMesh`` over a
gloo world of one process (this one).  ``make_production_mesh`` is built
over 256- and 512-rank worlds of torch's ``fake`` backend, whose
``FakeStore`` lives in ``torch.testing._internal.distributed.fake_pg``,
which is not public API (pinned here; torch 2.11 and 2.13 have it); each
world is ended after its test.
"""

import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as j_get_config
from repro.configs import list_configs
from repro.dist import sharding as jsh
from repro.models.dlrm import init_dlrm as j_init_dlrm
from repro.models.transformer import init_lm as j_init_lm
from repro.train.checkpoint import _flatten_with_names as j_flatten
from repro_torch.configs import get_config
from repro_torch.dist import sharding as sh
from repro_torch.dist.sharding import (
    LOGICAL_RULES_MULTI_POD,
    LOGICAL_RULES_SINGLE_POD,
    P,
    activation_sharding_ctx,
    logical_to_spec,
    maybe_shard,
    maybe_shard_any,
    param_specs_for,
    sanitize_spec,
    sanitize_specs_tree,
    to_placements,
)
from repro_torch.launch import mesh as lmesh
from repro_torch.models.dlrm import init_dlrm
from repro_torch.models.transformer import init_lm
from repro_torch.train.tree import flatten_with_names


class _FakeMesh:
    """Carries axis names/sizes for spec logic without 256 devices."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


class _DimMesh:
    """The attributes of a ``DeviceMesh`` that the spec logic reads."""

    def __init__(self, sizes: dict):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self.ndim = len(sizes)


MESH = _FakeMesh({"data": 16, "model": 16})
MULTI = _FakeMesh({"pod": 2, "data": 16, "model": 16})


def same(port_spec, jax_spec) -> bool:
    return tuple(port_spec) == tuple(jax_spec)


@pytest.fixture
def world1():
    """A gloo world of one process (this one), ended after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ tests/test_dist.py ------


def test_logical_to_spec_basic():
    spec = logical_to_spec(("batch", "seq", "mlp"), LOGICAL_RULES_SINGLE_POD)
    assert spec == P("data", None, "model")
    assert same(spec, jsh.logical_to_spec(("batch", "seq", "mlp"),
                                          jsh.LOGICAL_RULES_SINGLE_POD))
    spec = logical_to_spec(("batch", None), LOGICAL_RULES_MULTI_POD)
    assert spec == P(("pod", "data"), None)
    assert same(spec, jsh.logical_to_spec(("batch", None), jsh.LOGICAL_RULES_MULTI_POD))


def test_rule_tables_equal_reference():
    assert LOGICAL_RULES_SINGLE_POD == jsh.LOGICAL_RULES_SINGLE_POD
    assert LOGICAL_RULES_MULTI_POD == jsh.LOGICAL_RULES_MULTI_POD


def test_sanitize_spec_drops_nondivisible():
    assert sanitize_spec(P("model", None), (122753, 64), MESH) == P(None, None)
    assert sanitize_spec(P("model", None), (122880, 64), MESH) == P("model", None)
    assert sanitize_spec(P(("pod", "data"), None), (48, 8), MULTI) == P(None, None)


def test_sanitize_spec_tuple_axis_multi_pod_regression():
    assert sanitize_spec(P(("pod", "data")), (48,), MULTI) == P(None)
    assert len(sanitize_spec(P(("pod", "data")), (48,), MULTI)) == 1
    assert sanitize_spec(P(("pod", "data"), "model"), (48, 31), MULTI) == P(None, None)
    assert sanitize_spec(P(("pod", "data")), (64,), MULTI) == P(("pod", "data"))
    assert sanitize_spec(P(("pod", "data"), "model"), (64, 32), MULTI) == \
        P(("pod", "data"), "model")


def test_sanitize_spec_drops_unknown_mesh_axes():
    assert sanitize_spec(P(("pod", "data")), (64,), MESH) == P(None)
    assert sanitize_spec(P("pod", None), (48, 8), MESH) == P(None, None)
    assert sanitize_spec(P("pod", "model"), (48, 32), MESH) == P(None, "model")


def test_param_specs_attention_and_mlp():
    params = {
        "layers": {
            "attn": {"wq": torch.zeros((4, 64, 128)), "wo": torch.zeros((4, 128, 64))},
            "mlp": {"in_gate": torch.zeros((4, 64, 256)), "out": torch.zeros((4, 256, 64))},
            "norm_attn": {"scale": torch.zeros((4, 64))},
        },
        "embed": torch.zeros((1024, 64)),
        "lm_head": torch.zeros((64, 1024)),
    }
    specs = param_specs_for(params, LOGICAL_RULES_SINGLE_POD)
    assert specs["layers"]["attn"]["wq"] == P(None, "data", "model")
    assert specs["layers"]["attn"]["wo"] == P(None, "model", "data")
    assert specs["layers"]["mlp"]["in_gate"] == P(None, "data", "model")
    assert specs["layers"]["mlp"]["out"] == P(None, "model", "data")
    assert specs["layers"]["norm_attn"]["scale"] == P()
    assert specs["embed"] == P("model", "data")
    assert specs["lm_head"] == P("data", "model")


def test_param_specs_moe_expert_layout():
    params = {"moe": {"w_gate": torch.zeros((8, 64, 256)), "w_val": torch.zeros((8, 64, 256)),
                      "w_out": torch.zeros((8, 256, 64)), "router": torch.zeros((64, 8))}}
    specs = param_specs_for(params, LOGICAL_RULES_SINGLE_POD, moe=True)
    assert specs["moe"]["w_gate"] == P(None, "data", "model")
    assert specs["moe"]["w_out"] == P(None, "model", "data")
    assert specs["moe"]["router"] in (P(), P(None, None))


def test_param_specs_no_gate_collision():
    params = {"mlp": {"in_gate": torch.zeros((64, 256))}, "xattn": {"gate": torch.zeros((1,))}}
    specs = param_specs_for(params, LOGICAL_RULES_SINGLE_POD)
    assert specs["mlp"]["in_gate"] == P("data", "model")
    assert specs["xattn"]["gate"] == P()


def test_maybe_shard_noop_outside_context():
    x = torch.ones((4, 4))
    assert maybe_shard(x, ("batch", None)) is x
    assert maybe_shard_any(x, [("batch", None)]) is x


def test_maybe_shard_applies_constraint_on_real_mesh(world1):
    """tests/test_dist.py:127-134 on a (1, 1) DeviceMesh."""
    mesh = lmesh.make_host_mesh(device_type="cpu")
    with activation_sharding_ctx(mesh, LOGICAL_RULES_SINGLE_POD):
        out = maybe_shard(torch.ones((4, 4)), ("batch", "mlp")) * 2
    from torch.distributed.tensor import Shard

    assert list(out.placements) == [Shard(0), Shard(1)]
    np.testing.assert_array_equal(out.full_tensor().numpy(), 2 * np.ones((4, 4)))


def test_maybe_shard_any_fallback_order(world1):
    """tests/test_dist.py:137-141 on a (1, 1) DeviceMesh."""
    mesh = lmesh.make_host_mesh(device_type="cpu")
    with activation_sharding_ctx(mesh, LOGICAL_RULES_SINGLE_POD):
        x = torch.ones((3, 5))
        y = maybe_shard_any(x, [("batch", "mlp"), (None, None)])
        assert y.shape == x.shape


def test_maybe_shard_any_prefers_first_surviving(world1, monkeypatch):
    """tests/test_dist.py:144-172: the FIRST candidate whose spec fully
    survives sanitization is the one applied."""
    applied = []

    def record(x, mesh, spec):
        applied.append(spec)
        return x

    monkeypatch.setattr(sh, "shard_tensor", record)
    mesh = lmesh.make_host_mesh(device_type="cpu")
    rules = dict(LOGICAL_RULES_SINGLE_POD)
    with activation_sharding_ctx(mesh, rules):
        x = torch.ones((4, 4))
        maybe_shard_any(x, [("batch", "mlp"), (None, None)])
        assert applied[-1] == P("data", "model")
        multi_rules = dict(rules, batch=("pod", "data"))
        with activation_sharding_ctx(mesh, multi_rules):
            maybe_shard_any(x, [("batch", None), (None, "mlp")])
            assert applied[-1] == P(None, "model")
    assert len(applied) == 2


def test_maybe_shard_redistributes_a_dtensor(world1):
    mesh = lmesh.make_host_mesh(device_type="cpu")
    x = sh.shard_tensor(torch.arange(12.0).reshape(3, 4), mesh, P("data", "model"))
    with activation_sharding_ctx(mesh, LOGICAL_RULES_SINGLE_POD):
        y = maybe_shard(x, ("batch", None))
    from torch.distributed.tensor import Replicate, Shard

    assert list(y.placements) == [Shard(0), Replicate()]
    assert torch.equal(y.full_tensor(), torch.arange(12.0).reshape(3, 4))


# ------------------------------------------------- against the reference --

SPEC_CASES = [
    (P("model", None), (122753, 64)), (P("model", None), (122880, 64)),
    (P(("pod", "data"), None), (48, 8)), (P(("pod", "data")), (64,)),
    (P(("pod", "data"), "model"), (64, 32)), (P(("pod", "data"), "model"), (48, 31)),
    (P("pod", "model"), (48, 32)), (P("data", None, "model"), (32, 7, 48)),
    (P(None, "data", "model"), (4, 64, 128)), (P("data", "model"), (0, 16)),
    (P("data",), ()),
]


@pytest.mark.parametrize("mesh_sizes", [{"data": 16, "model": 16},
                                        {"pod": 2, "data": 16, "model": 16},
                                        {"data": 2, "model": 4}, {"data": 1, "model": 1}])
@pytest.mark.parametrize("spec,shape", SPEC_CASES)
def test_sanitize_spec_equals_reference(mesh_sizes, spec, shape):
    fake = _FakeMesh(mesh_sizes)
    got = sanitize_spec(spec, shape, fake)
    assert same(got, jsh.sanitize_spec(JP(*spec), shape, fake))
    assert len(got) == len(spec)
    # a DeviceMesh's names and shape give the same sizes
    assert sanitize_spec(spec, shape, _DimMesh(mesh_sizes)) == got


@pytest.mark.parametrize("rules_name", ["single", "multi"])
def test_sanitize_specs_tree_equals_reference(rules_name):
    rules = LOGICAL_RULES_SINGLE_POD if rules_name == "single" else LOGICAL_RULES_MULTI_POD
    jrules = jsh.LOGICAL_RULES_SINGLE_POD if rules_name == "single" else \
        jsh.LOGICAL_RULES_MULTI_POD
    axes = {"a": ("batch", "seq", "embed"), "b": [("batch", "mlp"), ("vocab", None)],
            "c": {"d": ("fsdp", "heads", None)}}
    shapes = {"a": (64, 7, 32), "b": [(48, 256), (122753, 5)], "c": {"d": (32, 16, 3)}}
    avals = jax.tree.map(lambda s: types.SimpleNamespace(shape=s), shapes,
                         is_leaf=lambda x: isinstance(x, tuple))
    specs = jax.tree.map(lambda a: logical_to_spec(a, rules), axes,
                         is_leaf=lambda x: isinstance(x, tuple))
    jspecs = jax.tree.map(lambda a: jsh.logical_to_spec(a, jrules), axes,
                          is_leaf=lambda x: isinstance(x, tuple))
    got = sanitize_specs_tree(specs, avals, MULTI)
    want = jsh.sanitize_specs_tree(jspecs, avals, MULTI)
    flat = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, P))
    jflat = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, JP))
    assert len(flat) == len(jflat) == 4
    assert all(same(a, b) for a, b in zip(flat, jflat))


def _port_tree(arch):
    cfg = get_config(arch, smoke=True)
    if arch == "dlrm-recross":
        return init_dlrm(torch.Generator().manual_seed(0), cfg, device="cpu")
    return init_lm(torch.Generator().manual_seed(0), cfg)


def _jax_avals(arch):
    cfg = j_get_config(arch, smoke=True)
    init = j_init_dlrm if arch == "dlrm-recross" else j_init_lm
    return jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("rules_name", ["single", "multi"])
@pytest.mark.parametrize("arch", list_configs())
def test_param_specs_equal_reference_for_every_arch(arch, rules_name):
    """``param_specs_for`` of each arch's smoke config, leaf for leaf by
    name, against the reference's on ``jax.eval_shape(init)``."""
    rules = LOGICAL_RULES_SINGLE_POD if rules_name == "single" else LOGICAL_RULES_MULTI_POD
    jrules = jsh.LOGICAL_RULES_SINGLE_POD if rules_name == "single" else \
        jsh.LOGICAL_RULES_MULTI_POD
    params = _port_tree(arch)
    held = sh.map_specs(lambda s: types.SimpleNamespace(spec=s), param_specs_for(params, rules))
    got = {n: h.spec for n, h in flatten_with_names(held)}
    avals = _jax_avals(arch)
    names, jspecs, _ = j_flatten(jsh.param_specs_for(avals, jrules))
    want = dict(zip(names, jspecs))
    assert sorted(got) == sorted(want)
    assert all(same(got[n], want[n]) for n in want), \
        {n: (got[n], want[n]) for n in want if not same(got[n], want[n])}
    # sanitized on a 16 x 16 mesh, too
    san = sh.map_specs(lambda s: types.SimpleNamespace(spec=s),
                       sanitize_specs_tree(param_specs_for(params, rules), params, MULTI))
    jsan = jsh.sanitize_specs_tree(jsh.param_specs_for(avals, jrules), avals, MULTI)
    jnames, jleaves, _ = j_flatten(jsan)
    got = {n: h.spec for n, h in flatten_with_names(san)}
    assert all(same(got[n], s) for n, s in zip(jnames, jleaves))


# ------------------------------------------------------------ placements --


@pytest.mark.parametrize("spec,want", [
    (P(), ["R", "R"]),
    (P(None, None), ["R", "R"]),
    (P("data", None), ["S0", "R"]),
    (P(None, "data", "model"), ["S1", "S2"]),
    (P("model", "data"), ["S1", "S0"]),
    (P(None, "model"), ["R", "S1"]),
    (P(("data", "model"), None), ["S0", "S0"]),
])
def test_to_placements_single_pod(spec, want):
    from torch.distributed.tensor import Replicate, Shard

    expect = [Replicate() if w == "R" else Shard(int(w[1:])) for w in want]
    assert to_placements(spec, _DimMesh({"data": 16, "model": 16})) == expect


@pytest.mark.parametrize("spec,want", [
    (P(("pod", "data"), None, None), ["S0", "S0", "R"]),
    (P(("pod", "data"), None, "model"), ["S0", "S0", "S2"]),
    (P(None, "data", "model"), ["R", "S1", "S2"]),
    (P("pod", None), ["S0", "R", "R"]),
])
def test_to_placements_multi_pod(spec, want):
    from torch.distributed.tensor import Replicate, Shard

    expect = [Replicate() if w == "R" else Shard(int(w[1:])) for w in want]
    assert to_placements(spec, _DimMesh({"pod": 2, "data": 16, "model": 16})) == expect


@pytest.mark.parametrize("rules_name", ["single", "multi"])
@pytest.mark.parametrize("axes,shape", [
    (("batch", "seq", "embed"), (64, 16, 32)), (("batch", "seq", "vocab"), (64, 16, 256)),
    (("batch", "kv_heads", None, None, None), (32, 16, 2, 8, 8)),
    (("batch", None, "qgroups", None, None), (64, 3, 16, 8, 8)),
    (("experts", "expert_cap_dp", "mlp"), (8, 64, 32)), (("batch", "seq", "embed"), (3, 5, 7)),
])
def test_to_placements_of_every_rule(rules_name, axes, shape):
    """The placements name each mesh dim's tensor dim as the spec does."""
    from torch.distributed.tensor import Shard

    rules = LOGICAL_RULES_SINGLE_POD if rules_name == "single" else LOGICAL_RULES_MULTI_POD
    sizes = {"data": 16, "model": 16} if rules_name == "single" else \
        {"pod": 2, "data": 16, "model": 16}
    mesh = _DimMesh(sizes)
    spec = sanitize_spec(logical_to_spec(axes, rules), shape, mesh)
    pl = to_placements(spec, mesh)
    for name, p in zip(mesh.mesh_dim_names, pl):
        owner = [d for d, part in enumerate(spec)
                 if part is not None and name in (part if isinstance(part, tuple) else (part,))]
        assert (p == Shard(owner[0])) if owner else not isinstance(p, Shard)


@pytest.mark.parametrize("spec", [P(("data", "pod")), P("data", "data"), P("stage")])
def test_to_placements_refuses_what_dtensor_cannot_express(spec):
    with pytest.raises(ValueError):
        to_placements(spec, _DimMesh({"pod": 2, "data": 16, "model": 16}))


# ----------------------------------------------------------------- meshes --


@pytest.mark.parametrize("multi_pod,size,names,sizes", [
    (False, 256, ("data", "model"), {"data": 16, "model": 16}),
    (True, 512, ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}),
])
def test_make_production_mesh_on_fake_world(multi_pod, size, names, sizes):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        mesh = lmesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert mesh.mesh_dim_names == names
        assert lmesh.mesh_axis_sizes(mesh) == sizes
        assert lmesh.chips(mesh) == size
        assert sh._mesh_axis_sizes(mesh) == sizes
    finally:
        dist.destroy_process_group()


def test_make_host_mesh(world1):
    mesh = lmesh.make_host_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert lmesh.mesh_axis_sizes(mesh) == {"data": 1, "model": 1}
    assert lmesh.chips(mesh) == 1
    assert mesh.device_type == "cpu"
