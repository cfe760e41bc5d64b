"""The LM on a device mesh: the port's mesh-sharded forward, loss,
gradients and train step, the shard-local MoE dispatch, restore with
re-sharding and the elastic re-mesh restart.

Every multi-rank case runs in ONE spawned world of 4 gloo ranks on the
CPU (``tests/_torch_lm_mesh_worlds.py``, one intra-op thread a rank),
over the meshes (2, 2), (2, 1), (1, 2) and (4, 1) (the smaller ones on
the first ranks); the (1, 1) cases run in a gloo world of one process,
this one.  The sharded results are held against the port's one-device
values, which the other port tests hold against JAX, at atol 1e-5
(float32 smoke configs); the shard-local MoE at dp data shards against
its per-slice oracle (the one-device run on each shard's batch slice);
the weights after three AdamW steps at ``STEP_ATOL`` (below), their
moments at 1e-5;
at a world of 1 it is held against the reference's ``apply_moe`` on the
same numpy inputs.  Checkpoints re-shard bit for bit, the JAX package's
included.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_lm_mesh_worlds as W
from repro.configs import get_config as j_get_config
from repro.models.moe import apply_moe as j_apply_moe
from repro.models.transformer import init_lm as j_init_lm
from repro.train import checkpoint as j_ckpt
from repro_torch.dist import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.moe import apply_moe, apply_moe_shardmap, init_moe

ATOL = 1e-5
#: the weights after 3 AdamW steps at lr 1e-3.  Adam divides each
#: gradient by its own running RMS, so an element whose few gradients
#: nearly cancel turns the ~1e-7 relative difference of another summation
#: order into ~1e-5 of its update (mlp/out on (2, 2): 2.6e-5 at a second
#: moment of 1.7e-8); twice that reading, a sixtieth of the 3e-3 that three
#: steps can move a weight.  The moments hold ATOL.
STEP_ATOL = 5e-5
# every config on (2, 2), the dense one also on (2, 1) and (1, 2); the
# shard-local MoE's dp and tp halves alone are MOE_SHAPES' cases.  The
# attention core's three layouts: the kv heads split (4 and 2 kv heads
# over model 2), the q-groups split (command-r: 2 kv heads of 4 groups
# over model 4) and neither (chatglm: 2 kv heads of 2 groups over 4)
LM_CASES = [
    ("minicpm-2b", None, (2, 2)), ("minicpm-2b", None, (2, 1)), ("minicpm-2b", None, (1, 2)),
    ("granite-moe-3b-a800m", "gspmd", (2, 2)), ("granite-moe-3b-a800m", "shardmap", (2, 2)),
    ("command-r-35b", None, (1, 4)), ("chatglm3-6b", None, (1, 4)),
]
MOE_SHAPES = [(2, 1), (4, 1), (2, 2)]
# the collectives of a step at COMMS_SEQ tokens, for the attention core's
# kv-head and q-group layouts and the shard-local MoE
COMMS_CASES = [("minicpm-2b", None, (2, 2)), ("command-r-35b", None, (1, 4)),
               ("granite-moe-3b-a800m", "shardmap", (2, 2))]
COMMS_SEQ = 96  # no other dim of these smoke configs is 96
# the families and lengths whose forward raised on a mesh before their
# cores ran on local shards: the recurrent scans (the sLSTM, the
# sequential and, from 256 tokens, chunkwise mLSTM; the Mamba2 conv and
# SSD chunks) and the vlm cross-attention over a model axis its 2 kv heads
# do not divide
REPAIR_CASES = [("xlstm-125m", (2, 2), 16), ("zamba2-7b", (2, 2), 16),
                ("xlstm-125m", (2, 2), 256), ("llama-3.2-vision-11b", (1, 4), 16)]
# chunked_self_attention at 8-token blocks: the kv heads split, the
# q-groups split, neither (with a sliding window)
CHUNKED_CASES = [("minicpm-2b", (2, 2), 0), ("command-r-35b", (1, 4), 0),
                 ("chatglm3-6b", (1, 4), 12)]
SEQ_CACHE = {"k": (2,), "v": (2,), "k_scale": (2,), "v_scale": (2,)}
# decode_step with the cache laid out by cache_specs: every family; the
# read-only and writing paths, an int8 cache under each score layout, and
# sequence-sharded caches, whose attention all-reduces the softmax's
# partials (the kv heads of chatglm3-6b and command-r-35b do not divide
# model 4, so theirs are sequence-sharded; SEQ_CACHE forces it elsewhere,
# the hybrid's ring included)
DECODE_CASES = [
    ("minicpm-2b", (2, 2), False, True, None), ("minicpm-2b", (2, 2), False, False, None),
    ("minicpm-2b", (2, 2), True, True, None), ("minicpm-2b", (2, 2), False, True, SEQ_CACHE),
    ("chatglm3-6b", (1, 4), True, True, None), ("command-r-35b", (1, 4), True, True, None),
    ("granite-moe-3b-a800m", (2, 2), False, True, None),
    ("llama-3.2-vision-11b", (2, 2), False, False, None),
    ("llama-3.2-vision-11b", (2, 2), False, False, SEQ_CACHE),
    ("musicgen-medium", (2, 2), True, True, None), ("xlstm-125m", (2, 2), False, True, None),
    ("zamba2-7b", (2, 2), False, True, None), ("zamba2-7b", (2, 2), False, True, SEQ_CACHE),
]
# dry-run cells run for real on 4 gloo ranks, against the fake world of 4
CELL_CASES = [("minicpm-2b", "train_4k", 16, 8), ("chatglm3-6b", "decode_32k", 64, 8)]


def _lm_name(arch, impl, shape):
    return f"lm-{arch}-{impl}-{shape[0]}x{shape[1]}"


def _case_id(*parts):
    return "-".join(str(p) for p in parts)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """The minicpm-2b smoke parameters written by the JAX package."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    params = j_init_lm(jax.random.PRNGKey(7), j_get_config("minicpm-2b", smoke=True))
    j_ckpt.save(str(d), 0, params)
    names, leaves, _ = j_ckpt._flatten_with_names(params)
    return str(d), {n: np.asarray(x) for n, x in zip(names, leaves)}


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_ckpt):
    cases = [(_lm_name(a, i, s), "lm", {"arch": a, "impl": i, "shape": s})
             for a, i, s in LM_CASES]
    cases += [(f"moe-{s[0]}x{s[1]}", "moe", {"shape": s}) for s in MOE_SHAPES]
    cases += [("moe-indivisible", "moe", {"shape": (4, 1), "b": 2})]
    cases += [(f"comms-{_lm_name(a, i, s)}", "comms",
               {"arch": a, "impl": i, "shape": s, "s": COMMS_SEQ}) for a, i, s in COMMS_CASES]
    cases += [(_case_id("repair", *c), "lm", {"arch": c[0], "shape": c[1], "s": c[2]})
              for c in REPAIR_CASES]
    cases += [(_case_id("chunked", *c), "chunked", {"arch": c[0], "shape": c[1], "window": c[2]})
              for c in CHUNKED_CASES]
    cases += [(_case_id("decode", *c), "decode", {"arch": c[0], "shape": c[1], "quant": c[2],
                                                  "readonly": c[3], "prio": c[4]})
              for c in DECODE_CASES]
    cases += [(_case_id("cell", *c), "cell", {"arch": c[0], "shape_name": c[1], "s": c[2],
                                              "b": c[3]}) for c in CELL_CASES]
    cases += [
        ("adamw", "adamw", {"arch": "minicpm-2b", "shape": (2, 2)}),
        ("adamw-mb2", "adamw", {"arch": "minicpm-2b", "shape": (2, 2), "steps": 1,
                                "microbatches": 2}),
        ("restore", "restore", {"ckpt_dir": str(tmp_path_factory.mktemp("ckpt")),
                                "jax_dir": jax_ckpt[0]}),
        ("elastic", "elastic", {"ckpt_dir": str(tmp_path_factory.mktemp("elastic"))}),
    ]
    return W.run(4, cases, tmp_path_factory.mktemp("lm4"), timeout_s=120.0, wait_s=400.0)


@pytest.fixture
def world1():
    """A gloo world of one process (this one), ended after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def _ok(world, name):
    status, value = world[name]
    assert status == "ok", value
    return value


# ------------------------------------------------------------- world 4 --


@pytest.mark.parametrize("arch,impl,shape", LM_CASES)
def test_sharded_forward_loss_and_grads_equal_one_device(world4, arch, impl, shape):
    r = _ok(world4, _lm_name(arch, impl, shape))
    assert r["logits"] <= ATOL and r["loss"] <= ATOL and r["grads"] <= ATOL, r
    assert r["placements_kept"] and r["loss_replicated"], r


@pytest.mark.parametrize("shape", MOE_SHAPES)
def test_moe_shardmap_equals_per_slice_oracle(world4, shape):
    r = _ok(world4, f"moe-{shape[0]}x{shape[1]}")
    assert r["y"] <= ATOL and r["aux"] <= ATOL and r["grads"] <= ATOL, r


def test_moe_shardmap_refuses_a_batch_the_dp_axes_do_not_divide(world4):
    """b 2 over dp 4: the reference's ``shard_map`` refuses its in_specs;
    laid out replicated instead, every rank's full y would be summed."""
    r = _ok(world4, "moe-indivisible")
    assert r["raised"] == "ValueError", r


@pytest.mark.parametrize("arch,impl,shape", COMMS_CASES)
def test_step_gathers_neither_scores_nor_embedding_table(world4, arch, impl, shape):
    """The attention core runs on each rank's shard of the scores' layout,
    so no collective carries an ``(s, s)`` score block; the embedding is a
    vocab-parallel lookup, so the whole table is never gathered."""
    r = _ok(world4, f"comms-{_lm_name(arch, impl, shape)}")
    cfg = W.lm_config(arch)
    assert r["calls"] > 0, r
    for c in r["by_shape"]:
        assert c["shape"][-2:] != [COMMS_SEQ, COMMS_SEQ], c
        assert not (c["op"] == "all_gather_into_tensor" and len(c["shape"]) == 2
                    and math.prod(c["shape"]) == cfg.padded_vocab * cfg.d_model), c


@pytest.mark.parametrize("arch,shape,s", REPAIR_CASES)
def test_recurrent_and_cross_attention_forward_loss_and_grads_on_mesh(world4, arch, shape, s):
    r = _ok(world4, _case_id("repair", arch, shape, s))
    assert r["logits"] <= ATOL and r["loss"] <= ATOL and r["grads"] <= ATOL, r
    assert r["placements_kept"] and r["loss_replicated"], r


@pytest.mark.parametrize("arch,shape,window", CHUNKED_CASES)
def test_chunked_attention_on_mesh_equals_one_device(world4, arch, shape, window):
    r = _ok(world4, _case_id("chunked", arch, shape, window))
    assert r["y"] <= ATOL and r["grads"] <= ATOL, r


@pytest.mark.parametrize("arch,shape,quant,readonly,prio", DECODE_CASES)
def test_decode_steps_on_mesh_equal_one_device(world4, arch, shape, quant, readonly, prio):
    """Three decode steps from an empty cache laid out by ``cache_specs``:
    every step's logits and the final cache, int8 entries bit for bit."""
    r = _ok(world4, _case_id("decode", arch, shape, quant, readonly, prio))
    assert r["logits"] <= ATOL and r["cache"] <= ATOL, r


@pytest.mark.parametrize("arch,shape_name,s,b", CELL_CASES)
def test_fake_world_counts_what_a_gloo_world_counts(world4, arch, shape_name, s, b):
    """The dry run's program of a cell on (2, 2): meta tensors on a fake
    world of 4 ranks count the FLOPs, collectives and argument bytes that
    CPU tensors on 4 gloo ranks count."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import SHAPES, ShapeConfig
    from repro_torch.launch import dryrun

    real = _ok(world4, _case_id("cell", arch, shape_name, s, b))
    shp = ShapeConfig(shape_name, s, b, SHAPES[shape_name].kind)
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        counter, memory, _ = dryrun.cell_program(W.lm_config(arch), shp, shape_name, mesh,
                                                 sh.LOGICAL_RULES_SINGLE_POD)
    assert real["breakdown"] and counter.breakdown() == real["breakdown"]
    assert counter.flops == real["flops"] > 0
    assert memory["argument_size_gib"] == real["argument_size_gib"]


def test_three_adamw_steps_on_mesh_equal_off_mesh(world4):
    r = _ok(world4, "adamw")
    assert r["all_dtensor"], r
    assert r["loss"] <= ATOL and r["grad_norm"] <= ATOL, r
    assert r["params"] <= STEP_ATOL and r["moments"] <= ATOL, r


def test_microbatched_step_on_mesh_equals_off_mesh(world4):
    """One AdamW step over 2 microbatches: on the mesh each rank splits its
    own rows (``make_train_step``), off it the batch's halves."""
    r = _ok(world4, "adamw-mb2")
    assert r["all_dtensor"], r
    assert r["loss"] <= ATOL and r["grad_norm"] <= ATOL, r
    assert r["params"] <= STEP_ATOL and r["moments"] <= ATOL, r


def test_restore_reshards_bit_for_bit(world4, jax_ckpt):
    r = _ok(world4, "restore")
    assert sorted(r["restored"]) == sorted(r["saved"])
    for name, want in r["saved"].items():
        np.testing.assert_array_equal(r["restored"][name], want, err_msg=name)
    # (1, 2): the in-projections' FSDP dim over "data", their TP dim over "model"
    from torch.distributed.tensor import Shard

    assert r["placements"][".params/layers/attn/wq"] == [str(Shard(1)), str(Shard(2))]
    _, jax_leaves = jax_ckpt
    assert sorted(r["from_jax"]) == sorted(jax_leaves)
    for name, want in jax_leaves.items():
        np.testing.assert_array_equal(r["from_jax"][name], want, err_msg=name)


def test_elastic_restart_remeshes_and_matches(world4):
    r = _ok(world4, "elastic")
    assert r["mesh_a"] == [2, 2] and r["mesh_b"] == [1, 2]
    assert len(r["restarted"]) == len(r["uninterrupted"]) == 6
    assert r["max_abs_diff"] <= r["atol"] <= ATOL


# ------------------------------------------------------------- world 1 --


@pytest.mark.parametrize("arch,impl", [("minicpm-2b", None), ("granite-moe-3b-a800m", "gspmd"),
                                       ("granite-moe-3b-a800m", "shardmap")])
def test_host_mesh_forward_loss_and_grads_equal_one_device(world1, arch, impl):
    from repro_torch.models.layers import tree_leaves

    cfg = W.lm_config(arch, impl)
    params = W.lm_params(cfg)
    tokens, labels = W.lm_batch(cfg)
    want_logits, want_loss, want_grads = W.one_device(cfg, params, tokens, labels, 1)
    dparams, logits, loss, grads = W.on_mesh(cfg, params, tokens, labels, world1)
    np.testing.assert_allclose(logits.full_tensor().numpy(), want_logits.numpy(), atol=ATOL)
    assert abs(float(loss.to_local()) - float(want_loss)) <= ATOL
    for g, w, p in zip(tree_leaves(grads), tree_leaves(want_grads), tree_leaves(dparams)):
        assert tuple(g.placements) == tuple(p.placements)
        np.testing.assert_allclose(g.full_tensor().numpy(), w.numpy(), atol=ATOL)


def test_moe_shardmap_world1_equals_reference_apply_moe(world1):
    """At a world of 1 the shard-local dispatch is one group: the
    reference's ``apply_moe`` on the same numpy inputs."""
    cfg = W.lm_config("granite-moe-3b-a800m")
    jcfg = j_get_config("granite-moe-3b-a800m", smoke=True)
    rng = np.random.default_rng(5)
    p = {k: v.numpy() for k, v in init_moe(torch.Generator().manual_seed(5), cfg.d_model,
                                            cfg.d_ff, cfg.moe, cfg.act, torch.float32).items()}
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    want_y, want_aux = j_apply_moe({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                   jcfg.moe, jcfg.act)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    with sh.activation_sharding_ctx(world1, sh.LOGICAL_RULES_SINGLE_POD):
        y, aux = apply_moe_shardmap(tp, torch.from_numpy(x), cfg.moe, cfg.act)
    np.testing.assert_allclose(y.full_tensor().numpy(), np.asarray(want_y), atol=ATOL)
    assert abs(float(aux.to_local()) - float(want_aux)) <= ATOL


def test_moe_shardmap_outside_a_context_is_apply_moe():
    cfg = W.lm_config("granite-moe-3b-a800m")
    p = init_moe(torch.Generator().manual_seed(2), cfg.d_model, cfg.d_ff, cfg.moe, cfg.act,
                 torch.float32)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(3))
    y, aux = apply_moe_shardmap(p, x, cfg.moe, cfg.act)
    want_y, want_aux = apply_moe(p, x, cfg.moe, cfg.act)
    assert torch.equal(y, want_y) and torch.equal(aux, want_aux)


def test_maybe_shard_outside_a_context_is_x_itself():
    x = torch.ones((4, 16, 8))
    assert sh.maybe_shard(x, ("batch", "seq", "embed")) is x
    assert sh.maybe_shard_any(x, [("batch", "seq", "embed")]) is x
    assert sh.replicate_like(x, torch.ones(2)) is x


def test_forward_outside_a_context_makes_no_dtensor():
    from repro_torch.models.transformer import forward

    cfg = dataclasses.replace(W.lm_config("granite-moe-3b-a800m"), moe_impl="shardmap")
    params = W.lm_params(cfg)
    tokens, _ = W.lm_batch(cfg)
    logits, aux = forward(params, cfg, tokens)
    assert type(logits) is torch.Tensor and type(aux) is torch.Tensor
