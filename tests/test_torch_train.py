"""The port's optimizers, train step and data pipeline against the JAX
package, on the CPU.

Parameters, states and batches start the same in both packages:
``repro_torch.convert`` carries JAX's ``init_lm`` parameters and
``TrainState``s across, gradients and tokens are drawn with numpy.
Configs are the smoke configs of ``chatglm3-6b`` and ``stablelm-3b`` in
float32.

Tolerances: schedules rtol 1e-6 (float32 arithmetic in both, the same
operations in the same order); ``clip_by_global_norm``, one and three
``AdamW``/``Adafactor`` updates, and the train step's loss, grad norm,
parameters and state atol and rtol 1e-4 (XLA and torch sum the matmuls
and reductions in other orders); the port's microbatched step against
its own single-batch step atol 1e-4, as ``tests/test_integration.py``
holds JAX's; the batchers bit for bit.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro.models import init_lm as j_init_lm
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.convert import (
    lm_params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.data import QueryBatcher, TokenBatcher
from repro_torch.launch import train as ltrain
from repro_torch.models.layers import tree_map
from repro_torch.models.transformer import init_lm
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import flatten_with_names, global_norm, jax_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["chatglm3-6b", "stablelm-3b"]


def _host(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_trees_close(port, ref, **tol):
    """Leaf by leaf, matched by JAX's path names."""
    got = dict(flatten_with_names(port))
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    got = {k.replace(".", ""): v for k, v in got.items()}
    want = {k.replace(".", ""): v for k, v in want.items()}
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(_host(got[name]).astype(np.float32),
                                   np.asarray(want[name], np.float32), err_msg=name, **tol)


# ------------------------------------------------------------ schedules --

SCHEDULES = [
    ("cosine", lambda m: m.cosine_schedule(3e-4, 10, 100)),
    ("cosine-warmup>total", lambda m: m.cosine_schedule(3e-4, 10, 8)),
    ("wsd", lambda m: m.wsd_schedule(1e-2, 5, 40, 60)),
    ("make-cosine", lambda m: m.make_schedule("cosine", 3e-3, 500)),
    ("make-wsd", lambda m: m.make_schedule("wsd", 3e-3, 500, warmup=20)),
]


@pytest.mark.parametrize("name,build", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match_jax(name, build):
    t_lr, j_lr = build(topt), build(jopt)
    for step in [0, 1, 3, 5, 9, 10, 11, 30, 44, 45, 50, 59, 60, 99, 100, 250, 499, 500, 700]:
        got = t_lr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(j_lr(jnp.int32(step))), rtol=1e-6,
                                   atol=1e-12, err_msg=f"{name} step {step}")


# ---------------------------------------------------------- optimizers --

def _params_and_grads(arch, seed=0):
    j_cfg = j_get_config(arch, smoke=True)
    jp = j_init_lm(jax.random.PRNGKey(seed), j_cfg)
    rng = np.random.default_rng(seed)
    g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32) * 0.3, jp)
    return jp, g


def test_global_norm_sums_in_jax_order_and_clip_matches_jax():
    rng = np.random.default_rng(0)
    tp = init_lm(torch.Generator().manual_seed(0), get_config("chatglm3-6b", smoke=True))
    tg = tree_map(lambda t: torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)), tp)
    g = tree_map(lambda t: t.numpy(), tg)
    # the port's dicts keep insertion order; JAX walks sorted keys
    assert list(tg) != sorted(tg) and list(tg["layers"]) != sorted(tg["layers"])
    assert [a.shape for a in jax_leaves(tg)] == [a.shape for a in jax.tree.leaves(g)]
    norm = float(global_norm(tg))
    want_norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(x)) for x in jax.tree.leaves(g))))
    np.testing.assert_allclose(norm, want_norm, rtol=1e-6)
    for max_norm in (1.0, 1e6):
        got = topt.clip_by_global_norm(tg, max_norm)
        want = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
        assert_trees_close(got, want, **STEP_TOL)


OPTIMIZERS = [
    ("adamw", lambda m: m.AdamW(schedule=m.cosine_schedule(1e-2, 2, 10))),
    ("adamw-noclip", lambda m: m.AdamW(schedule=lambda s: 3e-3, clip_norm=1e9,
                                       weight_decay=0.0)),
    ("adafactor", lambda m: m.Adafactor(schedule=m.cosine_schedule(1e-2, 2, 10))),
    ("adafactor-wd", lambda m: m.make_optimizer("adafactor", lambda s: 1e-2,
                                                weight_decay=0.1, clip_threshold=0.5)),
]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name,build", OPTIMIZERS, ids=[o[0] for o in OPTIMIZERS])
def test_optimizer_updates_match_jax(arch, name, build):
    jp, _ = _params_and_grads(arch)
    t_o, j_o = build(topt), build(jopt)
    j_state = jloop.init_train_state(jp, j_o)
    t_state = train_state_from_numpy(jax.tree.map(np.asarray, j_state), "cpu")
    jparams, jo = j_state.params, j_state.opt_state
    tparams, to = t_state.params, t_state.opt_state
    j_update = jax.jit(j_o.update)
    rng = np.random.default_rng(5)
    for k in range(3):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32) * 0.1, jp)
        jparams, jo = j_update(jax.tree.map(jnp.asarray, g), jo, jparams)
        tparams, to = t_o.update(lm_params_from_numpy(g, "cpu"), to, tparams)
        if k in (0, 2):   # one and three updates
            assert int(to.step) == int(jo.step) == k + 1
            assert_trees_close(tparams, jparams, **STEP_TOL)
            assert_trees_close(to, jo, **STEP_TOL)


def test_optimizer_update_is_functional():
    jp, g = _params_and_grads("chatglm3-6b")
    for opt in (topt.AdamW(schedule=lambda s: 1e-2), topt.Adafactor(schedule=lambda s: 1e-2)):
        params = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        before = tree_map(torch.clone, params)
        state = opt.init(params)
        new, new_state = opt.update(lm_params_from_numpy(g, "cpu"), state, params)
        for (_, a), (_, b) in zip(flatten_with_names(params), flatten_with_names(before)):
            assert torch.equal(a, b)
        assert int(state.step) == 0 and int(new_state.step) == 1
    with pytest.raises(ValueError):
        topt.make_optimizer("sgd", lambda s: 1e-2)


# ----------------------------------------------------------- train step --

def _step_case(arch, b=8, s=16, seed=0):
    j_cfg, cfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = j_init_lm(jax.random.PRNGKey(seed), j_cfg)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s + 1))
    toks = toks.astype(np.int32)
    return j_cfg, cfg, jp, toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_jax(arch, microbatches):
    j_cfg, cfg, jp, tokens, labels = _step_case(arch)
    j_o = jopt.AdamW(schedule=jopt.make_schedule("cosine", 3e-3, 20))
    t_o = topt.AdamW(schedule=topt.make_schedule("cosine", 3e-3, 20))
    j_state = jloop.init_train_state(jp, j_o)
    t_state = train_state_from_numpy(jax.tree.map(np.asarray, j_state), "cpu")
    j_step = jax.jit(jloop.make_train_step(j_cfg, j_o, microbatches=microbatches))
    t_step = tloop.make_train_step(cfg, t_o, microbatches=microbatches)
    j_batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    t_batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    for _ in range(2):
        j_state, jm = j_step(j_state, j_batch)
        t_state, tm = t_step(t_state, t_batch)
        for key in ("loss", "grad_norm"):
            assert tm[key].dtype == torch.float32
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), err_msg=key, **STEP_TOL)
    assert int(t_state.step) == int(j_state.step) == 2
    assert_trees_close(t_state, j_state, **STEP_TOL)


def test_microbatched_step_matches_single_batch_and_grad_norm_is_unclipped():
    _, cfg, jp, tokens, labels = _step_case("chatglm3-6b", seed=1)
    opt = topt.AdamW(schedule=lambda s: 1e-3, clip_norm=1e-3)   # clips every step
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    out = {}
    for mb in (1, 4):
        state = tloop.init_train_state(lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                                       opt)
        out[mb] = tloop.make_train_step(cfg, opt, microbatches=mb)(state, batch)
    (s1, m1), (s4, m4) = out[1], out[4]
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    assert float(m1["grad_norm"]) > 1.0    # far above clip_norm: the unclipped norm
    np.testing.assert_allclose(float(m4["grad_norm"]), float(m1["grad_norm"]), **STEP_TOL)
    for (n, a), (_, b) in zip(flatten_with_names(s1.params), flatten_with_names(s4.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, err_msg=n)
    with pytest.raises(ValueError, match="divisible"):
        tloop.make_train_step(cfg, opt, microbatches=3)(s1, batch)
    # has_enc: a vlm step over 2 microbatches, its enc split with the batch,
    # equals JAX's
    j_cfg, v_cfg = j_get_config("llama-3.2-vision-11b", smoke=True), get_config(
        "llama-3.2-vision-11b", smoke=True)
    jv = j_init_lm(jax.random.PRNGKey(2), j_cfg)
    enc = np.random.default_rng(2).normal(size=(8, v_cfg.num_image_tokens, v_cfg.d_model))
    enc = (enc * 0.1).astype(np.float32)
    j_o = jopt.AdamW(schedule=lambda s: 1e-3)
    j_state = jloop.init_train_state(jv, j_o)
    j_new, jm = jax.jit(jloop.make_train_step(j_cfg, j_o, microbatches=2, has_enc=True))(
        j_state, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
                  "enc": jnp.asarray(enc)})
    t_new, tm = tloop.make_train_step(v_cfg, topt.AdamW(schedule=lambda s: 1e-3),
                                      microbatches=2, has_enc=True)(
        train_state_from_numpy(jax.tree.map(np.asarray, j_state), "cpu"),
        dict(batch, enc=torch.from_numpy(enc)))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **STEP_TOL)
    assert_trees_close(t_new, j_new, **STEP_TOL)


def test_eval_step_matches_jax():
    j_cfg, cfg, jp, tokens, labels = _step_case("stablelm-3b", b=2)
    want = jloop.make_eval_step(j_cfg)(jp, {"tokens": tokens, "labels": labels})
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = tloop.make_eval_step(cfg)(tp, {"tokens": torch.from_numpy(tokens),
                                         "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got), float(want), **STEP_TOL)


def test_train_state_convert_round_trip_is_exact():
    jp, _ = _params_and_grads("chatglm3-6b")
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    for j_o in (jopt.AdamW(schedule=lambda s: 1e-3), jopt.Adafactor(schedule=lambda s: 1e-3)):
        j_state = jloop.init_train_state(jp, j_o)
        t_state = train_state_from_numpy(jax.tree.map(np.asarray, j_state), "cpu")
        assert type(t_state.opt_state).__name__ == type(j_state.opt_state).__name__
        assert t_state.params["embed"].dtype == torch.bfloat16
        assert t_state.step.dtype == torch.int32
        back = train_state_to_numpy(t_state)
        for (n, a), (_, b) in zip(flatten_with_names(back), flatten_with_names(
                jax.tree.map(np.asarray, j_state))):
            np.testing.assert_array_equal(a, np.asarray(b, a.dtype), err_msg=n)
            assert np.asarray(jnp.asarray(a, b.dtype)).tobytes() == np.asarray(b).tobytes()


# ----------------------------------------------------------- launcher --

def test_train_loss_falls_over_30_steps():
    cfg = get_config("stablelm-3b", smoke=True)
    opt = topt.AdamW(schedule=topt.make_schedule(cfg.schedule, 3e-3, 30))
    data = TokenBatcher(cfg.vocab_size, 8, 64, seed=0)
    logs = []
    state, report = ltrain.train(cfg, opt, data, 30, device="cpu", log=logs.append)
    losses = [r["loss"] for r in report["steps"]]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses
    assert int(state.step) == 30 and report["tokens_per_s"] > 0
    assert report["dead_hosts"] == [] and len(logs) == 4      # steps 0, 10, 20, 29


def test_launcher_runs_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
           "--batch", "4", "--seq", "16", "--save-every", "2", "--ckpt-dir", str(tmp_path)]
    first = subprocess.run(cmd + ["--steps", "3"], capture_output=True, text=True,
                           env=env, cwd=ROOT, timeout=120)
    assert first.returncode == 0, first.stderr
    assert "arch=xlstm-125m family=ssm" in first.stdout     # the reference's default
    losses = [float(l.split()[3]) for l in first.stdout.splitlines() if l.startswith("step")]
    assert losses and all(np.isfinite(losses))
    assert sorted(os.listdir(tmp_path)) == ["step_000000002"]
    second = subprocess.run(cmd + ["--steps", "5"], capture_output=True, text=True,
                            env=env, cwd=ROOT, timeout=120)
    assert second.returncode == 0, second.stderr
    assert "resumed from step 2" in second.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_000000002", "step_000000004"]


def test_launcher_defaults_to_cuda():
    args = ltrain.parse_args([])
    assert args.device == "cuda" and args.arch == "xlstm-125m" and not args.full
    assert get_config(args.arch, smoke=True).family == "ssm"


# --------------------------------------------------------------- data --

@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("hosts", [(0, 1), (1, 2), (3, 4)])
def test_token_batcher_equals_reference(seed, hosts):
    h, n = hosts
    t = TokenBatcher(1000, 8, 24, seed=seed, host_index=h, num_hosts=n)
    j = jpipe.TokenBatcher(1000, 8, 24, seed=seed, host_index=h, num_hosts=n)
    for step in (0, 1, 7, 123):
        for a, b in zip(t.batch(step), j.batch(step)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    it_t, it_j = iter(t), iter(j)
    for _ in range(2):
        for a, b in zip(next(it_t), next(it_j)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("hosts", [(0, 1), (1, 4)])
def test_query_batcher_equals_reference(seed, hosts):
    h, n = hosts
    t = QueryBatcher(512, 64, 8.0, seed=seed, host_index=h, num_hosts=n)
    j = jpipe.QueryBatcher(512, 64, 8.0, seed=seed, host_index=h, num_hosts=n)
    for step in (0, 2, 99):
        a, b = t.batch(step), j.batch(step)
        assert len(a) == len(b) == 64 // n
        for qa, qb in zip(a, b):
            assert qa.dtype == qb.dtype
            np.testing.assert_array_equal(qa, qb)
