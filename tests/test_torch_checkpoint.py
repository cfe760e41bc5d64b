"""The port's checkpoints, gradient compression and fault-tolerance
runtime against the JAX package, on the CPU.

Checkpoints are held bit for bit in both directions (JAX ``save`` → port
``restore`` and port ``save`` → JAX ``restore``, bfloat16 leaves
included), with the names JAX's ``_flatten_with_names`` spells; the
crash, restore and replay run is bit-exact in the port, as
``tests/test_integration.py`` holds JAX's.  Compression: the int8
payload and scales equal JAX's, the residual within f32 atol 1e-6;
error feedback recovers the mean gradient within atol 2e-2, as
``tests/test_train.py`` holds JAX's.  The fault-tolerance runtime is
copied host Python and is held to the reference's behaviour.
"""

import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_lm as j_init_lm
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import fault_tolerance as jft
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import TokenBatcher
from repro_torch.models.layers import tree_map
from repro_torch.models.transformer import init_lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train.fault_tolerance import (
    HeartbeatMonitor,
    StragglerDetector,
    plan_remesh,
    run_with_restarts,
)
from repro_torch.train.tree import flatten_with_names


def _bits(x):
    a = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.dtype.itemsize, a.shape, a.tobytes()


def _tbits(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.element_size(), tuple(t.shape), t.numpy().tobytes()


def _j_state(opt_cls, dtype):
    cfg = j_get_config("chatglm3-6b", smoke=True)
    params = jax.tree.map(lambda x: x.astype(dtype), j_init_lm(jax.random.PRNGKey(0), cfg))
    opt = opt_cls(schedule=lambda s: 1e-3)
    state = jloop.init_train_state(params, opt)
    # a step so the moments and the step are not zeros
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    new_p, new_o = jax.jit(opt.update)(grads, state.opt_state, state.params)
    return jloop.TrainState(new_p, new_o, state.step + 1)


@pytest.mark.parametrize("opt_cls", [jopt.AdamW, jopt.Adafactor], ids=["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_checkpoints_cross_packages_bit_for_bit(tmp_path, opt_cls, dtype):
    j_state = _j_state(opt_cls, dtype)
    t_state = train_state_from_numpy(jax.tree.map(np.asarray, j_state), "cpu")
    want_names = jckpt._flatten_with_names(j_state)[0]
    assert [n for n, _ in flatten_with_names(t_state)] == want_names

    # JAX save -> port restore
    jckpt.save(str(tmp_path / "j"), 3, j_state)
    like = tree_map(torch.zeros_like, t_state)
    got = ckpt.restore(str(tmp_path / "j"), 3, like, device="cpu")
    assert type(got) is tloop.TrainState and type(got.opt_state) is type(t_state.opt_state)
    for (n, a), (_, b) in zip(flatten_with_names(got), flatten_with_names(t_state)):
        assert a.dtype == b.dtype and _tbits(a) == _tbits(b), n

    # port save -> JAX restore; the manifests agree
    ckpt.save(str(tmp_path / "t"), 3, t_state)
    back = jckpt.restore(str(tmp_path / "t"), 3, jax.eval_shape(lambda: j_state))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(j_state)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)
    manifests = [json.load(open(tmp_path / d / "step_000000003" / "manifest.json"))
                 for d in ("j", "t")]
    assert manifests[0] == manifests[1]


def test_latest_step_ignores_uncommitted_and_tmp(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d + "/missing") is None
    tree = {"w": torch.ones(4)}
    ckpt.save(d, 5, tree)
    os.makedirs(os.path.join(d, "step_000000009.tmp"))         # a torn write
    os.makedirs(os.path.join(d, "step_000000007"))             # no COMMITTED
    assert ckpt.latest_step(d) == 5 == jckpt.latest_step(d)
    ckpt.save(d, 5, {"w": torch.full((4,), 2.0)})              # overwrites step 5
    assert ckpt.restore(d, 5, tree)["w"].tolist() == [2.0] * 4


def test_save_async_snapshots_before_returning(tmp_path):
    w = torch.arange(32.0).reshape(4, 8)
    h = ckpt.save_async(str(tmp_path), 3, {"w": w, "s": torch.tensor(7, dtype=torch.int32)})
    w.zero_()                                                  # after the snapshot
    h.wait()
    assert h.done and ckpt.latest_step(str(tmp_path)) == 3
    got = ckpt.restore(str(tmp_path), 3, {"w": w, "s": torch.zeros((), dtype=torch.int32)})
    assert torch.equal(got["w"], torch.arange(32.0).reshape(4, 8))
    assert got["s"].dtype == torch.int32 and int(got["s"]) == 7


def test_save_async_error_is_raised_by_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    h = ckpt.save_async(str(blocker), 1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        h.wait()


def test_restore_checks_names_and_shapes(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 1, {"w": torch.zeros(5)})
    with pytest.raises(KeyError, match="v"):
        ckpt.restore(str(tmp_path), 1, {"w": torch.zeros(4), "v": torch.zeros(1)})


def test_restore_rejects_a_corrupt_or_compressed_member(tmp_path):
    tree = {"w": torch.arange(64.0), "s": torch.ones((), dtype=torch.int32)}
    path = ckpt.save(str(tmp_path / "a"), 1, tree) + "/host_000.npz"
    assert torch.equal(ckpt.restore(str(tmp_path / "a"), 1, tree)["w"], tree["w"])
    raw = bytearray(open(path, "rb").read())
    at = raw.index(np.arange(64.0, dtype=np.float32).tobytes())
    raw[at + 17] ^= 0x40                                      # one bit of w's data
    open(path, "wb").write(bytes(raw))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):     # np.load's own check
        ckpt.restore(str(tmp_path / "a"), 1, tree)
    # a compressed member reads as np.load reads it, as in the reference
    np.savez_compressed(path, w=np.zeros(64, np.float32), s=np.ones((), np.int32))
    assert torch.equal(ckpt.restore(str(tmp_path / "a"), 1, tree)["w"], torch.zeros(64))


def _run(state, step_fn, data, steps, start=0, ckpt_dir=None, save_every=5, crash_at=None):
    for s in range(start, steps):
        if crash_at is not None and s == crash_at:
            raise RuntimeError("injected failure")
        tokens, labels = data.batch(s)
        state, _ = step_fn(state, {"tokens": torch.from_numpy(tokens),
                                   "labels": torch.from_numpy(labels)})
        if ckpt_dir and (s + 1) % save_every == 0:
            ckpt.save(ckpt_dir, s + 1, state)
    return state


def test_crash_restore_resume_bitexact(tmp_path):
    """12 steps clean against crash-at-8, restore-from-5 and replay: the
    deterministic pipeline and the checkpoint make them identical."""
    cfg = get_config("chatglm3-6b", smoke=True)
    opt = topt.AdamW(schedule=lambda s: 1e-3)

    def fresh():
        return tloop.init_train_state(init_lm(torch.Generator().manual_seed(0), cfg), opt)

    step_fn = tloop.make_train_step(cfg, opt)
    data = TokenBatcher(cfg.vocab_size, batch_size=4, seq_len=16, seed=0)
    clean = _run(fresh(), step_fn, data, 12)
    d = str(tmp_path)
    with pytest.raises(RuntimeError):
        _run(fresh(), step_fn, data, 12, ckpt_dir=d, crash_at=8)
    latest = ckpt.latest_step(d)
    assert latest == 5
    resumed = _run(ckpt.restore(d, latest, fresh()), step_fn, data, 12, start=latest)
    for (n, a), (_, b) in zip(flatten_with_names(clean), flatten_with_names(resumed)):
        assert torch.equal(a, b), n


# ---------------------------------------------------------- compression --

def test_compress_matches_jax():
    rng = np.random.default_rng(1)
    grads = {"w": rng.normal(size=(64, 32)).astype(np.float32),
             "b": {"x": rng.normal(size=(7,)).astype(np.float32) * 1e-3}}
    t_g = tree_map(torch.from_numpy, grads)
    t_state, j_state = comp.init_compression(t_g), jcomp.init_compression(grads)
    for _ in range(3):
        tq, ts, t_state = comp.compress(t_g, t_state)
        jq, js, j_state = jcomp.compress(jax.tree.map(jnp.asarray, grads), j_state)
        for name in ("w", "b"):
            a = tq[name] if name == "w" else tq[name]["x"]
            b = jq[name] if name == "w" else jq[name]["x"]
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(float(ts["w"]), float(js["w"]), rtol=1e-6)
        np.testing.assert_allclose(t_state.error["w"].numpy(), np.asarray(j_state.error["w"]),
                                   atol=1e-6)
        np.testing.assert_allclose(comp.decompress(tq, ts)["b"]["x"].numpy(),
                                   np.asarray(jcomp.decompress(jq, js)["b"]["x"]), atol=1e-6)


def test_compression_error_feedback_preserves_signal():
    rng = np.random.default_rng(0)
    grads = {"w": torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))}
    state = comp.init_compression(grads)
    acc = torch.zeros(256)
    n = 50
    for _ in range(n):
        payload, scales, state = comp.compress(grads, state)
        acc += comp.decompress(payload, scales)["w"]
    np.testing.assert_allclose((acc / n).numpy(), grads["w"].numpy(), atol=2e-2)


def test_compression_wire_ratio():
    grads = {"w": torch.ones(1024), "h": torch.ones(64, dtype=torch.bfloat16)}
    j_grads = {"w": jnp.ones((1024,)), "h": jnp.ones((64,), jnp.bfloat16)}
    assert comp.raw_bytes(grads) == jcomp.raw_bytes(j_grads) == 4096 + 128
    assert comp.compressed_bytes(grads) == jcomp.compressed_bytes(j_grads) == 1088


# ------------------------------------------------------ fault tolerance --

@pytest.mark.parametrize("mod", ["port", "ref"])
def test_heartbeat_and_stragglers_match_reference(mod):
    hbm, sdm = (HeartbeatMonitor, StragglerDetector) if mod == "port" else (
        jft.HeartbeatMonitor, jft.StragglerDetector)
    hb = hbm(timeout_s=10)
    hb.beat(0, 1, t=100.0)
    hb.beat(1, 1, t=100.0)
    hb.beat(0, 2, t=115.0)
    assert hb.dead_hosts(now=116.0) == [1]
    assert hb.membership(now=116.0) == [0]
    sd = sdm(window=8, threshold=2.0)
    assert sd.stragglers() == []
    for _ in range(12):
        for h in range(4):
            sd.record(h, 1.0 if h != 2 else 3.5)
    assert sd.stragglers() == [2] and len(sd._durations[0]) == 8


def test_plan_remesh_matches_reference():
    for args in [(64, 4, 16, 1), (60, 4, 16, 1), (64, 8, 16, 2), (3, 8, 8, 3)]:
        n, c, mp, pods = args
        assert plan_remesh(n, c, model_parallelism=mp, pods=pods) == jft.plan_remesh(
            n, c, model_parallelism=mp, pods=pods)
    with pytest.raises(RuntimeError):
        plan_remesh(1, 4, model_parallelism=16)


def test_run_with_restarts_matches_reference():
    def make_runner(fail_at):
        store, failed = {}, []

        def step_fn(step, state):
            if step in fail_at and step not in failed:
                failed.append(step)
                raise RuntimeError("injected node failure")
            return state + (step + 1)

        def save_fn(step, state):
            store["ckpt"] = (step, state)

        return step_fn, save_fn, lambda: store.get("ckpt", (0, 0))

    for fail_at in [(), (17,), (3, 17, 24)]:
        out = []
        for runner in (run_with_restarts, jft.run_with_restarts):
            s, sv, r = make_runner(fail_at)
            out.append(runner(s, 0, 25, save_fn=sv, restore_fn=r, save_every=10))
        assert out[0] == out[1]
        assert out[0][0] == sum(range(1, 26))
    s, sv, r = make_runner(range(25))
    with pytest.raises(RuntimeError):
        run_with_restarts(s, 0, 25, save_fn=sv, restore_fn=r, max_restarts=2)
