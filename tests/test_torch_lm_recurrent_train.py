"""Training and the launchers of the recurrent LM families of the port
against the JAX package, on the CPU: the train step at 1 and 2
microbatches, the eval step, an xlstm checkpoint across packages, and
``launch.train``/``launch.serve`` in a subprocess.

Inputs as in ``tests/test_torch_lm_recurrent.py`` (smoke configs in
float32; JAX's parameters and ``TrainState`` carried across by
``repro_torch.convert``).  Tolerances are ``tests/test_torch_train.py``'s:
the train step's loss, grad norm, parameters and optimizer state atol
and rtol 1e-4 over 2 steps, the eval loss the same; checkpoints bit for
bit.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.models.layers import tree_map
from repro_torch.serve import kvcache as tkv
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import flatten_with_names

from _torch_lm_families_cases import lm_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["xlstm-125m", "zamba2-7b"]


def assert_trees_close(port, ref, **tol):
    """Leaf by leaf, matched by JAX's path names."""
    got = {k.replace(".", ""): v for k, v in flatten_with_names(port)}
    want = {jax.tree_util.keystr(p, simple=True, separator="/").replace(".", ""): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].detach().float().numpy(),
                                   np.asarray(want[name], np.float32), err_msg=name, **tol)

# --------------------------------------------------------------- train --

@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, microbatches):
    j_cfg, cfg, jp, _, tokens, labels, _ = lm_case(arch, b=4, s=16)
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
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), err_msg=key, **STEP_TOL)
    assert int(t_state.step) == int(j_state.step) == 2
    assert_trees_close(t_state, j_state, **STEP_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_matches_jax(arch):
    j_cfg, cfg, jp, tp, tokens, labels, _ = lm_case(arch)
    want = jloop.make_eval_step(j_cfg)(jp, {"tokens": tokens, "labels": labels})
    got = tloop.make_eval_step(cfg)(tp, {"tokens": torch.from_numpy(tokens),
                                         "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got), float(want), **STEP_TOL)


def _tbits(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.element_size(), tuple(t.shape), t.numpy().tobytes()


def _bits(x):
    a = np.asarray(x)
    return a.dtype.itemsize, a.shape, a.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_checkpoint_crosses_packages_bit_for_bit(tmp_path, dtype):
    """An AdamW state of xlstm (its f32 gate weights stay f32 in bf16)
    saved by either package and restored by the other, bit for bit."""
    jp = lm_case("xlstm-125m", cfg_overrides={"dtype": dtype})[2]
    opt = jopt.AdamW(schedule=lambda s: 1e-3)
    state = jloop.init_train_state(jp, opt)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jp)
    new_p, new_o = jax.jit(opt.update)(grads, state.opt_state, state.params)
    j_state = jloop.TrainState(new_p, new_o, state.step + 1)
    t_state = train_state_from_numpy(jax.tree.map(np.asarray, j_state), "cpu")
    assert [n for n, _ in flatten_with_names(t_state)] == jckpt._flatten_with_names(j_state)[0]
    assert t_state.params["layers"]["slstm"]["cell"]["w_rec"].dtype == torch.float32
    host = train_state_to_numpy(t_state)          # and back, in JAX's leaf order
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(j_state), strict=True):
        assert _bits(jnp.asarray(a, b.dtype)) == _bits(b)

    jckpt.save(str(tmp_path / "j"), 2, j_state)
    got = ckpt.restore(str(tmp_path / "j"), 2, tree_map(torch.zeros_like, t_state),
                       device="cpu")
    for (n, a), (_, b) in zip(flatten_with_names(got), flatten_with_names(t_state)):
        assert a.dtype == b.dtype and _tbits(a) == _tbits(b), n
    ckpt.save(str(tmp_path / "t"), 2, t_state)
    back = jckpt.restore(str(tmp_path / "t"), 2, jax.eval_shape(lambda: j_state))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(j_state)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)
    manifests = [json.load(open(tmp_path / d / "step_000000002" / "manifest.json"))
                 for d in ("j", "t")]
    assert manifests[0] == manifests[1]


# ------------------------------------------------------------ launchers --

def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_and_resumes(tmp_path, arch):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", arch,
           "--batch", "4", "--seq", "16", "--save-every", "2", "--ckpt-dir", str(tmp_path)]
    first = subprocess.run(cmd + ["--steps", "3"], capture_output=True, text=True,
                           env=_env(), cwd=ROOT, timeout=120)
    assert first.returncode == 0, first.stderr
    assert f"arch={arch} family={get_config(arch).family}" in first.stdout
    losses = [float(l.split()[3]) for l in first.stdout.splitlines() if l.startswith("step")]
    assert losses and all(np.isfinite(losses))
    second = subprocess.run(cmd + ["--steps", "5"], capture_output=True, text=True,
                            env=_env(), cwd=ROOT, timeout=120)
    assert second.returncode == 0, second.stderr
    assert "resumed from step 2" in second.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_000000002", "step_000000004"]


def test_serve_launcher_serves_zamba():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--arch",
         "zamba2-7b", "--requests", "4"],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["completed"] == 4 and report["arch"] == "zamba2-7b"
    assert report["tokens_out"] == 4 * 11  # the first token of each comes from prefill
    cfg = get_config("zamba2-7b", smoke=True)
    assert report["cache_bytes"] == tkv.cache_bytes(tkv.init_cache(cfg, 4, 128, device="cpu"))
