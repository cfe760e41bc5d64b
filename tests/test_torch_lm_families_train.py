"""Training of the moe, vlm and audio families against the JAX package, on
the CPU: the train and eval steps, a moe checkpoint across packages, and
the training launcher.

Inputs as in ``tests/test_torch_lm_families.py`` (smoke configs in
float32, JAX's parameters and ``TrainState`` carried across by
``repro_torch.convert``, vlm gates at 0.5, image embeddings N(0, 0.1²)).

Tolerances are ``tests/test_torch_train.py``'s: the train step's loss,
grad norm, parameters and optimizer state atol and rtol 1e-4 over 2
steps; the eval loss the same; checkpoints bit for bit.
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
from repro_torch.convert import train_state_from_numpy
from repro_torch.launch import train as ltrain
from repro_torch.models.layers import tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import flatten_with_names

from _torch_lm_families_cases import _j, _t, lm_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = dict(atol=1e-4, rtol=1e-4)


def _host(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_trees_close(port, ref, **tol):
    """Leaf by leaf, matched by JAX's path names."""
    got = {k.replace(".", ""): v for k, v in flatten_with_names(port)}
    want = {jax.tree_util.keystr(p, simple=True, separator="/").replace(".", ""): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(_host(got[name]).astype(np.float32),
                                   np.asarray(want[name], np.float32), err_msg=name, **tol)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "llama-3.2-vision-11b",
                                  "musicgen-medium"])
def test_train_step_matches_jax(arch, microbatches):
    j_cfg, cfg, jp, _, tokens, labels, enc = lm_case(arch, b=4, s=16)
    has_enc = enc is not None
    j_o = jopt.AdamW(schedule=jopt.make_schedule("cosine", 3e-3, 20))
    t_o = topt.AdamW(schedule=topt.make_schedule("cosine", 3e-3, 20))
    j_state = jloop.init_train_state(jp, j_o)
    t_state = train_state_from_numpy(jax.tree.map(np.asarray, j_state), "cpu")
    j_step = jax.jit(jloop.make_train_step(j_cfg, j_o, microbatches=microbatches,
                                           has_enc=has_enc))
    t_step = tloop.make_train_step(cfg, t_o, microbatches=microbatches, has_enc=has_enc)
    j_batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    t_batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    if has_enc:
        j_batch["enc"], t_batch["enc"] = _j(enc), _t(enc)
    for _ in range(2):
        j_state, jm = j_step(j_state, j_batch)
        t_state, tm = t_step(t_state, t_batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), err_msg=key, **STEP_TOL)
    assert int(t_state.step) == int(j_state.step) == 2
    assert_trees_close(t_state, j_state, **STEP_TOL)


def test_eval_step_with_enc_matches_jax():
    j_cfg, cfg, jp, tp, tokens, labels, enc = lm_case("llama-3.2-vision-11b")
    want = jloop.make_eval_step(j_cfg, has_enc=True)(
        jp, {"tokens": tokens, "labels": labels, "enc": jnp.asarray(enc)})
    got = tloop.make_eval_step(cfg, has_enc=True)(
        tp, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels),
             "enc": torch.from_numpy(enc)})
    np.testing.assert_allclose(float(got), float(want), **STEP_TOL)
    # without has_enc the batch's enc is not read: the vlm forward refuses
    with pytest.raises(ValueError, match="enc"):
        tloop.make_eval_step(cfg)(tp, {"tokens": torch.from_numpy(tokens),
                                       "labels": torch.from_numpy(labels)})


def _tbits(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.element_size(), tuple(t.shape), t.numpy().tobytes()


def _bits(x):
    a = np.asarray(x)
    return a.dtype.itemsize, a.shape, a.tobytes()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_moe_checkpoint_crosses_packages_bit_for_bit(tmp_path, dtype):
    jp = lm_case("granite-moe-3b-a800m")[2]
    params = jax.tree_util.tree_map_with_path(   # the router stays float32
        lambda path, x: x if "router" in jax.tree_util.keystr(path) else x.astype(dtype), jp)
    opt = jopt.AdamW(schedule=lambda s: 1e-3)
    state = jloop.init_train_state(params, opt)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    new_p, new_o = jax.jit(opt.update)(grads, state.opt_state, state.params)
    j_state = jloop.TrainState(new_p, new_o, state.step + 1)
    t_state = train_state_from_numpy(jax.tree.map(np.asarray, j_state), "cpu")
    assert [n for n, _ in flatten_with_names(t_state)] == jckpt._flatten_with_names(j_state)[0]
    assert t_state.params["layers"]["moe"]["router"].dtype == torch.float32

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


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "llama-3.2-vision-11b",
                                  "musicgen-medium"])
def test_make_batch_follows_the_jax_launcher(arch):
    cfg = lm_case(arch)[1]
    tokens = np.arange(12, dtype=np.int32).reshape(3, 4)
    batch = ltrain.make_batch(cfg, tokens, tokens + 1, "cpu")
    if cfg.family == "audio":
        assert batch["tokens"].shape == (3, cfg.num_codebooks, 4)
        assert all(torch.equal(batch["labels"][:, c], torch.from_numpy(tokens + 1))
                   for c in range(cfg.num_codebooks))
    else:
        assert torch.equal(batch["tokens"], torch.from_numpy(tokens))
    if cfg.family == "vlm":
        assert batch["enc"].shape == (3, cfg.num_image_tokens, cfg.d_model)
        assert batch["enc"].dtype == cfg.torch_dtype and not batch["enc"].any()
    else:
        assert "enc" not in batch


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "llama-3.2-vision-11b",
                                  "musicgen-medium"])
def test_launcher_runs_and_resumes(tmp_path, arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", arch,
           "--batch", "4", "--seq", "16", "--save-every", "2", "--ckpt-dir", str(tmp_path)]
    first = subprocess.run(cmd + ["--steps", "3"], capture_output=True, text=True,
                           env=env, cwd=ROOT, timeout=120)
    assert first.returncode == 0, first.stderr
    family = lm_case(arch)[1].family
    assert f"arch={arch} family={family}" in first.stdout
    losses = [float(l.split()[3]) for l in first.stdout.splitlines() if l.startswith("step")]
    assert losses and all(np.isfinite(losses))
    assert sorted(os.listdir(tmp_path)) == ["step_000000002"]
    second = subprocess.run(cmd + ["--steps", "5"], capture_output=True, text=True,
                            env=env, cwd=ROOT, timeout=120)
    assert second.returncode == 0, second.stderr
    assert "resumed from step 2" in second.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_000000002", "step_000000004"]
