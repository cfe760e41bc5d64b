"""DLRM parity on the CPU: the port's model and SGD trainer against
``repro.models.dlrm`` and ``examples/train_dlrm.py``'s step, at the
smoke config, with JAX's ``init_dlrm`` parameters carried across by
``repro_torch.convert``.

Tolerance: logits, losses and gradients atol 1e-5, rtol 1e-4 — both sides
are float32, but XLA and torch sum the matmuls in different orders.  The
JAX kernel path runs ``crossbar_reduce_pallas`` in interpret mode; the
port's runs the kernel's plain version (CPU tensors).
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

from repro.configs import dlrm_recross as j_configs
from repro.core import baselines as j_baselines
from repro.core import build_cooccurrence as j_build_cooccurrence
from repro.core.reduction import compile_queries as j_compile_queries
from repro.data import zipf_queries
from repro.models import dlrm as jdlrm
from repro_torch.configs import dlrm_recross as t_configs
from repro_torch.convert import dlrm_params_from_numpy
from repro_torch.launch import train_dlrm as tl
from repro_torch.models import dlrm as tdlrm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-4)
BATCH = 16
MAX_TILES = 32  # the example's, so every JAX step reuses one compile
LR = 1e-2


def _tree_pairs(a, b, path="root"):
    """(path, leaf_a, leaf_b) over two trees of one structure."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in sorted(a):
            yield from _tree_pairs(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _tree_pairs(x, y, f"{path}[{i}]")
    else:
        yield path, a, b


@pytest.fixture(scope="module")
def model():
    """JAX parameters, layouts planned by each package the example's way,
    images built by each package."""
    cfg = j_configs.smoke()
    params = jdlrm.init_dlrm(jax.random.PRNGKey(0), cfg)
    j_layouts = {}
    for t in range(cfg.num_tables):
        hist = zipf_queries(cfg.rows_per_table, 256, 8.0, seed=100 + t)
        graph = j_build_cooccurrence(hist, cfg.rows_per_table)
        j_layouts[f"t{t}"], _ = j_baselines.recross_pipeline(
            graph, hist, group_size=cfg.group_size, dim=cfg.embed_dim
        )
    tcfg = t_configs.smoke()
    t_layouts = tl.plan_layouts(tcfg)
    t_params = dlrm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return {
        "cfg": cfg, "tcfg": tcfg, "params": params, "t_params": t_params,
        "j_layouts": j_layouts, "t_layouts": t_layouts,
        "j_images": jdlrm.build_images(params, cfg, j_layouts),
        "t_images": tdlrm.build_images(t_params, tcfg, t_layouts),
    }


def _batch(m, step):
    """The example's batch ``step`` (queries cut to ``max_bag`` so the
    dense path sees the same bags), as inputs of both packages."""
    rng = np.random.default_rng(1000 + step)
    qs, dense, labels = tl.synthetic_batch(m["tcfg"], step, BATCH, rng)
    qs = {k: [q[: m["cfg"].max_bag] for q in v] for k, v in qs.items()}
    j_sparse, j_idx, t_idx = {}, {}, {}
    for key in qs:
        cq = j_compile_queries(m["j_layouts"][key], qs[key], max_tiles=MAX_TILES)
        j_sparse[key] = (cq.tile_ids, cq.bitmaps)
        idx = tl.bag_indices(qs[key], m["cfg"].max_bag)
        j_idx[key], t_idx[key] = jnp.asarray(idx), torch.from_numpy(idx)
    t_sparse = tl.compile_sparse(m["t_layouts"], qs, device="cpu", max_tiles=MAX_TILES)
    return {
        "j": (jnp.asarray(dense), j_sparse, j_idx, jnp.asarray(labels)),
        "t": (torch.from_numpy(dense), t_sparse, t_idx, torch.from_numpy(labels)),
    }


def test_configs_identical():
    assert dataclasses.asdict(t_configs.FULL) == dataclasses.asdict(j_configs.FULL)
    assert dataclasses.asdict(t_configs.smoke()) == dataclasses.asdict(j_configs.smoke())


def test_convert_is_bit_for_bit_and_init_has_jax_shapes(model):
    params, t_params = model["params"], model["t_params"]
    for path, a, b in _tree_pairs(jax.tree.map(np.asarray, params), t_params):
        assert b.dtype == torch.float32, path
        np.testing.assert_array_equal(a, b.numpy(), err_msg=path)
    own = tdlrm.init_dlrm(torch.Generator().manual_seed(0), model["tcfg"], device="cpu")
    for path, a, b in _tree_pairs(t_params, own):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    # the same distribution: N(0, 1) cut at ±3 (std 0.98658) times 1/√d_in
    unit = []
    for layer in own["bottom"] + own["top"]:
        w = layer["w"] * np.sqrt(layer["w"].shape[0])
        assert float(w.abs().max()) <= 3.0 + 1e-5
        assert not layer["b"].any()
        unit.append(w.reshape(-1))
    assert abs(float(torch.cat(unit).std()) - 0.98658) < 0.03
    assert abs(float(own["tables"]["t0"].std()) - 0.01) < 5e-4


def test_layouts_and_images_bit_identical(model):
    for key, jl in model["j_layouts"].items():
        tl_ = model["t_layouts"][key]
        for f in dataclasses.fields(jl):
            np.testing.assert_array_equal(
                np.asarray(getattr(jl, f.name)), np.asarray(getattr(tl_, f.name)),
                err_msg=f"{key}.{f.name}",
            )
        np.testing.assert_array_equal(
            np.asarray(model["j_images"][key]), model["t_images"][key].numpy()
        )


@pytest.mark.parametrize("path", ["dense", "layout", "kernel"])
def test_forward_matches_jax(model, path):
    b = _batch(model, 0)
    jd, js, jidx, _ = b["j"]
    td, ts, tidx, _ = b["t"]
    jcfg = dataclasses.replace(model["cfg"], embedding_path=path)
    tcfg = dataclasses.replace(model["tcfg"], embedding_path=path)
    want = jdlrm.dlrm_forward(model["params"], jcfg, jd, jidx if path == "dense" else js,
                              images=model["j_images"])
    got = tdlrm.dlrm_forward(model["t_params"], tcfg, td, tidx if path == "dense" else ts,
                             images=model["t_images"])
    assert got.shape == (BATCH,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_port_paths_agree_and_loss_matches_jax(model):
    b = _batch(model, 1)
    td, ts, tidx, tlab = b["t"]
    jd, js, _, jlab = b["j"]
    logits = {}
    for path in ("dense", "layout", "kernel"):
        cfg = dataclasses.replace(model["tcfg"], embedding_path=path)
        logits[path] = tdlrm.dlrm_forward(model["t_params"], cfg, td,
                                          tidx if path == "dense" else ts,
                                          images=model["t_images"])
    for path in ("layout", "kernel"):
        np.testing.assert_allclose(logits[path].numpy(), logits["dense"].numpy(), **TOL)
    kcfg = dataclasses.replace(model["tcfg"], embedding_path="kernel")
    loss = tdlrm.dlrm_loss(model["t_params"], kcfg, td, ts, tlab, images=model["t_images"])
    want = jdlrm.dlrm_loss(model["params"], dataclasses.replace(model["cfg"],
                           embedding_path="kernel"), jd, js, jlab, images=model["j_images"])
    np.testing.assert_allclose(loss.item(), float(want), **TOL)


def _jax_step_fn(model):
    """The example's jitted ``value_and_grad`` and SGD update."""
    kcfg = dataclasses.replace(model["cfg"], embedding_path="kernel")

    def loss_fn(tr, dense, sparse, labels):
        p = {"tables": model["params"]["tables"], "bottom": tr["bottom"], "top": tr["top"]}
        logits = jdlrm.dlrm_forward(p, kcfg, dense, sparse, images=tr["images"])
        return jnp.mean(
            jnp.maximum(logits, 0) - logits * labels
            + jnp.log1p(jnp.exp(-jnp.abs(logits)))
        )

    @jax.jit
    def step_fn(tr, dense, sparse, labels):
        loss, grads = jax.value_and_grad(loss_fn)(tr, dense, sparse, labels)
        new = jax.tree.map(lambda p, g: p - LR * g.astype(p.dtype), tr, grads)
        return new, loss, grads

    return step_fn


def _trainables(model):
    j_tr = {"images": model["j_images"], "bottom": model["params"]["bottom"],
            "top": model["params"]["top"]}
    t_tr = tl.trainable_set(model["t_params"], model["t_images"])
    return j_tr, t_tr


def test_one_step_loss_and_every_gradient_match_jax(model):
    step_fn = _jax_step_fn(model)
    j_tr, t_tr = _trainables(model)
    jd, js, _, jlab = _batch(model, 0)["j"]
    td, ts, _, tlab = _batch(model, 0)["t"]
    _, j_loss, j_grads = step_fn(j_tr, jd, js, jlab)
    kcfg = dataclasses.replace(model["tcfg"], embedding_path="kernel")
    loss, _ = tl.loss_and_logits(t_tr, kcfg, td, ts, tlab)
    grads = torch.autograd.grad(loss, tl.leaves(t_tr))
    np.testing.assert_allclose(loss.item(), float(j_loss), **TOL)
    # leaves() walks the tree in sorted-key order, as _tree_pairs does
    pairs = list(_tree_pairs(jax.tree.map(np.asarray, j_grads), t_tr))
    assert len(pairs) == len(grads)
    for (path, gj, _), gt in zip(pairs, grads):
        assert gt.shape == gj.shape, path
        np.testing.assert_allclose(gt.numpy(), gj, err_msg=path, **TOL)
    assert any(float(np.abs(g).max()) > 0 for p, g, _ in pairs if "images" in p)


def test_five_sgd_steps_follow_jax_trajectory(model):
    step_fn = _jax_step_fn(model)
    j_tr, t_tr = _trainables(model)
    kcfg = dataclasses.replace(model["tcfg"], embedding_path="kernel")
    for step in range(5):
        b = _batch(model, step)
        j_tr, j_loss, _ = step_fn(j_tr, b["j"][0], b["j"][1], b["j"][3])
        loss, _ = tl.train_step(t_tr, kcfg, b["t"][0], b["t"][1], b["t"][3], lr=LR)
        np.testing.assert_allclose(loss.item(), float(j_loss), err_msg=f"step {step}", **TOL)
    for path, a, b in _tree_pairs(jax.tree.map(np.asarray, j_tr), t_tr):
        np.testing.assert_allclose(b.detach().numpy(), a, err_msg=path, **TOL)


def test_trainer_cpu_subprocess():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_dlrm", "--device", "cpu",
         "--steps", "60"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "step    0 bce" in proc.stdout and "step   59 bce" in proc.stdout
    assert "✓ (trained through the ReCross kernel datapath)" in proc.stdout
