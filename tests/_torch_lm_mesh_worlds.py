"""Worlds of gloo ranks on the CPU for the port's LM mesh tests
(``tests/test_torch_sharded_lm.py``, ``tests/test_torch_pipeline_parallel.py``).

A world is ``size`` spawned processes on the default gloo group, each
running the same list of cases in order (:func:`_torch_mesh_worlds.
run_world`); a case builds its ``DeviceMesh`` over all ranks or the first
few (the others take part in making its groups, then idle) and rank 0
returns what the test checks.  Every value is computed from seeds on each
rank; the one-device values come from the port itself (they are held
against JAX elsewhere), so a rank imports no ``jax``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from _torch_mesh_worlds import run_cases, run_world


@dataclasses.dataclass
class World:
    rank: int


def _rank_main(rank, size, init_method, cases, results, timeout_s):
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    # the ranks share the host's cores: one intra-op thread each
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=size,
                            timeout=timedelta(seconds=timeout_s))
    try:
        run_cases(World(rank), cases, CASES, results, rank)
    finally:
        dist.destroy_process_group()


def run(size, cases, tmpdir, **kw):
    """``run_world`` with this module's ranks and cases."""
    return run_world(size, cases, tmpdir, rank_main=_rank_main, **kw)


# ------------------------------------------------------------- helpers --


def submesh(shape, names=("data", "model")):
    """A ``DeviceMesh`` of ``shape`` over the first ``prod(shape)`` ranks;
    every rank of the world must call it."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=names)


def in_mesh(world, shape) -> bool:
    return world.rank < math.prod(shape)


def lm_config(arch, impl=None):
    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=True)
    return dataclasses.replace(cfg, moe_impl=impl) if impl else cfg


def lm_batch(cfg, b=4, s=16, seed=1):
    import torch

    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return torch.from_numpy(tok), torch.from_numpy(lab)


def lm_params(cfg, seed=0):
    import torch

    from repro_torch.models.transformer import init_lm

    return init_lm(torch.Generator().manual_seed(seed), cfg)


def lm_enc(cfg, b=4, seed=2):
    """Seeded image embeddings ``(b, num_image_tokens, d_model)`` for a vlm
    config, else ``None``."""
    import torch

    if cfg.family != "vlm":
        return None
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (0.1 * rng.standard_normal((b, cfg.num_image_tokens, cfg.d_model))).astype(np.float32))


def one_device(cfg, params, tokens, labels, dp, enc=None):
    """``(logits, loss, grads)`` of the port on one device.  The shard-local
    MoE at ``dp`` data shards routes each shard's batch slice on its own,
    so its oracle is the one-device run on each slice: logits
    concatenated, loss and gradients averaged (equal slices)."""
    import torch

    from repro_torch.models.transformer import forward
    from repro_torch.train.loop import _value_and_grad

    if cfg.moe_impl != "shardmap" or dp == 1:
        loss, grads = _value_and_grad(cfg, params, tokens, labels, enc, False)
        return forward(params, cfg, tokens, enc=enc)[0], loss, grads
    from repro_torch.models.layers import tree_map

    b = tokens.shape[0] // dp
    parts = [_value_and_grad(cfg, params, tokens[i * b:(i + 1) * b],
                             labels[i * b:(i + 1) * b], None, False) for i in range(dp)]
    logits = torch.cat([forward(params, cfg, tokens[i * b:(i + 1) * b])[0] for i in range(dp)])
    loss = sum(l for l, _ in parts) / dp
    grads = tree_map(lambda *gs: sum(gs) / dp, *[g for _, g in parts])
    return logits, loss, grads


def on_mesh(cfg, params, tokens, labels, mesh, enc=None):
    """The same on ``mesh``: parameters by ``param_specs_for``, the batch by
    ``batch_specs``, inside the activation context."""
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.dryrun import batch_specs
    from repro_torch.models.transformer import forward
    from repro_torch.train.loop import _value_and_grad

    rules = sh.LOGICAL_RULES_SINGLE_POD
    dparams = sh.distribute_tree(
        params, sh.sanitize_specs_tree(sh.param_specs_for(params, rules), params, mesh), mesh)
    batch = {"tokens": tokens, "labels": labels}
    if enc is not None:
        batch["enc"] = enc
    batch = sh.distribute_tree(batch, batch_specs(batch, rules, mesh), mesh)
    with sh.activation_sharding_ctx(mesh, rules):
        logits, _ = forward(dparams, cfg, batch["tokens"], enc=batch.get("enc"))
        loss, grads = _value_and_grad(cfg, dparams, batch["tokens"], batch["labels"],
                                      batch.get("enc"), False)
    return dparams, logits, loss, grads


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# -------------------------------------------------------------- cases --


def case_lm(world, *, arch, shape, impl=None, s=16):
    """forward logits, ``lm_loss`` and its gradients on ``shape`` at ``s``
    tokens against the one-device port; the gradients' placements against
    the parameters', the loss's against replicated."""
    from torch.distributed.tensor import Replicate

    from repro_torch.models.layers import tree_leaves

    cfg = lm_config(arch, impl)
    params = lm_params(cfg)
    tokens, labels = lm_batch(cfg, s=s)
    enc = lm_enc(cfg)
    mesh = submesh(shape)
    if not in_mesh(world, shape):
        return None
    want_logits, want_loss, want_grads = one_device(cfg, params, tokens, labels, shape[0],
                                                    enc)
    dparams, logits, loss, grads = on_mesh(cfg, params, tokens, labels, mesh, enc)
    placements_kept = all(tuple(g.placements) == tuple(p.placements)
                          for g, p in zip(tree_leaves(grads), tree_leaves(dparams)))
    out = {
        "logits": _max_abs(logits.full_tensor(), want_logits),
        "loss": abs(float(loss.to_local()) - float(want_loss)),
        "grads": max(_max_abs(g.full_tensor(), w)
                     for g, w in zip(tree_leaves(grads), tree_leaves(want_grads))),
        "placements_kept": placements_kept,
        "loss_replicated": all(p == Replicate() for p in loss.placements) and loss.ndim == 0,
        "logits_placements": [str(p) for p in logits.placements],
    }
    return out if world.rank == 0 else None


def case_moe(world, *, shape, b=4, seed=3):
    """``apply_moe_shardmap`` on ``shape`` against its per-slice oracle:
    ``apply_moe`` on each data shard's batch slice, concatenated, and the
    mean of the slices' aux; gradients of ``sum(y * w) + aux`` too.  A
    batch ``b`` the data axis does not divide must raise: the exception's
    name comes back."""
    import torch

    from repro_torch.dist import sharding as sh
    from repro_torch.models.moe import apply_moe, apply_moe_shardmap, init_moe

    cfg = lm_config("granite-moe-3b-a800m")
    g = torch.Generator().manual_seed(seed)
    p = init_moe(g, cfg.d_model, cfg.d_ff, cfg.moe, cfg.act, torch.float32)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, 8, cfg.d_model)).astype(np.float32))
    wy = torch.from_numpy(rng.standard_normal((b, 8, cfg.d_model)).astype(np.float32))
    mesh = submesh(shape)
    if not in_mesh(world, shape):
        return None
    rules = sh.LOGICAL_RULES_SINGLE_POD
    if b % shape[0]:
        specs = sh.sanitize_specs_tree(sh.param_specs_for({"moe": p}, rules), {"moe": p}, mesh)
        with sh.activation_sharding_ctx(mesh, rules):
            try:
                apply_moe_shardmap(sh.distribute_tree(p, specs["moe"], mesh), x, cfg.moe,
                                   cfg.act)
            except Exception as e:  # noqa: BLE001 - the name is the result
                return {"raised": type(e).__name__} if world.rank == 0 else None
        return {"raised": None} if world.rank == 0 else None
    dp, b = shape[0], b // shape[0]
    names = sorted(p)

    live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    lx = x.detach().requires_grad_(True)
    ys, auxs = zip(*[apply_moe(live, lx[i * b:(i + 1) * b], cfg.moe, cfg.act)
                     for i in range(dp)])
    want_y, want_aux = torch.cat(ys), sum(auxs) / dp
    want_g = torch.autograd.grad((want_y * wy).sum() + want_aux, [lx] + [live[k] for k in names])

    specs = sh.sanitize_specs_tree(sh.param_specs_for({"moe": p}, rules), {"moe": p}, mesh)
    dp_ = {k: v.requires_grad_(True)
           for k, v in sh.distribute_tree(p, specs["moe"], mesh).items()}
    xd = sh.shard_tensor(x, mesh, sh.P("data", None, None)).detach().requires_grad_(True)
    with sh.activation_sharding_ctx(mesh, rules):
        y, aux = apply_moe_shardmap(dp_, xd, cfg.moe, cfg.act)
        obj = (y * sh.shard_tensor(wy, mesh, sh.P("data", None, None))).sum() + aux
    got_g = torch.autograd.grad(obj, [xd] + [dp_[k] for k in names])
    out = {"y": _max_abs(y.full_tensor(), want_y),
           "aux": abs(float(aux.to_local()) - float(want_aux)),
           "grads": max(_max_abs(a.full_tensor(), w) for a, w in zip(got_g, want_g))}
    return out if world.rank == 0 else None


def case_comms(world, *, arch, shape, impl=None, s=128):
    """Every collective of one ``_value_and_grad`` on ``shape`` at ``s``
    tokens (``launch.mesh_comms.measure``)."""
    from repro_torch.launch.mesh_comms import measure

    mesh = submesh(shape)
    if not in_mesh(world, shape):
        return None
    out = measure(arch, mesh, moe_impl=impl, s=s, top=None)
    return out if world.rank == 0 else None


def train_steps(cfg, state, step_fn, batches, mesh=None):
    """``step_fn`` over ``batches``; ``(state, losses, grad norms)``.  On a
    mesh each batch is laid out by ``batch_specs`` inside the context."""
    import contextlib

    from repro_torch.dist import sharding as sh
    from repro_torch.launch.dryrun import batch_specs

    rules = sh.LOGICAL_RULES_SINGLE_POD
    losses, norms = [], []
    ctx = sh.activation_sharding_ctx(mesh, rules) if mesh is not None else contextlib.nullcontext()
    with ctx:
        for tokens, labels in batches:
            batch = {"tokens": tokens, "labels": labels}
            if mesh is not None:
                batch = sh.distribute_tree(batch, batch_specs(batch, rules, mesh), mesh)
            state, m = step_fn(state, batch)
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
    return state, losses, norms


def case_adamw(world, *, arch, shape, steps=3, microbatches=1):
    """``steps`` AdamW steps on ``shape`` against the same steps off the
    mesh: losses, grad norms and the updated parameters.  With
    ``microbatches`` the mesh's microbatches are rows ``i, i + m, …`` of
    each rank's slice, the one device's contiguous slices."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import sharding as sh
    from repro_torch.launch.elastic_restart import state_specs
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamW

    cfg = lm_config(arch)
    opt = AdamW(schedule=lambda s: 1e-3)
    step_fn = make_train_step(cfg, opt, microbatches=microbatches)
    batches = [lm_batch(cfg, seed=10 + i) for i in range(steps)]
    mesh = submesh(shape)
    if not in_mesh(world, shape):
        return None
    state = init_train_state(lm_params(cfg), opt)
    want, want_l, want_n = train_steps(cfg, state, step_fn, batches)
    dstate = sh.distribute_tree(state, state_specs(state, mesh), mesh)
    got, got_l, got_n = train_steps(cfg, dstate, step_fn, batches, mesh)
    out = {
        "loss": max(abs(float(a.to_local()) - float(b)) for a, b in zip(got_l, want_l)),
        "grad_norm": max(abs(float(a.to_local()) - float(b)) for a, b in zip(got_n, want_n)),
        "params": max(_max_abs(a.full_tensor(), b)
                      for a, b in zip(tree_leaves(got.params), tree_leaves(want.params))),
        "moments": max(_max_abs(a.full_tensor(), b) for a, b in
                       zip(tree_leaves(got.opt_state.mu), tree_leaves(want.opt_state.mu))),
        "all_dtensor": all(isinstance(a, DTensor) for a in tree_leaves(got.params)),
    }
    return out if world.rank == 0 else None


def case_restore(world, *, ckpt_dir, jax_dir, shape_a=(2, 2), shape_b=(1, 2)):
    """A train state laid out on ``shape_a``, gathered and saved by rank 0,
    restored with ``shardings=`` onto ``shape_b``: rank 0 returns the
    restored ``full_tensor()``s and the saved ones by name, and the same
    for a parameter tree the JAX package wrote to ``jax_dir``."""
    import torch.distributed as dist

    from repro_torch.dist import sharding as sh
    from repro_torch.launch.elastic_restart import shardings_for, state_specs
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import init_train_state
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.tree import flatten_with_names

    cfg = lm_config("minicpm-2b")
    params = lm_params(cfg)
    state = init_train_state(params, AdamW(schedule=lambda s: 1e-3))
    mesh_a, mesh_b = submesh(shape_a), submesh(shape_b)
    dstate = sh.distribute_tree(state, state_specs(state, mesh_a), mesh_a)
    # perturb the moments so no leaf restores as zeros by accident
    dstate = dstate._replace(opt_state=dstate.opt_state._replace(
        mu=sh.map_specs(lambda s, m, p: m + p.float(), state_specs(state, mesh_a).params,
                        dstate.opt_state.mu, dstate.params)))
    host = sh.gather_tree(dstate)
    if world.rank == 0:
        ckpt.save(ckpt_dir, 3, host)
    dist.barrier()
    out = None
    if in_mesh(world, shape_b):
        restored = ckpt.restore(ckpt_dir, 3, host, shardings=shardings_for(host, mesh_b))
        p_layout = sh.map_specs(lambda s: (mesh_b, sh.to_placements(s, mesh_b)),
                                state_specs(state, mesh_b).params)
        from_jax = ckpt.restore(jax_dir, 0, params, shardings=p_layout)
        flat = flatten_with_names(restored)
        out = {
            "restored": {n: t.full_tensor().numpy() for n, t in flat},
            "saved": {n: t.numpy() for n, t in flatten_with_names(host)},
            "placements": {n: [str(p) for p in t.placements] for n, t in flat},
            "from_jax": {n: t.full_tensor().numpy() for n, t in flatten_with_names(from_jax)},
        }
    dist.barrier()
    return out if world.rank == 0 else None


def case_elastic(world, *, ckpt_dir, mesh_a=(2, 2), survivors=2):
    """``launch.elastic_restart.main`` on the CPU."""
    from repro_torch.launch import elastic_restart

    out = elastic_restart.main(device="cpu", mesh_a=mesh_a, survivors=survivors,
                               ckpt_dir=ckpt_dir)
    return out if world.rank == 0 else None


def stage_body(w_stage, h):
    """The reference example's stage: ``tanh(h @ w_l)`` over its layers."""
    import torch

    for wl in w_stage:
        h = torch.tanh(h @ wl)
    return h


def pipeline_inputs(S, M, MB, D, L, seed=0):
    import torch

    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((S, L, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    return torch.from_numpy(w), torch.from_numpy(x)


def sequential(w, x):
    """Every stage in order on one device, microbatch by microbatch."""
    import torch

    outs = []
    for m in range(x.shape[0]):
        h = x[m]
        for s in range(w.shape[0]):
            h = stage_body(w[s], h)
        outs.append(h)
    return torch.stack(outs)


def case_pipeline(world, *, S, shape, names, M=8, MB=16, D=64, L=3):
    """``pipelined_apply`` on a mesh with a ``"stage"`` axis of ``S``
    against the sequential product; the largest error over every rank
    (each rank returns the outputs)."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.pipeline_parallel import pipelined_apply

    mesh = submesh(shape, names)
    w, x = pipeline_inputs(S, M, MB, D, L)
    err = torch.tensor(0.0)
    if in_mesh(world, shape):
        out = pipelined_apply(w, x, stage_body, mesh)
        err = (out - sequential(w, x)).abs().max()
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return float(err) if world.rank == 0 else None


def case_chunked(world, *, arch, shape, s=32, chunk=8, window=0, seed=4):
    """``chunked_self_attention`` at ``chunk``-token query and key blocks
    on ``shape`` against the one-device port: the output and the
    gradients of ``sum(y * w)`` for x and every weight."""
    import torch

    from repro_torch.dist import sharding as sh
    from repro_torch.models.attention import chunked_self_attention, init_attention

    cfg = lm_config(arch)
    hd = cfg.resolved_head_dim
    p = init_attention(torch.Generator().manual_seed(seed), cfg.d_model, cfg.num_heads,
                       cfg.kv_heads, hd, torch.float32)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((4, s, cfg.d_model)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, s, cfg.d_model)).astype(np.float32))
    mesh = submesh(shape)
    if not in_mesh(world, shape):
        return None
    kw = dict(num_heads=cfg.num_heads, kv_heads=cfg.kv_heads, head_dim=hd, q_chunk=chunk,
              k_chunk=chunk, window=window)
    names = sorted(p)

    def run(p, x, w):
        live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        lx = x.detach().requires_grad_(True)
        y = chunked_self_attention(live, lx, **kw)
        return y, torch.autograd.grad((y * w).sum(), [lx] + [live[k] for k in names])

    want_y, want_g = run(p, x, w)
    rules = sh.LOGICAL_RULES_SINGLE_POD
    specs = sh.sanitize_specs_tree(sh.param_specs_for({"attn": p}, rules), {"attn": p}, mesh)
    dp_ = sh.distribute_tree(p, specs["attn"], mesh)
    bs = sh.P("data", None, None)
    with sh.activation_sharding_ctx(mesh, rules):
        y, g = run(dp_, sh.shard_tensor(x, mesh, bs), sh.shard_tensor(w, mesh, bs))
    out = {"y": _max_abs(y.full_tensor(), want_y),
           "grads": max(_max_abs(a.full_tensor(), b) for a, b in zip(g, want_g))}
    return out if world.rank == 0 else None


def decode_run(cfg, params, steps, *, max_seq=16, quant=False, readonly=True, mesh=None,
               prio=None, b=4, seed=5):
    """``steps`` decode steps from an empty cache: the logits of each and
    the final cache.  On ``mesh`` the parameters, the cache
    (``cache_specs``, ``prio`` its override), the tokens and ``enc`` are
    laid out by the dry run's specs, inside the activation context."""
    import contextlib

    import torch

    from repro_torch.dist import sharding as sh
    from repro_torch.launch.dryrun import batch_specs, cache_specs
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import init_cache

    rng = np.random.default_rng(seed)
    shape = (b, cfg.num_codebooks, 1) if cfg.family == "audio" else (b, 1)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32))
            for _ in range(steps)]
    enc = None
    if cfg.family == "vlm":
        enc = torch.from_numpy(rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
    cache = init_cache(cfg, b, max_seq, quant=quant, device="cpu")
    rules = sh.LOGICAL_RULES_SINGLE_POD
    ctx = contextlib.nullcontext()
    if mesh is not None:
        params = sh.distribute_tree(params, sh.sanitize_specs_tree(
            sh.param_specs_for(params, rules), params, mesh), mesh)
        cache = sh.distribute_tree(cache, cache_specs(cache, rules, mesh,
                                                      priority_override=prio), mesh)
        toks = [sh.distribute_tree(t, batch_specs(t, rules, mesh), mesh) for t in toks]
        if enc is not None:
            enc = sh.distribute_tree(enc, batch_specs(enc, rules, mesh), mesh)
        ctx = sh.activation_sharding_ctx(mesh, rules)
    logits = []
    with ctx, torch.no_grad():
        for t in toks:
            out, cache = decode_step(params, cfg, t, cache, enc=enc, readonly_cache=readonly)
            logits.append(out)
    return logits, cache


def case_decode(world, *, arch, shape, steps=3, quant=False, readonly=True, prio=None):
    """``steps`` decode steps on ``shape`` against the one-device port: the
    logits of every step and every leaf of the final cache."""
    from repro_torch.dist import sharding as sh
    from repro_torch.models.layers import tree_leaves

    cfg = lm_config(arch)
    params = lm_params(cfg)
    mesh = submesh(shape)
    if not in_mesh(world, shape):
        return None
    kw = dict(quant=quant, readonly=readonly)
    want_l, want_c = decode_run(cfg, params, steps, **kw)
    got_l, got_c = decode_run(cfg, params, steps, mesh=mesh, prio=prio, **kw)
    got_c = sh.gather_tree(got_c)
    out = {"logits": max(_max_abs(a.full_tensor(), b) for a, b in zip(got_l, want_l)),
           "cache": max(_max_abs(a, b) for a, b in zip(tree_leaves(got_c),
                                                          tree_leaves(want_c))),
           "placements": sorted({str(t.placements) for t in tree_leaves(got_l)})}
    return out if world.rank == 0 else None


def case_cell(world, *, arch, shape_name, s, b, shape=(2, 2)):
    """The dry run's program of one cell (``dryrun.cell_program``) at
    ``arch``'s smoke config and ``(b, s)`` on CPU tensors: its FLOPs,
    bytes and collectives by kind."""
    from repro_torch.configs import SHAPES, ShapeConfig
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.dryrun import cell_program

    cfg = lm_config(arch)
    mesh = submesh(shape)
    if not in_mesh(world, shape):
        return None
    shp = ShapeConfig(shape_name, s, b, SHAPES[shape_name].kind)
    counter, memory, _ = cell_program(cfg, shp, shape_name, mesh, sh.LOGICAL_RULES_SINGLE_POD,
                                      device="cpu")
    out = {"flops": counter.flops, "bytes": counter.bytes, "breakdown": counter.breakdown(),
           "argument_size_gib": memory["argument_size_gib"]}
    return out if world.rank == 0 else None


CASES = {"lm": case_lm, "chunked": case_chunked, "decode": case_decode, "cell": case_cell, "moe": case_moe, "comms": case_comms, "adamw": case_adamw, "restore": case_restore,
         "elastic": case_elastic, "pipeline": case_pipeline}
