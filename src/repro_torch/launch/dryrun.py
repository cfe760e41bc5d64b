"""Multi-pod dry run: every (arch × shape × mesh) cell on a fake world.

The port of ``repro.launch.dryrun``.  Proves the distribution config is
coherent without hardware.  The reference lowers and compiles each
cell's train or serve step from ``ShapeDtypeStruct``s for 256 (16 × 16)
and 512 (2 × 16 × 16) host devices.  The port runs the same step once, as
rank 0 of a ``fake`` process group of that many ranks, on meta-device
DTensors: parameters (``init_lm(..., device="meta")``), optimizer state,
batch and cache are laid out by the reference's specs and never
allocated; each collective is issued and counted, and moves nothing.
The program is SPMD, so rank 0's counts are every rank's.

``FakeStore`` comes from ``torch.testing._internal.distributed.fake_pg``,
which is not public API; it is pinned to the torch versions the port runs
on (2.11 on the card, 2.13 on the CPU).  ``init_device_mesh`` wants the
world to match the mesh, so each cell starts a fake world of its mesh's
size and ends it; a started world of another backend refuses.

Each cell's JSON record has the reference's keys.  ``memory_analysis``
is per device: ``argument_size_gib`` each input's local shard on one
rank (parameters, optimizer state, batch, cache, from their placements),
``output_size_gib`` each output's, ``alias_size_gib`` the donated state
or cache the outputs replace, and ``temp_size_gib`` the peak of the
local bytes the step made and held (``StepCounter.peak_bytes``, outputs
included while they live): a tracked peak of live tensors, not XLA's
buffer assignment.  ``roofline`` is :func:`repro_torch.launch.roofline.
analyse` over the step's counts with the analytic terms, and
``compile_seconds`` the seconds the cell took.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch grok-1-314b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dlrm-recross --mesh single

Results are cached as JSON under ``build/dryrun/`` (one file per cell);
``--force`` recomputes.  ``python -m repro_torch.launch.report`` renders
them.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, supported_shapes
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import (
    LOGICAL_RULES_MULTI_POD,
    LOGICAL_RULES_SINGLE_POD,
    P,
    _map_with_path,
    _mesh_axis_sizes,
    activation_sharding_ctx,
    batch_local,
    distribute_tree,
    map_specs,
    param_specs_for,
    place,
    sanitize_spec,
    sanitize_specs_tree,
    shard_index,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.layers import tree_leaves, tree_map

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")

# decode cells for huge KV caches use a bounded cache window per shape
DECODE_WINDOW = {"long_500k": 4096}


def pick_microbatches(cfg: ModelConfig, shape: ShapeConfig, dp: int,
                      *, target_gib: float = 9.0) -> int:
    """Grad-accumulation factor so saved activations fit next to params.

    Estimate: remat keeps ~4 residual-stream-sized tensors per layer per
    microbatch (layer input carry + attention/MLP block I/O), bf16.
    """
    b_local = max(shape.global_batch // dp, 1)
    per_mb_gib = (
        cfg.num_layers * b_local * shape.seq_len * cfg.d_model * 2 * 4 / 2**30
    )
    mb = 1
    while per_mb_gib / mb > target_gib and mb < shape.global_batch // dp and mb < 64:
        mb *= 2
    return mb


def pick_optimizer(cfg: ModelConfig):
    """Adafactor for ≥30B params (optimizer bytes/chip), AdamW otherwise."""
    from repro_torch.train.optimizer import Adafactor, AdamW, make_schedule

    sched = make_schedule(cfg.schedule, 3e-4, 10_000)
    if cfg.param_count() >= 30e9:
        return Adafactor(schedule=sched)
    return AdamW(schedule=sched)


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-device stand-ins (the reference's ``ShapeDtypeStruct``s) for
    every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        s = 1  # one new token against a seq_len cache
    toks = (b, cfg.num_codebooks, s) if cfg.family == "audio" else (b, s)
    out = {"tokens": _meta(toks)}
    if shape.kind == "train":
        out["labels"] = _meta(toks)
    if cfg.family == "vlm":
        out["enc"] = _meta((b, cfg.num_image_tokens, cfg.d_model), cfg.torch_dtype)
    return out


# ------------------------------------------------------ sharding of state --


def _dp_axis(rules):
    return rules["batch"]


def batch_specs(batch_avals, rules, mesh):
    """A spec for each batch leaf: the leading (batch) dim over the dp axes,
    sanitized against its shape."""
    dp = _dp_axis(rules)

    def spec(a):
        parts = [dp] + [None] * (len(a.shape) - 1)
        return sanitize_spec(P(*parts), a.shape, mesh)

    return tree_map(spec, batch_avals)


def opt_state_specs(opt_state_avals, params_specs, mesh):
    """Moments inherit param specs; factored/absent dims fall back cleanly.

    Covers the port's ``AdamWState`` (``mu``, ``nu``) and
    ``AdafactorState`` (``vr``, ``vc``); ``step`` replicates.  Each moment
    leaf takes its parameter's spec cut to its own rank, sanitized
    against its shape.
    """

    def for_moment_tree(tree_avals):
        return map_specs(lambda s, a: sanitize_spec(P(*list(s)[: len(a.shape)]), a.shape, mesh),
                         params_specs, tree_avals)

    if hasattr(opt_state_avals, "mu"):
        return type(opt_state_avals)(
            step=P(),
            mu=for_moment_tree(opt_state_avals.mu),
            nu=for_moment_tree(opt_state_avals.nu),
        )
    # Adafactor
    return type(opt_state_avals)(
        step=P(),
        vr=for_moment_tree(opt_state_avals.vr),
        vc=for_moment_tree(opt_state_avals.vc),
    )


_CACHE_MODEL_DIM_PRIORITY = {
    # key name -> candidate dims (index into shape) to shard by model.
    # K/V: kv-heads first, then SEQUENCE — never head_dim: a d-contracted
    # cache forces GSPMD to all-gather the whole cache every layer
    # (measured 98 GB/step on minicpm decode_32k, §Perf), while seq-sharded
    # caches reduce to output-sized psums.
    "k": (3, 2), "v": (3, 2), "k_scale": (3, 2), "v_scale": (3, 2), "pos": (),
    "h": (2, 3), "conv": (3,),
    "m_C": (2, 3), "m_n": (2, 3), "m_m": (2,),
    "s_c": (2,), "s_n": (2,), "s_h": (2,), "s_m": (2,),
}
_CACHE_BATCH_DIM = {
    "k": 1, "v": 1, "pos": 1, "h": 1, "conv": 1,
    "m_C": 1, "m_n": 1, "m_m": 1, "s_c": 1, "s_n": 1, "s_h": 1, "s_m": 1,
}


def cache_specs(cache_avals, rules, mesh, *, priority_override: dict | None = None):
    """A spec for each cache leaf, by its key: the batch dim over the dp
    axes, the first candidate dim the model axis divides over ``model``;
    ``len`` and scalars replicate."""
    sizes = _mesh_axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    dp = _dp_axis(rules)
    prio = dict(_CACHE_MODEL_DIM_PRIORITY)
    if priority_override:
        prio.update(priority_override)

    def visit(path, aval):
        key = next((p for p in reversed(path) if p is not None), None)
        shape = aval.shape
        if not shape or key in (None, "len"):
            return P()
        parts = [None] * len(shape)
        bdim = _CACHE_BATCH_DIM.get(key)
        if bdim is not None and bdim < len(shape):
            parts[bdim] = dp
        for cand in prio.get(key, ()):
            if cand < len(shape) and shape[cand] % model_n == 0 and parts[cand] is None:
                parts[cand] = "model"
                break
        return sanitize_spec(P(*parts), shape, mesh)

    return _map_with_path(visit, cache_avals)


# ------------------------------------------------------------ the world --


@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake`` process group of ``size`` ranks, this process rank 0,
    ended on exit; a running fake world of another size is ended first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} world is running; the dry run needs "
                               "a fake one")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_bytes(tree) -> int:
    """Bytes of every tensor leaf's local shard on this rank."""
    return sum(t.to_local().nbytes if hasattr(t, "to_local") else t.nbytes
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _memory(args, outs, alias, counter) -> dict:
    arg, out, temp = local_bytes(args), local_bytes(outs), counter.peak_bytes
    return {
        "argument_size_gib": arg / 2**30,
        "output_size_gib": out / 2**30,
        "temp_size_gib": temp / 2**30,
        "alias_size_gib": alias / 2**30,
        # donated outputs alias their arguments — subtract once
        "per_device_total_gib": (arg + out + temp - alias) / 2**30,
    }


# ------------------------------------------------------------- the cells --


def _cell_path(results_dir, cell_id):
    os.makedirs(results_dir, exist_ok=True)
    return os.path.join(results_dir, cell_id + ".json")


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool,
    results_dir: str = RESULTS_DIR,
    force: bool = False,
    remat: bool = True,
    variant: dict | None = None,
) -> dict:
    """One dry-run cell.  ``variant`` (hillclimb A/B knobs):
      name: str            — suffix for the result file
      rules: dict          — logical-rule overrides (e.g. {"seq": "model"} = SP)
      kv_quant: bool       — int8 KV cache (decode cells)
      readonly_cache: bool — batched-cache-write decode path
      cache_seq_shard: bool — K/V caches sharded on the sequence axis
      cfg_overrides: dict  — dataclasses.replace overrides on the ModelConfig
      microbatches: int    — force a grad-accumulation factor
      accum_bf16: bool     — accumulate microbatch gradients in bf16
    """
    variant = variant or {}
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    if variant.get("name"):
        cell_id += f"__{variant['name']}"
    out_path = _cell_path(results_dir, cell_id)
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    t0 = time.time()
    cfg = get_config(arch)
    if variant.get("cfg_overrides"):
        cfg = dataclasses.replace(cfg, **variant["cfg_overrides"])
    shape = SHAPES[shape_name]
    rules = LOGICAL_RULES_MULTI_POD if multi_pod else LOGICAL_RULES_SINGLE_POD
    if variant.get("rules"):
        rules = dict(rules, **variant["rules"])
    record = {
        "cell": cell_id, "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": 512 if multi_pod else 256, "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "kind": shape.kind,
    }
    with fake_world(record["chips"]):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        counter, memory, extra = cell_program(cfg, shape, shape_name, mesh, rules,
                                              remat=remat, variant=variant)
    record.update(extra)
    record["memory_analysis"] = memory
    record["roofline"] = _roofline(cfg, shape, shape_name, arch, mesh_name, record["chips"],
                                   counter, memory, remat=remat, variant=variant,
                                   optimizer=record.get("optimizer")).to_dict()
    record["compile_seconds"] = time.time() - t0
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def _roofline(cfg, shape, shape_name, arch, mesh_name, chips, counter, memory, *, remat,
              variant, optimizer):
    from repro_torch.launch.analytic import cell_cost
    from repro_torch.launch.roofline import analyse, model_flops_for

    cost_kw = {}
    if shape.kind == "train":
        cost_kw = {"remat": remat, "optimizer": (optimizer or "adamw").lower()}
    elif shape.kind == "decode":
        cost_kw = {"window": DECODE_WINDOW.get(shape_name)}
        if variant.get("kv_quant"):
            cost_kw["kv_dtype_bytes"] = 1.125
    acost = cell_cost(cfg, shape, **cost_kw)
    return analyse(
        arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips, counter=counter,
        bytes_per_device=memory["per_device_total_gib"] * 2**30,
        model_flops=model_flops_for(cfg, shape),
        analytic_flops=acost.flops, analytic_bytes=acost.hbm_bytes,
    )


def cell_program(cfg: ModelConfig, shape: ShapeConfig, shape_name: str, mesh, rules, *,
                 remat: bool = True, variant: dict | None = None, device="meta"):
    """Runs one cell's step on ``mesh`` (every rank of its world calls
    it) with parameters, state, batch and cache made on ``device``
    (``"meta"`` in the dry run; ``"cpu"`` to run the same program for
    real) and laid out by the reference's specs.  Returns ``(StepCounter,
    memory_analysis, record fields)``."""
    from repro_torch.launch.roofline import StepCounter
    from repro_torch.models.transformer import init_lm

    variant = variant or {}
    gen = torch.Generator().manual_seed(0)
    whole = init_lm(gen, cfg, device=device)
    p_specs = sanitize_specs_tree(param_specs_for(whole, rules, moe=cfg.moe is not None),
                                  whole, mesh)
    params = distribute_tree(whole, p_specs, mesh)
    # token ids 0 and zero embeddings: the step's work does not depend on them
    batch = tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype, device=device),
                     input_specs(cfg, shape))
    batch = distribute_tree(batch, batch_specs(batch, rules, mesh), mesh)
    counter = StepCounter()
    extra = {}
    with activation_sharding_ctx(mesh, rules):
        if shape.kind == "train":
            from repro_torch.train.loop import TrainState, make_train_step

            optimizer = pick_optimizer(cfg)
            opt_state = optimizer.init(whole)
            opt_state = distribute_tree(opt_state, opt_state_specs(opt_state, p_specs, mesh),
                                        mesh)
            state = TrainState(params, opt_state, distribute_tree(
                torch.zeros((), dtype=torch.int32, device=device), P(), mesh))
            sizes = _mesh_axis_sizes(mesh)
            dp_total = mesh.size() // sizes.get("model", 1)
            microbatches = variant.get("microbatches") or pick_microbatches(cfg, shape, dp_total)
            extra["microbatches"] = microbatches
            accum_dtype = torch.bfloat16 if variant.get("accum_bf16") else torch.float32
            step_fn = make_train_step(cfg, optimizer, remat=remat, microbatches=microbatches,
                                      has_enc=(cfg.family == "vlm"), accum_dtype=accum_dtype)
            args = (state, batch)
            with counter:
                new_state, metrics = step_fn(state, batch)
            outs, alias = (new_state, metrics), local_bytes(new_state)
            extra["optimizer"] = type(optimizer).__name__
        elif shape.kind == "prefill":
            from repro_torch.models.transformer import forward

            args = (params, batch)
            with torch.no_grad(), counter:
                logits, _ = forward(params, cfg, batch["tokens"], enc=batch.get("enc"))
            outs, alias = logits, 0
        else:  # decode
            from repro_torch.serve.decode import decode_step
            from repro_torch.serve.kvcache import init_cache

            window = DECODE_WINDOW.get(shape_name, shape.seq_len)
            kv_quant = bool(variant.get("kv_quant"))
            cache = init_cache(cfg, shape.global_batch, shape.seq_len, window=window,
                               quant=kv_quant, device=device)
            prio = None
            if variant.get("cache_seq_shard"):
                # shard K/V caches on the sequence axis: attention over
                # the cache contracts seq, so the collective payload is
                # output-sized psums instead of gathered caches
                prio = {"k": (2,), "v": (2,), "k_scale": (2,), "v_scale": (2,)}
            cache = distribute_tree(cache, cache_specs(cache, rules, mesh,
                                                       priority_override=prio), mesh)
            # fleet default: read-only-cache decode (batched cache writes)
            readonly = bool(variant.get("readonly_cache", True)) or kv_quant
            args = (params, cache, batch)
            with torch.no_grad(), counter:
                logits, cache = decode_step(params, cfg, batch["tokens"], cache,
                                            enc=batch.get("enc"), readonly_cache=readonly)
            # the cache is updated in place: it is the donated argument
            outs, alias = (logits, cache), local_bytes(cache)
    return counter, _memory(args, outs, alias, counter), extra


def run_dlrm_cell(*, multi_pod: bool, results_dir: str = RESULTS_DIR, force=False,
                  variant: dict | None = None) -> dict:
    """DLRM train-step dry-run (the paper's own model) on the big meshes.

    variant {"name": "hotrep", "hot_fraction": 0.02} enables the ReCross
    Eq.-1 replication applied as a SHARDING strategy: the hottest rows
    (remapped to low ids by the offline grouping phase) are stored
    REPLICATED across model shards — their gathers become collective-free;
    only the cold tail pays the sharded-gather exchange.  ``shardmap_bag``
    looks each table up on its own model shard and sums the partial bags
    with one all-reduce over ``"model"`` (``_smbag``).
    """
    variant = variant or {}
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"dlrm-recross__train_rec__{mesh_name}"
    if variant.get("name"):
        cell_id += f"__{variant['name']}"
    out_path = _cell_path(results_dir, cell_id)
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    t0 = time.time()
    chips = 512 if multi_pod else 256
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rules = LOGICAL_RULES_MULTI_POD if multi_pod else LOGICAL_RULES_SINGLE_POD
        counter, memory = dlrm_program(mesh, rules, variant)
    from repro_torch.launch.roofline import analyse

    rep = analyse(arch="dlrm-recross", shape="train_rec", mesh_name=mesh_name, chips=chips,
                  counter=counter)
    record = {
        "cell": cell_id, "arch": "dlrm-recross", "shape": "train_rec",
        "mesh": mesh_name, "chips": chips,
        "memory_analysis": {
            "per_device_total_gib": (memory["argument_size_gib"] + memory["output_size_gib"]
                                     + memory["temp_size_gib"]),
        },
        "roofline": rep.to_dict(),
        "compile_seconds": time.time() - t0,
    }
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    return record


DLRM_BATCH = 8192


def dlrm_program(mesh, rules, variant: dict | None = None, *, device="meta"):
    """The DLRM train step of ``run_dlrm_cell`` on ``mesh`` (every rank of
    its world calls it), its parameters and batch made on ``device``.
    Returns ``(StepCounter, memory_analysis)``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.configs.dlrm_recross import FULL as dcfg
    from repro_torch.launch.roofline import StepCounter
    from repro_torch.models.dlrm import init_dlrm

    variant = variant or {}
    hot_fraction = float(variant.get("hot_fraction", 0.0))
    dp = rules["batch"]
    R = dcfg.rows_per_table
    # pad tables to a 256 multiple so every sharding divides (standard)
    R = ((R + 255) // 256) * 256
    dcfg = dataclasses.replace(dcfg, rows_per_table=R)
    # hot rows occupy ids [0, H): the offline grouping phase remaps hot
    # groups to the head of the physical id space (frequency-descending),
    # so a Zipf-weighted query's lookups hit the replicated head w.p.
    # ~hot_coverage >> hot_fraction.
    H = int(R * hot_fraction)
    H = (H // 256) * 256

    params = init_dlrm(torch.Generator().manual_seed(0), dcfg, device=device)
    if H:
        params = dict(params, tables={k: {"hot": v[:H], "cold": v[H:]}
                                      for k, v in params["tables"].items()})

    def dlrm_spec(path, leaf):
        name = "/".join(str(p) for p in path)
        if "/hot" in name or name.endswith("hot"):
            return P()  # replicated hot shard — Eq.1 at the sharding level
        if "tables" in name:
            return sanitize_spec(P("model", None), leaf.shape, mesh)
        if name.endswith("/w"):
            return sanitize_spec(P(None, "model"), leaf.shape, mesh)
        return P()

    params = distribute_tree(params, _map_with_path(dlrm_spec, params), mesh)
    B = DLRM_BATCH
    batch = {
        "dense": torch.zeros((B, dcfg.dense_features), device=device),
        "labels": torch.zeros((B,), device=device),
        "sparse": {f"t{t}": torch.zeros((B, dcfg.max_bag), dtype=torch.int32, device=device)
                   for t in range(dcfg.num_tables)},
    }
    batch = distribute_tree(batch, tree_map(
        lambda a: sanitize_spec(P(*([dp] + [None] * (len(a.shape) - 1))), a.shape, mesh),
        batch), mesh)

    shardmap_bag = bool(variant.get("shardmap_bag"))
    names = list(mesh.mesh_dim_names)
    model_dims = [names.index("model")] if "model" in names else []

    def _smbag(table, idx):
        """Sharded embedding bag: each model shard reduces its local rows,
        one all-reduce over ``"model"`` of the (B_local, D) partials
        combines them — the collective payload is OUTPUT-sized (B·D), not
        TABLE-sized (a ``local_map``: the reference's ``shard_map``)."""
        index, _ = shard_index(mesh, model_dims)

        def local(table_loc, idx_loc):
            r_loc = table_loc.shape[0]
            rel = idx_loc.long() - index * r_loc
            ok = (rel >= 0) & (rel < r_loc) & (idx_loc >= 0)
            take = table_loc[rel.clamp(0, r_loc - 1)] * ok[..., None].to(table_loc.dtype)
            return take.sum(dim=1)

        t_pl = [Shard(0) if n == "model" else Replicate() for n in names]
        i_pl = [Shard(0) if p == Shard(0) else Replicate() for p in idx.placements]
        t_grad = [Shard(0) if n == "model" else Partial() if i_pl[i] == Shard(0)
                  else Replicate() for i, n in enumerate(names)]
        out_pl = [Partial() if n == "model" else i_pl[i] for i, n in enumerate(names)]
        out = local_map(local, out_placements=out_pl, in_placements=(t_pl, i_pl),
                        in_grad_placements=(t_grad, i_pl), redistribute_inputs=True)(table, idx)
        return place(out, mesh, [Replicate() if n == "model" else p
                                 for n, p in zip(names, out_pl)])

    def gather_bag(tables, idx):
        """Padded gather+sum on each rank's batch slice over whole tables
        (``batch_local`` gathers a sharded table): the hot/cold split when
        the replicated head is on."""
        def bag(t, ix):
            ix = ix.long()
            mask = (ix >= 0)[..., None].to(torch.float32)
            if H:
                hot, cold = t["hot"], t["cold"]
                is_hot = (ix < H) & (ix >= 0)
                e_hot = hot[ix.clamp(0, H - 1)] * is_hot[..., None]
                e_cold = cold[(ix - H).clamp(0, R - H - 1)] * (~is_hot)[..., None]
                return ((e_hot + e_cold) * mask).sum(dim=1)
            return (t[ix.clamp(0, R - 1)] * mask).sum(dim=1)

        return batch_local(bag, tables, idx)

    def embed_bag(table_p, idx):
        """Padded gather+sum; hot/cold split when replicated head enabled;
        the sharded bag when the smbag variant is on."""
        if H and shardmap_bag:
            # hot head: replicated, gathered locally with no collective;
            # cold tail: the sharded bag (all-reduce of output-sized partials)
            cold_idx = batch_local(
                lambda _, ix: torch.where((ix < H) | (ix < 0), -1, ix - H), {}, idx)
            e_hot = batch_local(
                lambda hot, ix: (hot[ix.long().clamp(0, H - 1)]
                                 * ((ix < H) & (ix >= 0))[..., None]).sum(dim=1),
                table_p["hot"], idx)
            return e_hot + _smbag(table_p["cold"], cold_idx)
        if shardmap_bag:
            return _smbag(table_p, idx)
        return gather_bag(table_p, idx)

    def interaction(_, stack, x):
        n = stack.shape[1]
        inter = torch.einsum("bnd,bmd->bnm", stack, stack)
        iu = torch.triu_indices(n, n, 1, device=stack.device)
        return torch.cat([x, inter[:, iu[0], iu[1]]], dim=-1)

    def loss_fn(p, b):
        x = b["dense"]
        for pl_ in p["bottom"]:
            x = torch.relu(x @ pl_["w"] + pl_["b"])
        embs = [x] + [embed_bag(p["tables"][f"t{t}"], b["sparse"][f"t{t}"])
                      for t in range(dcfg.num_tables)]
        top_in = batch_local(interaction, {}, torch.stack(embs, dim=1), x)
        for i, pl_ in enumerate(p["top"]):
            top_in = top_in @ pl_["w"] + pl_["b"]
            if i < len(p["top"]) - 1:
                top_in = torch.relu(top_in)
        logits = top_in[:, 0]
        labels = b["labels"]
        return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                          + torch.log1p(torch.exp(-torch.abs(logits))))

    counter = StepCounter()
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with activation_sharding_ctx(mesh, rules), counter:
        loss = loss_fn(live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves)
        new = [w.detach() - 1e-3 * g.to(w.dtype) for w, g in zip(leaves, grads)]
    return counter, _memory((params, batch), (new, loss), local_bytes(new), counter)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    args = ap.parse_args()

    archs = [args.arch] if args.arch else ARCH_IDS + ["dlrm-recross"]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        if arch == "dlrm-recross":
            for mp in meshes:
                try:
                    rec = run_dlrm_cell(multi_pod=mp, results_dir=args.results_dir,
                                        force=args.force)
                    print(f"OK  {rec['cell']}  ({rec['compile_seconds']:.0f}s)")
                except Exception as e:
                    failures.append(("dlrm-recross", str(e)))
                    traceback.print_exc()
            continue
        cfg = get_config(arch)
        shapes = [args.shape] if args.shape else supported_shapes(cfg)
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   results_dir=args.results_dir, force=args.force)
                    r = rec["roofline"]
                    print(
                        f"OK  {rec['cell']:60s} compile={rec['compile_seconds']:6.0f}s "
                        f"dom={r['dominant']:10s} frac={r['roofline_fraction']:.3f} "
                        f"mem/dev={rec['memory_analysis']['per_device_total_gib']:.1f}GiB"
                    )
                except Exception as e:
                    failures.append((f"{arch}/{shape}/mp={mp}", repr(e)))
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for cell, err in failures:
            print(" ", cell, err[:200])
        raise SystemExit(1)
    print("\nall requested dry-run cells passed")


if __name__ == "__main__":
    main()
