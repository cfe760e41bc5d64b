"""Train a DLRM through the ReCross crossbar kernel (PyTorch port).

The counterpart of ``examples/train_dlrm.py``: a smoke-scale DLRM trained
on synthetic CTR data with plain SGD, its embedding reduction running
through the ReCross layout (the kernel path).  Gradients flow through
``ops.crossbar_reduce``'s backward into the permuted, replicated table
images, which are trained directly: they are the device-resident table.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train_dlrm [--steps 300]
    PYTHONPATH=src python -m repro_torch.launch.train_dlrm --device cpu --steps 60

The device defaults to ``cuda``; there is no fallback to the CPU, which
runs the kernels' plain versions only when asked for with ``--device cpu``.
:func:`train` takes any config, layouts and batch source, so a caller can
drive it at full width.  The module is import-safe: arguments are parsed
only under ``__main__``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import baselines, build_cooccurrence, compile_queries
from repro_torch.core.mapping import CrossbarLayout
from repro_torch.data import zipf_queries
from repro_torch.models.dlrm import DLRMConfig, bce_with_logits, dlrm_forward
from repro_torch.models.layers import Params

#: one step's input: per-table host queries, dense features, labels
Batch = Tuple[Dict[str, List[np.ndarray]], np.ndarray, np.ndarray]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the parameters and kernels")
    return ap.parse_args(argv)


def plan_layouts(cfg: DLRMConfig) -> Dict[str, CrossbarLayout]:
    """The example's offline phase: one ``recross_pipeline`` per table over
    a 256-query Zipf history."""
    layouts = {}
    for t in range(cfg.num_tables):
        hist = zipf_queries(cfg.rows_per_table, 256, 8.0, seed=100 + t)
        graph = build_cooccurrence(hist, cfg.rows_per_table)
        layouts[f"t{t}"], _ = baselines.recross_pipeline(
            graph, hist, group_size=cfg.group_size, dim=cfg.embed_dim
        )
    return layouts


def ctr_labels(qs: Dict[str, Sequence[np.ndarray]], dense: np.ndarray) -> np.ndarray:
    """The example's synthetic CTR rule: a label depends on how many tables'
    queries touch a hot item (id < 64) and on the first dense feature."""
    hot = sum((np.array([q.min() for q in tq]) < 64).astype(np.float32)
              for tq in qs.values())
    return (hot + dense[:, 0] > 1.0).astype(np.float32)


def synthetic_batch(cfg: DLRMConfig, step: int, batch: int,
                    rng: np.random.Generator) -> Batch:
    """The example's batch ``step``: Zipf queries per table, N(0, 1) dense
    features from ``rng``, CTR labels."""
    qs = {f"t{t}": zipf_queries(cfg.rows_per_table, batch, 8.0, seed=step * 7 + t)
          for t in range(cfg.num_tables)}
    dense = rng.normal(size=(batch, cfg.dense_features)).astype(np.float32)
    return qs, dense, ctr_labels(qs, dense)


def bag_indices(queries: Sequence[np.ndarray], max_bag: int) -> np.ndarray:
    """The dense path's input: ``(len(queries), max_bag)`` int32 row ids,
    each query's first ``max_bag`` ids, -1 padded."""
    idx = np.full((len(queries), max_bag), -1, np.int32)
    for i, q in enumerate(queries):
        take = np.asarray(q)[:max_bag]
        idx[i, : len(take)] = take
    return idx


def compile_sparse(layouts: Dict[str, CrossbarLayout], qs, *, device,
                   max_tiles: int | None = None) -> Dict[str, tuple]:
    """Per-table ``(tile_ids, bitmaps)`` of the layout/kernel paths."""
    sparse = {}
    for key, layout in layouts.items():
        cq = compile_queries(layout, qs[key], max_tiles=max_tiles, device=device)
        sparse[key] = (cq.tile_ids, cq.bitmaps)
    return sparse


def trainable_set(params: Params, images: Dict[str, torch.Tensor]) -> Params:
    """The example's trainable set: the images, the bottom and the top MLP,
    each a leaf that requires grad."""
    def leaf(t):
        return t.detach().requires_grad_(True)

    return {
        "images": {k: leaf(v) for k, v in images.items()},
        "bottom": [{k: leaf(v) for k, v in p.items()} for p in params["bottom"]],
        "top": [{k: leaf(v) for k, v in p.items()} for p in params["top"]],
    }


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a trainable set, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def loss_and_logits(tr: Params, cfg: DLRMConfig, dense, sparse, labels):
    """The example's loss: BCE with logits of the forward through the
    trainable images."""
    p = {"bottom": tr["bottom"], "top": tr["top"]}
    logits = dlrm_forward(p, cfg, dense, sparse, images=tr["images"])
    return bce_with_logits(logits, labels), logits


def train_step(tr: Params, cfg: DLRMConfig, dense, sparse, labels, *, lr: float):
    """One plain-SGD step; returns ``(loss, accuracy)`` as 0-d tensors.

    The parameters are updated in place under ``torch.no_grad()`` (the
    JAX example builds a new tree instead): at full width the images are
    gigabytes, and updating them where they lie needs no second copy.
    """
    loss, logits = loss_and_logits(tr, cfg, dense, sparse, labels)
    params = leaves(tr)
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g.to(p.dtype))
    acc = ((logits.detach() > 0) == (labels > 0.5)).float().mean()
    return loss.detach(), acc


@dataclasses.dataclass
class TrainStats:
    """Per-step record of :func:`train`, host clock in seconds."""

    losses: List[float] = dataclasses.field(default_factory=list)
    accs: List[float] = dataclasses.field(default_factory=list)
    step_s: List[float] = dataclasses.field(default_factory=list)
    compile_s: List[float] = dataclasses.field(default_factory=list)


def train(cfg: DLRMConfig, layouts: Dict[str, CrossbarLayout], tr: Params,
          batch_fn: Callable[[int], Batch], steps: int, *, lr: float, device,
          max_tiles: int | None = None, log_every: int = 50) -> TrainStats:
    """``steps`` SGD steps on ``batch_fn(step)``; prints the example's lines.

    A step's time runs from its query compile to its loss on the host
    (``.item()`` waits for the device); ``batch_fn`` is outside it.
    """
    stats = TrainStats()
    for step in range(steps):
        qs, dense_np, labels_np = batch_fn(step)
        t0 = time.perf_counter()
        sparse = compile_sparse(layouts, qs, device=device, max_tiles=max_tiles)
        t1 = time.perf_counter()
        dense = torch.from_numpy(dense_np).to(device)
        labels = torch.from_numpy(labels_np).to(device)
        loss, acc = train_step(tr, cfg, dense, sparse, labels, lr=lr)
        stats.losses.append(loss.item())
        stats.accs.append(acc.item())
        stats.step_s.append(time.perf_counter() - t0)
        stats.compile_s.append(t1 - t0)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:4d} bce {stats.losses[-1]:.4f} acc {stats.accs[-1]:.3f}",
                  flush=True)
    return stats


def main(args) -> TrainStats:
    from repro_torch.configs.dlrm_recross import smoke
    from repro_torch.models.dlrm import build_images, init_dlrm

    cfg = smoke()
    params = init_dlrm(torch.Generator().manual_seed(0), cfg, device=args.device)
    layouts = plan_layouts(cfg)
    tr = trainable_set(params, build_images(params, cfg, layouts))
    kcfg = dataclasses.replace(cfg, embedding_path="kernel")
    rng = np.random.default_rng(0)
    stats = train(
        kcfg, layouts, tr, lambda step: synthetic_batch(cfg, step, args.batch, rng),
        args.steps, lr=args.lr, device=args.device, max_tiles=32,
    )
    first, last = np.mean(stats.losses[:20]), np.mean(stats.losses[-20:])
    if not last < first:
        raise AssertionError("training did not improve")
    print("final-20 loss %.4f < first-20 loss %.4f  ✓ (trained through the "
          "ReCross kernel datapath)" % (last, first))
    return stats


if __name__ == "__main__":
    main(parse_args())
