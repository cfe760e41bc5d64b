"""Training launcher: ``python -m repro_torch.launch.train [--arch <id>]``.

The counterpart of ``repro.launch.train``: the deterministic, host-sharded
token pipeline (``TokenBatcher``), the train step (``lm_loss`` with
autograd, AdamW, gradient accumulation over ``--microbatches``),
auto-resume from the latest committed checkpoint in ``--ckpt-dir``, an
asynchronous save every ``--save-every`` steps joined at the next save,
and heartbeat and straggler bookkeeping.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train [--full]
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3

``--arch`` defaults to ``xlstm-125m`` (the ssm family), as the
reference's does; ``--arch zamba2-7b`` trains the hybrid family.  The
batches follow the reference's launcher:
a vlm model (``--arch llama-3.2-vision-11b``) gets zero image embeddings
``(batch, num_image_tokens, d_model)`` in the model dtype, an audio model
(``--arch musicgen-medium``) the batcher's tokens and labels repeated over
its ``num_codebooks``.  ``--full`` trains the published config
(default: its smoke config, as the JAX launcher does).  The device
defaults to ``cuda``; there is no fallback to the CPU, which runs only
when asked for with ``--device cpu``.  :func:`train` takes any config,
optimizer, batch source and starting state, so a caller can drive it at
full width.  The module is import-safe: arguments are parsed only in
:func:`main`.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import TokenBatcher
from repro_torch.models.transformer import init_lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import HeartbeatMonitor, StragglerDetector
from repro_torch.train.loop import TrainState, init_train_state, make_train_step
from repro_torch.train.optimizer import AdamW, make_schedule


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of its smoke config")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the parameters, optimizer state and batches")
    return ap.parse_args(argv)


def make_batch(cfg: ModelConfig, tokens: np.ndarray, labels: np.ndarray,
               device) -> Dict[str, torch.Tensor]:
    """A ``TokenBatcher`` batch ``(batch, seq)`` as the family's train step
    takes it, on ``device``: audio tokens and labels repeated over the
    codebooks ``(batch, K, seq)``; for vlm, zero image embeddings (float32
    zeros cast to the model dtype, as the reference builds them)."""
    tk, lb = torch.from_numpy(tokens).to(device), torch.from_numpy(labels).to(device)
    if cfg.family == "audio":
        k = cfg.num_codebooks
        tk, lb = torch.stack([tk] * k, dim=1), torch.stack([lb] * k, dim=1)
    batch = {"tokens": tk, "labels": lb}
    if cfg.family == "vlm":
        batch["enc"] = torch.zeros((tokens.shape[0], cfg.num_image_tokens, cfg.d_model),
                                   dtype=cfg.torch_dtype, device=device)
    return batch


def train(
    cfg: ModelConfig,
    optimizer,
    data: TokenBatcher,
    steps: int,
    *,
    device,
    state: Optional[TrainState] = None,
    start: int = 0,
    ckpt_dir: Optional[str] = None,
    save_every: int = 0,
    microbatches: int = 1,
    log: Callable[[str], None] = print,
) -> Tuple[TrainState, Dict]:
    """Runs steps ``start .. steps-1`` on ``device``; ``data.batch(step)``
    gives each step's batch.

    Without ``state``, the parameters are drawn from
    ``torch.Generator(device).manual_seed(0)`` and the run resumes from
    the latest committed checkpoint in ``ckpt_dir`` if there is one.
    With ``ckpt_dir`` and ``save_every``, the state after every
    ``save_every``-th step is saved asynchronously; a save joins the one
    before it, and the last is joined before returning.  Returns the
    final state and a report: each step's loss, grad norm and wall ms
    (the step ends when its loss reaches the host), their p50/p99, and
    tokens/s (a step's tokens counted as the batcher's ``batch × seq``).
    """
    step_fn = make_train_step(cfg, optimizer, microbatches=microbatches,
                              has_enc=cfg.family == "vlm")
    if state is None:
        state = init_train_state(init_lm(torch.Generator(device=device).manual_seed(0), cfg),
                                 optimizer)
        latest = ckpt.latest_step(ckpt_dir) if ckpt_dir else None
        if latest is not None:
            state = ckpt.restore(ckpt_dir, latest, state, device=device)
            start = latest
            log(f"resumed from step {latest}")

    hb = HeartbeatMonitor()
    stragglers = StragglerDetector()
    pending = None
    records, tokens_seen = [], 0
    t_run = time.perf_counter()
    for step in range(start, steps):
        t0 = time.perf_counter()
        tokens, labels = data.batch(step)
        state, metrics = step_fn(state, make_batch(cfg, tokens, labels, device))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        dt = time.perf_counter() - t0
        hb.beat(0, step)
        stragglers.record(0, dt)
        tokens_seen += tokens.size
        records.append({"step": step, "loss": loss, "grad_norm": gnorm, "ms": dt * 1e3})
        if step % 10 == 0 or step == steps - 1:
            log(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} {dt * 1e3:.0f}ms")
        if ckpt_dir and save_every and (step + 1) % save_every == 0:
            if pending is not None:
                pending.wait()
            pending = ckpt.save_async(ckpt_dir, step + 1, state)
    if pending is not None:
        pending.wait()
    wall = time.perf_counter() - t_run
    ms = np.asarray([r["ms"] for r in records])
    report = {
        "start": start, "steps": records,
        "step_p50_ms": float(np.percentile(ms, 50)) if records else None,
        "step_p99_ms": float(np.percentile(ms, 99)) if records else None,
        "tokens_per_s": tokens_seen / wall if records else None,
        "dead_hosts": hb.dead_hosts(), "stragglers": stragglers.stragglers(),
    }
    return state, report


def main(argv=None) -> Dict:
    args = parse_args(argv)
    cfg = get_config(args.arch, smoke=not args.full)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params~{cfg.param_count() / 1e6:.1f}M (full-config count)")
    opt = AdamW(schedule=make_schedule(cfg.schedule, args.lr, args.steps))
    data = TokenBatcher(cfg.vocab_size, args.batch, args.seq, seed=0)
    _, report = train(cfg, opt, data, args.steps, device=args.device,
                      ckpt_dir=args.ckpt_dir, save_every=args.save_every,
                      microbatches=args.microbatches)
    print("done; dead hosts:", report["dead_hosts"], "stragglers:", report["stragglers"])
    return report


if __name__ == "__main__":
    main()
