"""Serving launcher: continuous-batched LM decode (PyTorch port).

The counterpart of ``repro.launch.serve``: random weights for ``--arch``
(drawn from a seeded ``torch.Generator`` on the device), a KV cache of
``--slots`` sequences × ``--max-seq`` positions, and a
:class:`~repro_torch.serve.batching.RequestBatcher` that admits requests
with random prompts, prefills each prompt by decode steps for its slot
and decodes greedily (argmax over ``[:vocab_size]``) until every request
has ``--max-new`` tokens.  Prints the report as JSON.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --full --kv-int8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --kv-int8

``--full`` serves the published config (default: its smoke config, as
the JAX launcher does); ``--kv-int8`` keeps an int8 cache, whose
attention runs the flash-decode CUDA kernel.  The device defaults to
``cuda``; there is no fallback to the CPU, which runs the kernels' plain
versions only when asked for with ``--device cpu``.  A step that would
write past ``--max-seq`` of an attention cache raises (JAX clamps the
write silently); the recurrent families' state has no length, and the
hybrid's shared-attention ring (``min(4096, --max-seq)`` slots) wraps, so
they decode past ``--max-seq`` as the reference's do
(``--arch xlstm-125m``, ``--arch zamba2-7b``).  A vlm
model (``--arch llama-3.2-vision-11b``) is served with zero image
embeddings ``(slots, num_image_tokens, d_model)``; an audio model is
refused with ``SystemExit``, as the reference's launcher refuses it.  The
module is import-safe: arguments are parsed only in :func:`main`.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, count_params, tree_leaves
from repro_torch.models.transformer import init_lm
from repro_torch.serve.batching import Request, RequestBatcher
from repro_torch.serve.decode import decode_step
from repro_torch.serve.kvcache import cache_bytes, cache_slots, init_cache

PROMPT_LEN = 4  # the JAX launcher's prompt length


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the weights, the cache and the kernels")
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of its smoke config")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache (flash-decode kernel) instead of the model dtype")
    return ap.parse_args(argv)


def build(cfg: ModelConfig, slots: int, max_seq: int, *, kv_int8: bool, device,
          seed: int = 0):
    """Random weights from ``torch.Generator(device).manual_seed(seed)`` and
    an empty cache (``kv_int8`` applies to the attention families only)."""
    params = init_lm(torch.Generator(device=device).manual_seed(seed), cfg)
    cache = init_cache(cfg, slots, max_seq, quant=kv_int8, device=device)
    return params, cache


def make_requests(cfg: ModelConfig, n: int, prompt_len: int, max_new: int,
                  seed: int = 0) -> List[Request]:
    """The JAX launcher's requests: prompts uniform in ``[1, vocab)``."""
    rng = np.random.default_rng(seed)
    return [Request(uid=uid,
                    prompt=rng.integers(1, cfg.vocab_size, size=prompt_len).astype(np.int32),
                    max_new_tokens=max_new)
            for uid in range(n)]


def image_embeddings(cfg: ModelConfig, slots: int, device) -> Optional[torch.Tensor]:
    """The reference launcher's stub image embeddings for a vlm model:
    zeros ``(slots, num_image_tokens, d_model)`` in the model dtype; None
    for the other families."""
    if cfg.family != "vlm":
        return None
    return torch.zeros((slots, cfg.num_image_tokens, cfg.d_model), dtype=cfg.torch_dtype,
                       device=device)


def serve(params: Params, cfg: ModelConfig, cache: Dict, requests: List[Request], *,
          enc: Optional[torch.Tensor] = None) -> Dict:
    """Serves ``requests`` to the end through one ``RequestBatcher`` over
    the cache's slots (``enc``: a vlm model's image embeddings, one row a
    slot); only a cache with K/V of a fixed length (``"k"``) refuses a
    step past it.  Returns the batcher's metrics with the step count, each
    step's wall time (decode step + greedy argmax on the host) and
    throughput."""
    slots = cache_slots(cache)
    max_seq = cache["k"].shape[2] if "k" in cache else None
    device = cache["len"].device
    start = int(cache["len"])  # the one host read of the length; steps count on from it
    step_s: List[float] = []

    def dstep(tokens: np.ndarray) -> np.ndarray:
        if max_seq is not None and start + len(step_s) >= max_seq:
            raise ValueError(f"decode step at length {start + len(step_s)} would write "
                             f"past max_seq={max_seq}")
        t0 = time.perf_counter()
        logits, _ = decode_step(params, cfg, torch.from_numpy(tokens).to(device), cache,
                                enc=enc)
        nxt = logits[:, -1, :cfg.vocab_size].argmax(dim=-1).cpu().numpy()
        step_s.append(time.perf_counter() - t0)
        return nxt

    def prefill_fn(slot, prompt):
        # prompt tokens fed through decode steps for the slot, as in JAX
        tok = np.zeros((slots, 1), np.int32)
        last = 0
        for t in prompt:
            tok[slot, 0] = int(t)
            last = int(dstep(tok)[slot])
        return last

    def decode_fn(active, last_tokens):
        return dstep(last_tokens[:, None].astype(np.int32))

    batcher = RequestBatcher(slots, eos_id=-1)
    for req in requests:
        batcher.submit(req)
    limit = sum(r.max_new_tokens + 8 for r in requests)
    ticks = 0
    t0 = time.perf_counter()
    while not batcher.idle:
        batcher.tick(prefill_fn, decode_fn)
        ticks += 1
        if ticks > limit:
            raise RuntimeError("serving did not drain")
    wall = time.perf_counter() - t0
    ms = np.asarray(step_s) * 1e3
    report = batcher.metrics.summary()
    report.update(
        ticks=ticks, steps=len(step_s), wall_s=wall,
        tokens_per_s=report["tokens_out"] / wall,
        step_p50_ms=float(np.percentile(ms, 50)), step_p99_ms=float(np.percentile(ms, 99)),
        step_ms=ms.tolist(),
    )
    return report


def main(argv=None) -> Dict:
    args = parse_args(argv)
    cfg = get_config(args.arch, smoke=not args.full)
    if cfg.family == "audio":
        raise SystemExit("serve demo targets text LMs; musicgen uses examples/")
    params, cache = build(cfg, args.slots, args.max_seq, kv_int8=args.kv_int8,
                          device=args.device)
    requests = make_requests(cfg, args.requests, PROMPT_LEN, args.max_new)
    report = serve(params, cfg, cache, requests,
                   enc=image_embeddings(cfg, args.slots, args.device))
    del report["step_ms"]
    report.update(
        arch=cfg.name, device=args.device, kv_int8=args.kv_int8,
        params=count_params(params),
        weight_bytes=sum(x.numel() * x.element_size() for x in tree_leaves(params)),
        cache_bytes=cache_bytes(cache),
    )
    return report


if __name__ == "__main__":
    print(json.dumps(main(), indent=1))
