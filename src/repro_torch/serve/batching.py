"""Continuous request batching for decode serving.

A fixed pool of ``batch_size`` slots; requests join free slots, finished
requests (EOS or length limit) leave, and every engine tick decodes one
token for all occupied slots.  Per-slot state lives in the shared KV
cache at the slot's batch index, so admission is a cache write, not a
recompile — the standard continuous-batching design, minus speculative
scheduling.  A copy of ``repro.serve.batching`` (NumPy only).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request moving through the continuous batcher."""

    uid: int
    prompt: np.ndarray          # (prompt_len,) int32
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None


@dataclasses.dataclass
class ServeMetrics:
    """Request-level serving metrics (TTFT, latency, token counts)."""

    completed: int = 0
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    latency_s: List[float] = dataclasses.field(default_factory=list)
    tokens_out: int = 0

    def summary(self) -> Dict[str, float]:
        """Mean TTFT/latency plus completion counters."""
        return {
            "completed": self.completed,
            "tokens_out": self.tokens_out,
            "mean_ttft_s": float(np.mean(self.ttft_s)) if self.ttft_s else 0.0,
            "mean_latency_s": float(np.mean(self.latency_s)) if self.latency_s else 0.0,
        }


class RequestBatcher:
    """Slot-based continuous batcher around a (prefill_fn, decode_fn) pair.

    prefill_fn(slot, prompt) -> first_token
    decode_fn(active_mask, last_tokens) -> next_tokens (batch,)
    """

    def __init__(self, batch_size: int, eos_id: int = 0):
        self.batch_size = batch_size
        self.eos_id = eos_id
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.metrics = ServeMetrics()
        self.last_tokens = np.zeros(batch_size, np.int32)

    def submit(self, req: Request) -> None:
        """Enqueues a request for admission on the next tick."""
        req.submitted_at = time.time()
        self.queue.append(req)

    def _admit(self, prefill_fn) -> None:
        for slot in range(self.batch_size):
            if self.slots[slot] is None and self.queue:
                req = self.queue.popleft()
                req.slot = slot
                first = int(prefill_fn(slot, req.prompt))
                req.generated.append(first)
                req.first_token_at = time.time()
                self.last_tokens[slot] = first
                self.slots[slot] = req

    def tick(self, prefill_fn: Callable, decode_fn: Callable) -> int:
        """One engine iteration. Returns number of active slots."""
        self._admit(prefill_fn)
        active = np.array([r is not None for r in self.slots])
        if not active.any():
            return 0
        nxt = decode_fn(active, self.last_tokens.copy())
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[slot])
            req.generated.append(tok)
            self.last_tokens[slot] = tok
            self.metrics.tokens_out += 1
            if tok == self.eos_id or len(req.generated) >= req.max_new_tokens:
                req.done_at = time.time()
                self.metrics.completed += 1
                self.metrics.ttft_s.append(req.first_token_at - req.submitted_at)
                self.metrics.latency_s.append(req.done_at - req.submitted_at)
                self.slots[slot] = None
        return int(active.sum())

    @property
    def idle(self) -> bool:
        """True when no request is queued or occupying a slot."""
        return not self.queue and all(s is None for s in self.slots)
