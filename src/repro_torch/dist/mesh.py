"""One process per shard: the port's counterpart of the reference's
``(1, S)`` ``("data", "model")`` mesh, over ``torch.distributed``.

A :class:`ShardMesh` is one rank's view of a world of ``S`` processes,
one per shard (``size == num_shards``, ``rank == shard id``).  It holds

* the rank's **device**: ``cuda:{local_rank % device_count}``, or the CPU
  only when asked for;
* the **data plane**, the process group the shard combine runs on: NCCL
  on CUDA, gloo on the CPU, or whichever ``backend=`` names;
* the **control plane**, a gloo group on CPU tensors that carries the
  controller's headers, schedules, patch tiles and image slices
  (:mod:`repro_torch.serve.sharded`);
* a bounded cache of **subgroups** keyed by the sorted participants tuple,
  for the subset combine.

``dist.new_group`` is a collective over the whole world, so every rank
must create a subgroup at the same point of the call sequence.  The
sharded reduction is SPMD with ``shard_ids`` identical on every rank, so
every rank asks :meth:`ShardMesh.subgroup` for the same tuple in the same
order, and the cache's least-recently-used eviction evicts the same
tuple everywhere.  A rank never creates a subgroup on its own.

A failed collective or transfer raises :class:`MeshError`.  The world is
then unusable (a peer that raised is out of step or gone), so a serving
engine re-raises it, like a :class:`~repro_torch.kernels._build.
KernelError`, instead of retrying or quarantining the batch; the process
group's timeout is the backstop against a peer that never answers.
"""

from __future__ import annotations

import collections
import contextlib
import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: bound of the subgroup cache: the reference's ``DISPATCH_CACHE_MAXSIZE``
SUBGROUP_CACHE_MAXSIZE = 64
#: default process-group timeout (the backstop against a silent peer)
DEFAULT_TIMEOUT_S = 600.0


class MeshError(RuntimeError):
    """A collective or point-to-point transfer of the shard mesh failed:
    a fault of the world (a peer raised, died or timed out), not of the
    batch being served."""


@contextlib.contextmanager
def mesh_errors(what: str):
    """Re-raises a ``torch.distributed`` failure inside the block as a
    :class:`MeshError` naming ``what``."""
    try:
        yield
    except MeshError:
        raise
    except RuntimeError as e:  # DistBackendError and gloo/NCCL errors
        raise MeshError(f"{what} failed: {e}") from e


class ShardMesh:
    """One rank of a world of ``size`` shard processes (see the module
    docstring).  Made by :func:`init_shard_mesh`; :meth:`close` destroys
    the process groups."""

    def __init__(self, *, rank: int, size: int, device: torch.device,
                 backend: str, ctrl):
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        #: data plane: the default group (every rank, ``backend``)
        self.data = dist.group.WORLD
        #: control plane: gloo on CPU tensors
        self.ctrl = ctrl
        self._subgroups: collections.OrderedDict = collections.OrderedDict()
        self._hits = 0
        self._misses = 0
        #: with ``record_combine`` on, the reduction appends one
        #: ``(start, end)`` CUDA event pair per combine on a CUDA rank
        self.record_combine = False
        self.combine_events: list = []

    def subgroup(self, participants: Sequence[int]):
        """The data-plane group of ``participants`` (any order), created
        on first use on every rank and cached; ``None`` on a rank outside
        it.  Every rank must call this with the same tuples in the same
        order (see the module docstring)."""
        key = tuple(sorted(int(p) for p in participants))
        if key in self._subgroups:
            self._hits += 1
            self._subgroups.move_to_end(key)
        else:
            self._misses += 1
            with mesh_errors(f"new_group{key}"):
                group = dist.new_group(list(key), backend=self.backend)
            self._subgroups[key] = group
            if len(self._subgroups) > SUBGROUP_CACHE_MAXSIZE:
                old_key, old = self._subgroups.popitem(last=False)
                if self.rank in old_key:
                    dist.destroy_process_group(old)
        return self._subgroups[key] if self.rank in key else None

    def cache_stats(self) -> dict:
        """Hits, misses and size of the subgroup cache (the reference's
        ``dispatch_cache_stats`` entry schema)."""
        return {"hits": self._hits, "misses": self._misses,
                "currsize": len(self._subgroups), "maxsize": SUBGROUP_CACHE_MAXSIZE}

    # ------------------------------------------------------ control plane --

    def broadcast_header(self, values: Optional[Sequence[int]] = None,
                         length: int = 0) -> list:
        """Rank 0 sends ``values`` (ints), every other rank receives
        ``length`` of them; returns the header on every rank."""
        if self.rank == 0:
            t = torch.tensor(list(values), dtype=torch.int64)
        else:
            t = torch.empty(length, dtype=torch.int64)
        with mesh_errors("control header"):
            dist.broadcast(t, src=0, group=self.ctrl)
        return t.tolist()

    def send(self, tensor: torch.Tensor, dst: int) -> None:
        """Sends a CPU tensor to rank ``dst`` on the control plane."""
        with mesh_errors(f"control send to rank {dst}"):
            dist.send(tensor.contiguous(), dst=dst, group=self.ctrl)

    def recv(self, shape: Tuple[int, ...], dtype: torch.dtype, src: int = 0) -> torch.Tensor:
        """Receives a CPU tensor of ``shape`` and ``dtype`` from ``src``."""
        out = torch.empty(shape, dtype=dtype)
        with mesh_errors(f"control recv from rank {src}"):
            dist.recv(out, src=src, group=self.ctrl)
        return out

    def combine_ms(self) -> list:
        """Milliseconds of each recorded combine (waits for the card)."""
        out = []
        for start, end in self.combine_events:
            end.synchronize()
            out.append(start.elapsed_time(end))
        return out

    def close(self) -> None:
        """Destroys every process group of this process (idempotent)."""
        self._subgroups.clear()
        if dist.is_initialized():
            dist.destroy_process_group()


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def init_shard_mesh(
    num_shards: Optional[int] = None,
    *,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_rank: Optional[int] = None,
    device: str = "cuda",
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> ShardMesh:
    """Joins (or forms) the world of shard processes.

    ``rank``, ``world_size`` and ``local_rank`` default to ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` (what ``torchrun`` sets), and
    ``init_method`` to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``);
    pass ``init_method="file://..."`` or ``"tcp://localhost:<port>"``
    to form a world without them.

    Args:
      num_shards: when given, must equal the world size.
      device: ``"cuda"`` (the rank's card, ``cuda:{local_rank %
        device_count}``) or ``"cpu"``.
      backend: the data plane's backend; ``None`` picks NCCL on CUDA and
        gloo on the CPU.
      timeout_s: the process groups' timeout.

    Returns:
      This rank's :class:`ShardMesh`.
    """
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if rank is None or world_size is None:
        raise ValueError("rank and world_size: pass them or set RANK and WORLD_SIZE")
    if num_shards is not None and num_shards != world_size:
        raise ValueError(f"mesh of {world_size} ranks, need one per shard ({num_shards})")
    local_rank = _env_int("LOCAL_RANK") if local_rank is None else local_rank
    local_rank = rank if local_rank is None else local_rank
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is available")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("the NCCL data plane needs device='cuda'")
    timeout = timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size, timeout=timeout,
    )
    ctrl = dist.new_group(backend="gloo", timeout=timeout)
    return ShardMesh(rank=rank, size=world_size, device=dev, backend=backend, ctrl=ctrl)
