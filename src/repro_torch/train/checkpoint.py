"""Atomic, restartable checkpoints in the reference's on-disk format.

The port of ``repro.train.checkpoint``.  Layout on disk::

    <dir>/step_000000123/
        manifest.json            # step, and every leaf's name, shape, dtype
        host_000.npz             # this host's leaves, one array each
        COMMITTED                # written last — atomic-commit marker

The directory is written as ``step_….tmp`` and renamed when complete, so
a torn write never becomes the restore point (:func:`latest_step` ignores
a step without ``COMMITTED``).  Leaves are named as JAX's
``tree_flatten_with_path`` spells them (``repro_torch.train.tree``):
``.params/layers/attn/wq``, ``.opt_state/.mu/embed``, ``.step``.
bfloat16 leaves are stored as their ``uint16`` bit patterns with dtype
``"bfloat16"`` in the manifest.  A checkpoint written by either package
restores in the other, bit for bit.

``save_async`` copies the tensors to host memory before it returns and
writes them on a daemon thread; the train loop overlaps its next steps
with the write and joins at the following save.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import place
from repro_torch.models.layers import tree_map
from repro_torch.train.tree import flatten_with_names, map_with_names


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a NumPy array and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any, *, host_index: int = 0) -> str:
    """Synchronous checkpoint save. Returns the committed directory."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)

    arrays = {}
    meta = {"step": step, "leaves": []}
    for name, leaf in flatten_with_names(tree):
        arr, dtype = _host_array(leaf)
        arrays[name] = arr
        meta["leaves"].append({"name": name, "shape": list(arr.shape), "dtype": dtype})

    np.savez(os.path.join(tmp_dir, f"host_{host_index:03d}.npz"), **arrays)
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp_dir, "COMMITTED"), "w") as f:
        f.write(str(time.time()))
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    return step_dir


class AsyncSaveHandle:
    """A background save; :meth:`wait` joins it and re-raises its error."""

    def __init__(self, ckpt_dir: str, step: int, host_tree: Any, host_index: int):
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(ckpt_dir, step, host_tree, host_index), daemon=True)
        self._thread.start()

    def _run(self, ckpt_dir, step, host_tree, host_index):
        try:
            save(ckpt_dir, step, host_tree, host_index=host_index)
        except Exception as e:  # handed to wait(), which re-raises it
            self._error = e

    def wait(self):
        self._thread.join()
        if self._error is not None:
            raise self._error

    @property
    def done(self) -> bool:
        return not self._thread.is_alive()


def _snapshot(tree: Any) -> Any:
    """A host copy of every tensor of ``tree`` (NumPy leaves copied too)."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
                    else np.array(x), tree)


def save_async(ckpt_dir: str, step: int, tree: Any, *, host_index: int = 0) -> AsyncSaveHandle:
    """Snapshot to host memory now, write in the background."""
    return AsyncSaveHandle(ckpt_dir, step, _snapshot(tree), host_index)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "COMMITTED")):
                best = max(best or -1, int(d.split("_")[1]))
    return best


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like: Any, *, device=None, shardings: Any = None) -> Any:
    """Restores into the structure of ``like``, every leaf on ``device``
    (default: the device of ``like``'s leaf, or the CPU).

    Only ``like``'s structure, names and shapes are used: a leaf missing
    from the checkpoint raises ``KeyError``, a shape that differs
    ``ValueError``.  Leaves keep the dtype they were stored with.

    ``shardings`` re-shards on load: a tree with the structure of
    ``like`` whose leaves are ``(mesh, placements)`` pairs or ``None``.  A
    leaf with a pair becomes a DTensor on that mesh (on its device type),
    laid out from the stored array, which every rank reads from the same
    files, so no data moves between ranks; a leaf with ``None`` goes to
    ``device`` as above.
    """
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        meta = json.load(f)
    dtype_of = {l["name"]: l["dtype"] for l in meta["leaves"]}

    stored: dict[str, torch.Tensor] = {}
    for fname in sorted(os.listdir(step_dir)):
        if fname.startswith("host_") and fname.endswith(".npz"):
            with np.load(os.path.join(step_dir, fname)) as z:
                for k in z.files:
                    stored[k] = _tensor(z[k], dtype_of.get(k, ""))

    # each leaf's (mesh, placements) pair by name; held in a closure, so
    # the walk does not descend into the pair
    layout_of = {} if shardings is None else dict(
        flatten_with_names(tree_map(lambda _, s: (lambda: s), like, shardings)))

    def put(name, leaf):
        if name not in stored:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        t = stored[name]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != {tuple(leaf.shape)}")
        layout = layout_of[name]() if name in layout_of else None
        if layout is not None:
            mesh, placements = layout
            return place(t.to(_mesh_device(mesh)), mesh, placements)
        dev = device if device is not None else getattr(leaf, "device", "cpu")
        return t.to(dev)

    return map_with_names(put, like)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
