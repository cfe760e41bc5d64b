"""DLRM (Naumov et al.) with a ReCross-mapped embedding layer, in PyTorch.

The port of ``repro.models.dlrm``.  Bottom MLP over dense features →
sparse embedding-bag reductions (one per categorical table) → pairwise
dot interaction → top MLP → CTR logit.

The embedding path is selectable:
  * ``"dense"``    — gather+sum on the logical table (plain torch),
  * ``"layout"``   — torch tiled MAC through the ReCross image
    (:func:`repro_torch.core.reduction.reduce_via_layout`),
  * ``"kernel"``   — the CUDA crossbar kernel (:func:`repro_torch.kernels.
    ops.crossbar_reduce`; its plain version on CPU tensors).

All three are numerically equal.  Parameters are plain dicts with the JAX
package's tree and layout: ``{"tables": {name: (rows, dim)}, "bottom":
[{"w": (d_in, d_out), "b": (d_out,)}, ...], "top": [...]}`` and each
layer computes ``x @ w + b``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.mapping import CrossbarLayout
from repro_torch.core.reduction import reduce_via_layout
from repro_torch.kernels import ops
from repro_torch.models.layers import Params, dense_init

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-recross"
    family: str = "recsys"
    num_tables: int = 1
    rows_per_table: int = 65_536
    embed_dim: int = 64
    dense_features: int = 13
    bottom_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 256, 1)
    max_bag: int = 64             # padded lookups per table per sample
    # ReCross knobs
    group_size: int = 64
    embedding_path: str = "kernel"   # dense | layout | kernel
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def init_dlrm(generator: torch.Generator, cfg: DLRMConfig, device="cuda") -> Params:
    """Tables ~ N(0, 0.01²), MLP weights from :func:`dense_init`, zero
    biases; drawn on the generator's device (tables, then bottom, then
    top) and moved to ``device``.  On a ``"meta"`` device nothing is
    drawn: the tree's shapes and dtypes alone (the dry run's)."""
    gen_device = "meta" if torch.device(device).type == "meta" else generator.device
    dtype = cfg.torch_dtype
    params: Params = {"tables": {}}
    for t in range(cfg.num_tables):
        table = torch.randn(
            (cfg.rows_per_table, cfg.embed_dim), generator=generator, device=gen_device
        )
        params["tables"][f"t{t}"] = (table * 0.01).to(device=device, dtype=dtype)

    def mlp_params(sizes, d_in):
        ps = []
        for d_out in sizes:
            ps.append({
                "w": dense_init(generator, d_in, d_out, dtype).to(device),
                "b": torch.zeros((d_out,), dtype=dtype, device=device),
            })
            d_in = d_out
        return ps

    params["bottom"] = mlp_params(cfg.bottom_mlp, cfg.dense_features)
    n_emb = cfg.num_tables + 1
    n_pairs = n_emb * (n_emb - 1) // 2
    params["top"] = mlp_params(cfg.top_mlp, cfg.bottom_mlp[-1] + n_pairs)
    return params


def _apply_mlp(ps, x, final_linear=False):
    for i, p in enumerate(ps):
        x = x @ p["w"] + p["b"]
        if not (final_linear and i == len(ps) - 1):
            x = torch.relu(x)
    return x


def dlrm_forward(
    params: Params,
    cfg: DLRMConfig,
    dense: torch.Tensor,                 # (b, dense_features)
    sparse: Dict[str, Any],              # per-table query tensors (see below)
    *,
    layouts: Optional[Dict[str, CrossbarLayout]] = None,
    images: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Returns CTR logits (b,).

    ``sparse[f"t{i}"]`` is
      * ``indices`` (b, max_bag) int −1-padded             (dense path), or
      * ``(tile_ids, bitmaps)``                            (layout/kernel).
    """
    x_dense = _apply_mlp(params["bottom"], dense)

    embs: List[torch.Tensor] = [x_dense]
    for t in range(cfg.num_tables):
        key = f"t{t}"
        if cfg.embedding_path == "dense":
            idx = sparse[key]
            table = params["tables"][key]
            take = table[idx.long().clamp(0, table.shape[0] - 1)]
            e = (take * (idx >= 0)[..., None]).sum(dim=1)
        else:
            tile_ids, bitmaps = sparse[key]
            image = images[key]
            if cfg.embedding_path == "kernel":
                # image dim is padded to a 128 multiple by build_images
                e = ops.crossbar_reduce(image, tile_ids, bitmaps)[:, : cfg.embed_dim]
            else:
                flat = image.reshape(-1, image.shape[-1])
                e = reduce_via_layout(
                    flat, tile_ids, bitmaps, tile_rows=image.shape[1]
                )[:, : cfg.embed_dim]
        embs.append(e.to(x_dense.dtype))

    # pairwise dot-product interaction; triu_indices(n, n, 1) has the
    # order of jnp.triu_indices(n, k=1)
    stack = torch.stack(embs, dim=1)                      # (b, n_emb, d)
    inter = torch.einsum("bnd,bmd->bnm", stack, stack)
    iu = torch.triu_indices(stack.shape[1], stack.shape[1], 1, device=stack.device)
    pairs = inter[:, iu[0], iu[1]]                        # (b, n_pairs)

    top_in = torch.cat([x_dense, pairs], dim=-1)
    return _apply_mlp(params["top"], top_in, final_linear=True)[:, 0]


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of CTR logits, in the JAX package's
    numerically stable form."""
    return torch.mean(
        torch.relu(logits) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    )


def dlrm_loss(params, cfg, dense, sparse, labels, **kw):
    return bce_with_logits(dlrm_forward(params, cfg, dense, sparse, **kw), labels)


def build_images(params: Params, cfg: DLRMConfig, layouts: Dict[str, CrossbarLayout]):
    """Materializes per-table crossbar images from current table params,
    on the tables' device and in their dtype.

    The crossbar kernel takes a dim that is a multiple of 128, so the
    embedding dim is zero-padded up to one (the forward slices it back
    off) — the column padding of the paper's 64-wide crossbars.
    """
    images = {}
    pad = (-cfg.embed_dim) % 128
    for key, layout in layouts.items():
        table = params["tables"][key]
        tbl = table.detach().cpu().float().numpy()
        img = layout.build_image(tbl).reshape(
            layout.num_tiles, layout.tile_rows, cfg.embed_dim
        )
        if pad:
            img = np.pad(img, ((0, 0), (0, 0), (0, pad)))
        images[key] = torch.from_numpy(img).to(device=table.device, dtype=table.dtype)
    return images
