"""DLRM (Naumov et al.) with a ReCross-mapped embedding layer, in PyTorch.

The port of ``repro.models.dlrm``.  Bottom MLP over dense features →
sparse embedding-bag reductions (one per categorical table) → an
interaction → top MLP → CTR logit.

The interaction is the pairwise dot product of DLRM (``"dot"``, the JAX
package's and ``dlrm-recross``'s) or, on a :class:`TorchRecDLRMConfig`,
TorchRec's low-rank cross network (``"dcn"``, MLPerf's DLRM-DCNv2; see
:func:`dlrm_forward`).  A :class:`TorchRecDLRMConfig` also gives every
table its own row count and fixed bag size.

The embedding path is selectable:
  * ``"dense"``    — gather+sum on the logical table (plain torch),
  * ``"layout"``   — torch tiled MAC through the ReCross image
    (:func:`repro_torch.core.reduction.reduce_via_layout`),
  * ``"kernel"``   — the CUDA crossbar kernel (:func:`repro_torch.kernels.
    ops.crossbar_reduce`; its plain version on CPU tensors),
  * ``"served"``   — the pooled rows that :meth:`repro_torch.serve.
    sharded.ShardedEmbeddingServer.serve` returned, the serving path:
    ``dlrm_forward(params, cfg, dense, server.serve(request))``.

All four are numerically equal.  Parameters are plain dicts with the JAX
package's tree and layout: ``{"tables": {name: (rows, dim)}, "bottom":
[{"w": (d_in, d_out), "b": (d_out,)}, ...], "top": [...]}`` (and under
``"dcn"``, ``"cross": [{"v": (n, r), "w": (r, n), "b": (n,)}, ...]``) and
each layer computes ``x @ w + b``.

Spans (:mod:`repro_torch.core.trace`, while tracing is on), one call each
a forward:

=====================  =================================================
``model.bottom``       the bottom MLP over the dense features
``model.interaction``  the dot interaction or the cross network, from the
                       pooled embeddings to the top MLP's input
``model.top``          the top MLP, to the logits
=====================  =================================================
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import trace
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
    embedding_path: str = "kernel"   # dense | layout | kernel | served
    dtype: str = "float32"

    # what this module reads of a TorchRecDLRMConfig, at a DLRMConfig's
    # values (class attributes, not fields: asdict stays the JAX package's)
    table_rows = None
    interaction = "dot"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def rows_of(self, t: int) -> int:
        """Table ``t``'s row count."""
        return self.table_rows[t] if self.table_rows else self.rows_per_table

    @property
    def top_in(self) -> int:
        """The top MLP's input width: the bottom output and the pairs of
        the dot interaction, or the cross network's ``(T + 1) × d``."""
        n_emb = self.num_tables + 1
        if self.interaction == "dcn":
            return n_emb * self.embed_dim
        return self.bottom_mlp[-1] + n_emb * (n_emb - 1) // 2


@dataclasses.dataclass(frozen=True)
class TorchRecDLRMConfig(DLRMConfig):
    """A DLRM-DCN in TorchRec's terms (``torchrec_dlrm``'s flags): per-table
    row counts (``--num_embeddings_per_feature``) and fixed bag sizes
    (``--multi_hot_sizes``), and the low-rank cross network
    (``--interaction_type dcn``, ``--dcn_num_layers``,
    ``--dcn_low_rank_dim``).

    A subclass, so that :class:`DLRMConfig` keeps the JAX package's fields
    (``dataclasses.asdict`` of ``dlrm-recross`` equals JAX's); its
    functions read these fields from either.  ``num_tables``,
    ``rows_per_table`` and ``max_bag`` follow from the per-table tuples:
    their count, the most rows and the largest bag.
    """

    table_rows: tuple = ()
    bag_sizes: tuple = ()
    dcn_num_layers: int = 3
    dcn_low_rank_dim: int = 512

    interaction = "dcn"

    def __post_init__(self):
        n = len(self.table_rows)
        if not n or len(self.bag_sizes) != n:
            raise ValueError("need one bag size for each of at least one table")
        if self.bottom_mlp[-1] != self.embed_dim:
            raise ValueError("the cross network needs the bottom MLP's output at embed_dim")
        object.__setattr__(self, "num_tables", n)
        object.__setattr__(self, "rows_per_table", max(self.table_rows))
        object.__setattr__(self, "max_bag", max(self.bag_sizes))


def init_dlrm(generator: torch.Generator, cfg: DLRMConfig, device="cuda") -> Params:
    """Tables ~ N(0, 0.01²), each at its own row count, then
    :func:`init_dense`'s layers; drawn on the generator's device and
    moved to ``device``.  On a ``"meta"`` device nothing is drawn: the
    tree's shapes and dtypes alone (the dry run's)."""
    gen_device = "meta" if torch.device(device).type == "meta" else generator.device
    dtype = cfg.torch_dtype
    params: Params = {"tables": {}}
    for t in range(cfg.num_tables):
        table = torch.randn(
            (cfg.rows_of(t), cfg.embed_dim), generator=generator, device=gen_device
        )
        params["tables"][f"t{t}"] = (table * 0.01).to(device=device, dtype=dtype)
    params.update(init_dense(generator, cfg, device))
    return params


def init_dense(generator: torch.Generator, cfg: DLRMConfig, device="cuda") -> Params:
    """The layers outside the tables, drawn in this order: the bottom MLP,
    under ``"dcn"`` the cross layers, then the top MLP.  Every weight is
    :func:`dense_init`'s (truncated normal, σ = 1/√d_in), every bias zero.

    A cross layer ``l`` holds ``v`` (``n × r``), then ``w`` (``r × n``) and
    ``b`` (``n``), with ``n = (T + 1) × d`` and ``r = dcn_low_rank_dim``.
    TorchRec draws ``V_l`` and ``W_l`` with ``xavier_normal_``; this draws
    them as the repo's other dense weights.
    """
    dtype = cfg.torch_dtype

    def mlp_params(sizes, d_in):
        ps = []
        for d_out in sizes:
            ps.append({
                "w": dense_init(generator, d_in, d_out, dtype).to(device),
                "b": torch.zeros((d_out,), dtype=dtype, device=device),
            })
            d_in = d_out
        return ps

    params: Params = {"bottom": mlp_params(cfg.bottom_mlp, cfg.dense_features)}
    if cfg.interaction == "dcn":
        n, r = cfg.top_in, cfg.dcn_low_rank_dim
        params["cross"] = [{
            "v": dense_init(generator, n, r, dtype).to(device),
            "w": dense_init(generator, r, n, dtype).to(device),
            "b": torch.zeros((n,), dtype=dtype, device=device),
        } for _ in range(cfg.dcn_num_layers)]
    params["top"] = mlp_params(cfg.top_mlp, cfg.top_in)
    return params


def _apply_mlp(ps, x, final_linear=False):
    for i, p in enumerate(ps):
        x = x @ p["w"] + p["b"]
        if not (final_linear and i == len(ps) - 1):
            x = torch.relu(x)
    return x


def cross_net(layers: List[Params], x0: torch.Tensor) -> torch.Tensor:
    """TorchRec's ``LowRankCrossNet`` on ``x0`` ``(b, n)``: each layer
    ``x_{l+1} = x0 ⊙ ((x_l @ v) @ w + b) + x_l``, from ``x_0 = x0``."""
    x = x0
    for p in layers:
        x = x0 * ((x @ p["v"]) @ p["w"] + p["b"]) + x
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
      * ``indices`` (b, bag) int −1-padded                 (dense path),
      * ``(tile_ids, bitmaps)``                            (layout/kernel), or
      * the ``(b, padded_dim)`` pooled rows the server returned (served).

    Under ``"dcn"`` the pooled embeddings, in table order, follow the
    bottom MLP's output in ``x_0`` (width ``(T + 1) × d``), and each cross
    layer computes ``x_{l+1} = x_0 ⊙ ((x_l V_l) W_l + b_l) + x_l``, as
    TorchRec's ``LowRankCrossNet`` in ``DLRM_DCN``; the top MLP (ReLU on
    every layer but the last) gives the logit.  Departures from TorchRec:
    the weights are the transposes of its ``V_kernels``/``W_kernels``
    (this module's ``x @ w`` layout), drawn as :func:`init_dense` says;
    the server sums a bag's distinct rows, where TorchRec's sum pooling
    would count a repeated id twice (the dense path sums what it is
    given).
    """
    with trace.span("model.bottom"):
        x_dense = _apply_mlp(params["bottom"], dense)

    embs: List[torch.Tensor] = [x_dense]
    for t in range(cfg.num_tables):
        key = f"t{t}"
        if cfg.embedding_path == "served":
            e = sparse[key][:, : cfg.embed_dim]
        elif cfg.embedding_path == "dense":
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

    with trace.span("model.interaction"):
        if cfg.interaction == "dcn":
            top_in = cross_net(params["cross"], torch.cat(embs, dim=-1))
        else:
            # pairwise dot-product interaction; triu_indices(n, n, 1) has
            # the order of jnp.triu_indices(n, k=1)
            stack = torch.stack(embs, dim=1)              # (b, n_emb, d)
            inter = torch.einsum("bnd,bmd->bnm", stack, stack)
            iu = torch.triu_indices(stack.shape[1], stack.shape[1], 1, device=stack.device)
            pairs = inter[:, iu[0], iu[1]]                # (b, n_pairs)
            top_in = torch.cat([x_dense, pairs], dim=-1)

    with trace.span("model.top"):
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
