"""MLPerf's DLRM-DCNv2 in the port, on the CPU at ``configs.dlrm_dcnv2.smoke()``:
the serving path (``ShardedEmbeddingServer.serve`` → ``dlrm_forward(...,
"served")``) against the plain reference ``recbench/dcnv2_reference.py``,
the four embedding paths against each other, one low-rank cross layer by
hand, the published sizes and the one-card cut, the benchmark's
configuration, the ``model.*`` spans and the registry.

Tolerance of the served path against the reference: the largest logit gap
at most ``REL_TOL`` of the largest logit.  Both sides are float32 on the
same parameters and bags; they differ in the order of the sums (the
crossbar's tile-wise MAC and READ against an ``index_add_``, and the
matrix products' blocking), ≈ 1e-7 relative an operation, which the three
multiplicative cross layers amplify (each multiplies ``x_0`` by a product
of ``x_l``).  The float32 path reads 7.3e-7 here and a bfloat16 run of
the same path (8-bit mantissa, ≈ 4e-3 an operation) 6.3e-3; the limit
lies near their geometric middle, 137× over the one and 63× under the
other, since the card's longer sums (``x_0`` of 3,456 at the published
widths) read higher than this size.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from recbench import dcnv2_reference
from repro_torch.configs import dlrm_dcnv2
from repro_torch.configs.base import list_configs
from repro_torch.core import trace
from repro_torch.core.reduction import compile_queries
from repro_torch.models import dlrm
from repro_torch.serve import ShardedEmbeddingServer

ROOT = Path(__file__).resolve().parents[1]
REL_TOL = 1e-4
BATCH = 64
SERVER = dict(num_shards=1, q_block=8, combine_chunks=2, dynamic_switch=True)


def _bags(rng, rows, bag, n):
    """``n`` bags of ``min(bag, rows)`` distinct sorted ids."""
    return [np.sort(rng.choice(rows, size=min(bag, rows), replace=False)) for _ in range(n)]


@pytest.fixture(scope="module")
def model():
    """Seeded weights and N(0, 1) tables at the smoke size, a CPU server
    over the tables, one request of ``BATCH`` samples and its dense
    features."""
    cfg = dlrm_dcnv2.smoke()
    gen = torch.Generator().manual_seed(0)
    params = dlrm.init_dlrm(gen, cfg, device="cpu")
    params["tables"] = {n: torch.randn(t.shape, generator=gen)
                        for n, t in params["tables"].items()}
    rng = np.random.default_rng(1)
    names = [f"t{t}" for t in range(cfg.num_tables)]
    histories = {n: _bags(rng, cfg.rows_of(t), cfg.bag_sizes[t], 512)
                 for t, n in enumerate(names)}
    request = {n: _bags(rng, cfg.rows_of(t), cfg.bag_sizes[t], BATCH)
               for t, n in enumerate(names)}
    dense = torch.from_numpy(rng.normal(size=(BATCH, cfg.dense_features)).astype(np.float32))
    server = ShardedEmbeddingServer(params["tables"], histories, device="cpu",
                                    group_size=cfg.group_size, **SERVER)
    want = dcnv2_reference.forward(params, dense, request)
    return {"cfg": cfg, "params": params, "server": server, "histories": histories,
            "request": request, "dense": dense, "want": want, "names": names}


def _rel_err(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _served(m, cfg, server, params, dense):
    return dlrm.dlrm_forward(params, dataclasses.replace(cfg, embedding_path="served"),
                             dense, server.serve(m["request"]))


def test_served_path_matches_the_plain_reference(model):
    got = _served(model, model["cfg"], model["server"], model["params"], model["dense"])
    assert got.shape == (BATCH,) and got.dtype == torch.float32
    assert model["want"].abs().max() > 1.0
    assert _rel_err(got, model["want"]) <= REL_TOL


def test_a_bfloat16_run_of_the_served_path_fails_the_tolerance(model):
    cfg = dataclasses.replace(model["cfg"], dtype="bfloat16")

    def bf16(tree):
        if isinstance(tree, dict):
            return {k: bf16(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [bf16(v) for v in tree]
        return tree.to(torch.bfloat16)

    params = bf16(model["params"])
    server = ShardedEmbeddingServer(params["tables"], model["histories"], device="cpu",
                                    group_size=cfg.group_size, **SERVER)
    got = _served(model, cfg, server, params, model["dense"].to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel_err(got, model["want"]) > 10 * REL_TOL


def test_dense_kernel_and_served_paths_agree(model):
    m, cfg = model, model["cfg"]
    server = m["server"]
    layouts = {n: server.layouts[server.names.index(n)] for n in m["names"]}
    images = dlrm.build_images(m["params"], cfg, layouts)
    tiles = {n: tuple(getattr(compile_queries(layouts[n], m["request"][n], device="cpu"), f)
                      for f in ("tile_ids", "bitmaps")) for n in m["names"]}
    idx = {n: torch.from_numpy(np.stack(m["request"][n]).astype(np.int32)) for n in m["names"]}
    logits = {
        "dense": dlrm.dlrm_forward(m["params"], dataclasses.replace(cfg, embedding_path="dense"),
                                   m["dense"], idx),
        "kernel": dlrm.dlrm_forward(m["params"], cfg, m["dense"], tiles, images=images),
        "layout": dlrm.dlrm_forward(m["params"], dataclasses.replace(cfg, embedding_path="layout"),
                                    m["dense"], tiles, images=images),
        "served": _served(m, cfg, server, m["params"], m["dense"]),
    }
    for path, got in logits.items():
        assert _rel_err(got, m["want"]) <= REL_TOL, path


def test_one_low_rank_cross_layer_by_hand():
    x0 = torch.tensor([[1.0, 2.0, 3.0], [0.0, -1.0, 2.0]])
    layer = {"v": torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),   # 3 -> 2
             "w": torch.tensor([[1.0, 0.0, 2.0], [0.0, 1.0, -1.0]]),   # 2 -> 3
             "b": torch.tensor([0.5, 0.0, -1.0])}
    # x0 @ v = [[4, 5], [2, 1]]; @ w = [[4, 5, 3], [2, 1, 3]]; + b
    # = [[4.5, 5, 2], [2.5, 1, 2]]; x0 * that + x0
    want = torch.tensor([[1 * 4.5 + 1, 2 * 5 + 2, 3 * 2 + 3],
                         [0 * 2.5 + 0, -1 * 1 - 1, 2 * 2 + 2]])
    assert torch.equal(dlrm.cross_net([layer], x0), want)
    # a second layer feeds x1 through v and w, and still multiplies x0
    x1 = want
    again = x0 * ((x1 @ layer["v"]) @ layer["w"] + layer["b"]) + x1
    assert torch.equal(dlrm.cross_net([layer, layer], x0), again)


def test_init_draws_the_cross_layers_between_bottom_and_top(model):
    cfg, params = model["cfg"], model["params"]
    n = (cfg.num_tables + 1) * cfg.embed_dim
    assert [tuple(t.shape) for t in params["tables"].values()] == [
        (r, cfg.embed_dim) for r in cfg.table_rows]
    assert [(tuple(p["v"].shape), tuple(p["w"].shape), tuple(p["b"].shape))
            for p in params["cross"]] == [((n, cfg.dcn_low_rank_dim),
                                           (cfg.dcn_low_rank_dim, n), (n,))] * 3
    assert params["top"][0]["w"].shape == (n, cfg.top_mlp[0])
    # the same draws, in the same order, with the tables taken out
    gen = torch.Generator().manual_seed(0)
    for r in cfg.table_rows:
        torch.randn((r, cfg.embed_dim), generator=gen)
    dense = dlrm.init_dense(gen, cfg, device="cpu")
    assert list(dense) == ["bottom", "cross", "top"]
    for key in dense:
        for a, b in zip(dense[key], params[key]):
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_full_holds_the_published_sizes_and_one_card_cuts_five_row_counts():
    full, one = dlrm_dcnv2.FULL, dlrm_dcnv2.one_card()
    assert full.table_rows == (
        40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000, 3067956, 405282,
        10, 2209, 11938, 155, 4, 976, 14, 40000000, 40000000, 40000000, 590152, 12973, 108, 36)
    assert full.bag_sizes == (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100,
                              27, 10, 3, 1, 1)
    assert (full.num_tables, sum(full.table_rows), sum(full.bag_sizes)) == (26, 204184588, 214)
    assert (full.embed_dim, full.dense_features, full.bottom_mlp, full.top_mlp) == (
        128, 13, (512, 256, 128), (1024, 1024, 512, 256, 1))
    assert (full.interaction, full.dcn_num_layers, full.dcn_low_rank_dim) == ("dcn", 3, 512)
    assert (full.group_size, full.dtype, full.top_in) == (64, "float32", 3456)
    cut = [t for t, (a, b) in enumerate(zip(full.table_rows, one.table_rows)) if a != b]
    assert cut == [0, 9, 19, 20, 21]
    assert all(one.table_rows[t] == 5_000_000 for t in cut)
    assert sum(one.table_rows) == 29_184_588
    changed = {f.name for f in dataclasses.fields(full)
               if getattr(full, f.name) != getattr(one, f.name)}
    assert changed == {"table_rows", "rows_per_table"} and one.rows_per_table == 5_000_000


def test_table_count_rows_and_bag_follow_from_the_per_table_lists():
    cfg = dlrm_dcnv2.smoke()
    assert (cfg.num_tables, cfg.rows_per_table, cfg.max_bag) == (5, 2048, 16)
    assert (cfg.interaction, dlrm.DLRMConfig.interaction) == ("dcn", "dot")
    cut = dataclasses.replace(cfg, table_rows=(3, 10, 63), bag_sizes=(1, 4, 2))
    assert (cut.num_tables, cut.rows_per_table, cut.max_bag) == (3, 63, 4)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, bag_sizes=(1, 1))


@pytest.mark.parametrize("flag", [True, False])
def test_the_reference_leaves_the_callers_tf32_flags(model, flag):
    m = model
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = flag
    try:
        got = dcnv2_reference.forward(m["params"], m["dense"], m["request"])
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            flag, flag)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
    assert torch.equal(got, m["want"])


def test_the_benchmark_configuration_is_the_one_card_cut():
    one = dlrm_dcnv2.one_card()
    cfg = json.loads((ROOT / "recbench/configs/dlrm-dcnv2.json").read_text())
    assert [(t["rows"], t["bag"], t["law"]) for t in cfg["tables"]] == [
        (r, b, "fixed") for r, b in zip(one.table_rows, one.bag_sizes)]
    assert (cfg["embed_dim"], cfg["padded_dim"], cfg["dtype"]) == (128, 128, "float32")
    assert cfg["server"]["group_size"] == one.group_size
    assert cfg["published"]["num_embeddings_per_feature"] == list(dlrm_dcnv2.FULL.table_rows)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "dlrm-dcnv2")
    assert entry["reduced"] == list(cfg["reduced"]) == [f"t{t}.rows" for t in (0, 9, 19, 20, 21)]


@pytest.mark.parametrize("on", [True, False])
def test_model_spans_once_a_forward_while_tracing(model, on):
    m = model
    pooled = m["server"].serve(m["request"])
    cfg = dataclasses.replace(m["cfg"], embedding_path="served")
    was = trace.enabled()
    trace.set_enabled(on)
    trace.reset()
    try:
        for _ in range(2):
            dlrm.dlrm_forward(m["params"], cfg, m["dense"], pooled)
        spans = trace.totals()["spans"]
    finally:
        trace.set_enabled(was)
        trace.reset()
    want = {"model.bottom": 2, "model.interaction": 2, "model.top": 2} if on else {}
    assert {n: c for n, (_, c) in spans.items()} == want


def test_the_registry_is_unchanged():
    from repro.configs.base import list_configs as jax_list_configs

    assert list_configs() == jax_list_configs()
    assert "dlrm-dcnv2" not in list_configs()
