"""The frozen traffic generator: seeds, Table I's bag lengths, and the
independent mix's unrepeated baskets."""

import json
import math

import numpy as np
import pytest

from _recbench_tiny import ROOT
from recbench import generator, harness

TABLE_I = {"dlrm-automotive": (932_019, 42.26), "dlrm-office": (315_644, 64.088)}


def mix(name):
    return json.loads((ROOT / "recbench/traffic" / f"{name}.json").read_text())


def small_config(mean_bag=42.26):
    return {"tables": 2, "rows": 20_000, "mean_bag": mean_bag, "history_queries": 500,
            "catalogue_seed": 1, "history_seed": 2}


def same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("traffic", ["cooc", "indep"])
def test_same_seed_same_stream(traffic):
    cats, _ = harness.make_traffic(small_config(), mix(traffic))
    a = generator.Stream(cats, 8, (2**31 + 5, 1))
    b = generator.Stream(cats, 8, (2**31 + 5, 1))
    b.extend(3 * generator.BLOCK_REQUESTS)  # how far a stream is drawn changes nothing
    for i in range(generator.BLOCK_REQUESTS + 2):
        for name in cats:
            assert same(a[i][name], b[i][name])


@pytest.mark.parametrize("traffic", ["cooc", "indep"])
def test_seed_moves_the_stream_not_the_catalogue_or_history(traffic):
    cats1, hist1 = harness.make_traffic(small_config(), mix(traffic))
    cats2, hist2 = harness.make_traffic(small_config(), mix(traffic))
    for name in cats1:
        assert same(hist1[name], hist2[name])
        assert np.array_equal(cats1[name].porder, cats2[name].porder)
        if cats1[name].templates is not None:
            assert same(cats1[name].templates, cats2[name].templates)
    a = generator.Stream(cats1, 16, (1, 1))[0]
    b = generator.Stream(cats1, 16, (2, 1))[0]
    assert any(not same(a[n], b[n]) for n in a)


@pytest.mark.parametrize("config", sorted(TABLE_I))
def test_template_bags_sit_at_table_i(config):
    rows, bag = TABLE_I[config]
    cat = generator.make_catalogue(rows, bag, mix("cooc"), [1, 0])
    lens = np.array([t.size for t in cat.templates])
    # 1 + Poisson(bag - 1): the mean within 4 standard errors
    assert abs(lens.mean() - bag) < 4 * math.sqrt(bag - 1) / math.sqrt(lens.size)
    assert len(cat.templates) == rows // mix("cooc")["rows_per_template"]


@pytest.mark.parametrize("config", sorted(TABLE_I))
def test_independent_bags_sit_at_table_i(config):
    rows, bag = TABLE_I[config]
    cat = generator.make_catalogue(rows, bag, mix("indep"), [1, 0])
    bags = generator.draw_bags(cat, np.random.default_rng(3), 4000)
    lens = np.array([b.size for b in bags])
    assert abs(lens.mean() - bag) < 4 * math.sqrt(bag - 1) / math.sqrt(lens.size)


def test_indep_has_no_repeated_baskets():
    cats, hist = harness.make_traffic(small_config(), mix("indep"))
    for name in cats:
        assert cats[name].templates is None
        stream = generator.Stream({name: cats[name]}, 64, (9, 1))
        bags = [tuple(b) for i in range(8) for b in stream[i][name]] + [tuple(b) for b in hist[name]]
        assert len(set(bags)) == len(bags)


def test_cooc_repeats_templates():
    cats, hist = harness.make_traffic(small_config(), mix("cooc"))
    for name, bags in hist.items():
        assert len({tuple(b) for b in bags}) < len(bags) // 2


@pytest.mark.parametrize("traffic", ["cooc", "indep"])
def test_bags_hold_distinct_sorted_rows_in_range(traffic):
    cfg = small_config(mean_bag=300.0)  # bags that collide often in small clusters
    cats, hist = harness.make_traffic(cfg, mix(traffic))
    for bags in hist.values():
        for b in bags:
            assert b.dtype == np.int64 and b.size >= 1
            assert np.all(np.diff(b) > 0) and b[0] >= 0 and b[-1] < cfg["rows"]


def test_distinct_bags_is_a_sample_without_replacement():
    rng = np.random.default_rng(0)
    lens = np.array([1, 5, 10, 10])
    bags = generator.distinct_bags(rng, lens, lambda owner: rng.integers(0, 10, owner.size))
    assert [b.size for b in bags] == lens.tolist()
    assert np.array_equal(bags[2], np.arange(10))


@pytest.mark.parametrize("config", sorted(TABLE_I))
def test_served_bags_are_fresh_and_sit_at_table_i(config):
    """A served bag is drawn afresh by its template's law: none is an array
    of the history, hardly any repeats one's rows, and the mean bag is
    Table I's."""
    rows, bag = TABLE_I[config]
    cat = generator.make_catalogue(rows, bag, mix("cooc"), [1, 0])
    stream = generator.Stream({"t0": cat}, 32, (2**31 + 3, 1))
    bags = [b for i in range(2 * generator.BLOCK_REQUESTS) for b in stream[i]["t0"]]
    lens = np.array([b.size for b in bags])
    assert abs(lens.mean() - bag) < 4 * math.sqrt(bag - 1) / math.sqrt(lens.size)
    assert all(np.all(np.diff(b) > 0) and b[0] >= 0 and b[-1] < rows for b in bags)
    ids = {id(t) for t in cat.templates}
    assert not any(id(b) in ids for b in bags)
    history = {tuple(t) for t in cat.templates}
    assert sum(tuple(b) in history for b in bags) <= len(bags) // 100


def test_served_bags_keep_their_template_clusters():
    """Fresh bags co-occur as the templates do: most rows of a bag lie in
    one cluster."""
    cfg = small_config()
    cats, _ = harness.make_traffic(cfg, mix("cooc"))
    cat = cats["t0"]
    cluster_of = np.empty(cat.rows, dtype=np.int64)
    for c, (s, n) in enumerate(zip(cat.clusters.start, cat.clusters.size)):
        cluster_of[cat.clusters.by_cluster[s:s + n]] = c
    bags = generator.Stream(cats, 64, (7, 1))[0]["t0"]
    shares = [np.bincount(cluster_of[b]).max() / b.size for b in bags]
    assert np.median(shares) >= 0.7
