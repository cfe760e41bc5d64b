"""A configuration's tables: the two forms of ``tables``, the bag laws, the
identical-tables form drawn bit for bit as it always was, and a
configuration that lists its tables run as data alone."""

import hashlib
import json

import numpy as np
import pytest
import torch

from _recbench_tiny import ROOT, TINY, TINY_TABLES, run_tiny, tiny_config
from recbench import generator, harness

SEED = 2**31 + 7
#: requests of each stream digested
REQUESTS = 128
#: the digests of what the identical-tables form draws for the ``tiny``
#: configuration on the CPU (table values from ``SEED``, each table's
#: popularity order, templates and history, and the stream's first
#: ``REQUESTS`` requests from ``(SEED, 1)``), taken from the harness as it
#: was before a configuration could list its tables
PINNED = {
    "values": "550da309cb205e3a",
    "cooc.t0.porder": "c4fa07fb6337ecd4",
    "cooc.t0.templates": "a99d86865ced9d2e",
    "cooc.t0.history": "c7101cee43c1ed39",
    "cooc.t1.porder": "307241f44189b89d",
    "cooc.t1.templates": "f503dd308425e65c",
    "cooc.t1.history": "5c740b468a44a630",
    "cooc.stream": "a5d3fa27be902c48",
    "indep.t0.porder": "c4fa07fb6337ecd4",
    "indep.t0.history": "4e82bc43e43a4efd",
    "indep.t1.porder": "307241f44189b89d",
    "indep.t1.history": "8af38510070342a4",
    "indep.stream": "b0667b778a3280d7",
}


def mix(name):
    return json.loads((ROOT / "recbench/traffic" / f"{name}.json").read_text())


def digest(arrays) -> str:
    d = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        d.update(str(a.dtype).encode() + str(a.shape).encode())
        d.update(a.tobytes())
    return d.hexdigest()[:16]


def int64(bags):
    return (np.asarray(b, dtype=np.int64) for b in bags)


@pytest.fixture(scope="module")
def tiny_digests():
    config = tiny_config("tiny", TINY)
    out = {"values": digest(t.numpy() for t in harness.make_tables(config, SEED, "cpu"))}
    for name in ("cooc", "indep"):
        cats, hist = harness.make_traffic(config, mix(name))
        for t in sorted(cats):
            out[f"{name}.{t}.porder"] = digest([cats[t].porder])
            if cats[t].templates is not None:
                out[f"{name}.{t}.templates"] = digest(int64(cats[t].templates))
            out[f"{name}.{t}.history"] = digest(int64(hist[t]))
        stream = generator.Stream(cats, mix(name)["samples_per_request"], (SEED, 1), "cpu")
        out[f"{name}.stream"] = digest(b for i in range(REQUESTS) for t in sorted(cats)
                                       for b in int64(stream[i][t]))
    return out


@pytest.mark.parametrize("part", sorted(PINNED))
def test_identical_tables_draw_what_they_always_drew(tiny_digests, part):
    assert set(tiny_digests) == set(PINNED)
    assert tiny_digests[part] == PINNED[part]


def test_a_count_of_tables_reads_as_identical_poisson_entries():
    tables = harness.tables_of({"tables": 3, "rows": 500, "mean_bag": 4.5})
    assert tables == [harness.Table(f"t{t}", 500, 4.5, "poisson") for t in range(3)]
    listed = harness.tables_of({"tables": [{"rows": 500, "bag": 4.5, "law": "poisson"},
                                           {"rows": 3, "bag": 100, "law": "fixed"}]})
    assert listed == [harness.Table("t0", 500, 4.5, "poisson"),
                      harness.Table("t1", 3, 100.0, "fixed")]


@pytest.mark.parametrize("tables", [
    [], 0, [{"rows": 10, "bag": 1}], [{"rows": 10, "bag": 1, "law": "zipf"}],
    [{"rows": 0, "bag": 1, "law": "fixed"}], [{"rows": 10, "bag": 0.5, "law": "poisson"}],
    [{"rows": 10, "bag": 2.5, "law": "fixed"}], [{"rows": 10, "bag": 1, "law": "fixed", "dim": 64}],
])
def test_a_table_the_harness_cannot_serve_is_refused(tables):
    with pytest.raises(ValueError):
        harness.tables_of({"tables": tables, "rows": 10, "mean_bag": 2.0})


def test_listed_tables_draw_each_from_its_own_seed():
    config = tiny_config("tiny-tables", TINY_TABLES)
    tables = harness.make_tables(config, SEED, "cpu")
    assert [tuple(t.shape) for t in tables] == [(e["rows"], 128) for e in TINY_TABLES["tables"]]
    for t, values in enumerate(tables):
        gen = torch.Generator().manual_seed(generator.seed_of([SEED, t]))
        want = torch.zeros_like(values).normal_(generator=gen)
        assert torch.equal(values, want)


@pytest.mark.parametrize("traffic", ["cooc", "indep"])
def test_fixed_bags_hold_exactly_their_size(traffic):
    """Every history and served bag of a fixed law holds ``min(bag, rows)``
    distinct rows, sorted, in range: tables smaller than a tile, a cluster
    or a template included."""
    config = tiny_config("tiny-tables", TINY_TABLES)
    cats, hist = harness.make_traffic(config, mix(traffic))
    stream = generator.Stream(cats, mix(traffic)["samples_per_request"], (SEED, 1), "cpu")
    for table in harness.tables_of(config):
        want = min(int(table.bag), table.rows)
        served = [b for i in range(2 * generator.BLOCK_REQUESTS) for b in stream[i][table.name]]
        for b in list(hist[table.name]) + served:
            assert b.size == want and np.all(np.diff(b) > 0) and 0 <= b[0] and b[-1] < table.rows


def test_a_fixed_law_draws_no_lengths():
    """A fixed law gives ``min(bag, rows)`` and takes no draw from the
    generator it is handed."""
    rng = np.random.default_rng(5)
    cat = generator.make_catalogue(1000, 7, mix("indep"), [1, 0], "fixed")
    state = rng.bit_generator.state
    assert generator.bag_lengths(cat, rng, 50).tolist() == [7] * 50
    assert rng.bit_generator.state == state
    tiny = generator.make_catalogue(3, 7, mix("indep"), [1, 0], "fixed")
    assert generator.bag_lengths(tiny, rng, 4).tolist() == [3] * 4


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("traffic", ["cooc", "indep"])
def test_a_config_that_lists_its_tables_runs_as_data_alone(tiny_root, traffic, traced):
    line, run = run_tiny(tiny_root, f"tiny-tables.{traffic}", traced=traced)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0, line["checks"]
    assert run["samples"] == mix(traffic)["samples_per_request"] * line["attempted"]
    assert (run["program"] is not None) == traced
