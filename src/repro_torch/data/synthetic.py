"""Synthetic Amazon-Review-like lookup workloads.

The paper evaluates on five Amazon Review categories whose defining
statistics are (Table I): number of embeddings 26 k – 963 k, mean bag
length ("Avg. Lat" — average lookups per query) 41 – 96, with power-law
access frequency and power-law co-occurrence (Fig. 2/4).

The dataset itself cannot ship here, so :func:`make_workload` synthesizes
traces with exactly those statistics: Zipf-distributed item popularity,
cluster-structured co-occurrence (items belong to soft "interest
clusters"; a query samples mostly within a cluster, which produces the
heavy-tailed co-occurrence the grouping algorithm exploits), and matched
table size / bag length per paper workload.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticWorkload:
    """Statistics-matched stand-in for one paper workload."""

    name: str
    num_rows: int          # "# of Embedding" (Table I)
    mean_bag: float        # "Avg. Lat" — mean lookups per query
    zipf_a: float = 1.2    # popularity exponent
    num_clusters: int = 0  # 0 → auto (~rows/256)
    in_cluster_p: float = 0.85  # probability a lookup stays in the query's cluster


# Paper Table I workloads. Row counts are scaled down 20x by default in
# make_workload(scale=...) so unit tests stay fast; benchmarks can run
# scale=1.0 for the full sizes.
WORKLOADS = {
    "software": SyntheticWorkload("software", 26_815, 41.32),
    "office_products": SyntheticWorkload("office_products", 315_644, 64.088),
    "electronics": SyntheticWorkload("electronics", 786_868, 55.746),
    "automotive": SyntheticWorkload("automotive", 932_019, 42.26),
    "sports": SyntheticWorkload("sports", 962_876, 96.019),
}


def zipf_popularity(num_rows: int, a: float, rng: np.random.Generator) -> np.ndarray:
    """Normalized Zipf pmf over rows, with a random rank permutation so
    hot ids are scattered across the id space (itemID order is NOT
    popularity order — this is what makes the naive mapping bad)."""
    ranks = np.arange(1, num_rows + 1, dtype=np.float64)
    p = ranks ** (-a)
    p /= p.sum()
    perm = rng.permutation(num_rows)
    out = np.empty(num_rows)
    out[perm] = p
    return out


def zipf_queries(
    num_rows: int,
    num_queries: int,
    mean_bag: float,
    *,
    zipf_a: float = 1.2,
    num_clusters: int | None = None,
    in_cluster_p: float = 0.85,
    basket_repeat_p: float = 0.65,
    num_baskets: int | None = None,
    seed: int = 0,
) -> List[np.ndarray]:
    """Generates a power-law, cluster-correlated query trace.

    Two levels of structure match real co-purchase data:

    * **Template baskets** — real sessions repeat item combinations (the
      structure MERCI's memoization and ReCross's grouping both exploit):
      with probability ``basket_repeat_p`` a query re-uses a popular
      template basket (Zipf-ranked) with a small perturbation.
    * **Interest clusters** — fresh queries pick a cluster by popularity,
      then draw ``k ~ 1 + Poisson(mean_bag - 1)`` lookups, each from the
      cluster w.p. ``in_cluster_p`` (by in-cluster popularity) else from
      the global Zipf.
    """
    rng = np.random.default_rng(seed)
    pop = zipf_popularity(num_rows, zipf_a, rng)
    if not num_clusters:
        num_clusters = max(8, num_rows // 256)

    # cluster assignment: contiguous popularity-rank chunks permuted into
    # id space (so clusters group items of mixed popularity)
    cluster_of = rng.integers(0, num_clusters, size=num_rows)
    cluster_rows: List[np.ndarray] = [
        np.where(cluster_of == c)[0] for c in range(num_clusters)
    ]
    cluster_pop = np.array([pop[r].sum() if len(r) else 0.0 for r in cluster_rows])
    cluster_pop /= cluster_pop.sum()

    def fresh_query() -> np.ndarray:
        c = rng.choice(num_clusters, p=cluster_pop)
        rows_c = cluster_rows[c]
        k = 1 + rng.poisson(max(mean_bag - 1.0, 0.0))
        picks = []
        if len(rows_c):
            pc = pop[rows_c] / pop[rows_c].sum()
            n_in = rng.binomial(k, in_cluster_p)
            if n_in:
                picks.append(rng.choice(rows_c, size=n_in, p=pc))
            k -= n_in
        if k:
            picks.append(rng.choice(num_rows, size=k, p=pop))
        q = np.unique(np.concatenate(picks)) if picks else np.array([0])
        return q.astype(np.int64)

    # template baskets, themselves Zipf-popular
    nb = num_baskets or max(16, num_queries // 8)
    baskets = [fresh_query() for _ in range(nb)]
    b_ranks = np.arange(1, nb + 1, dtype=np.float64) ** (-1.1)
    b_pop = b_ranks / b_ranks.sum()

    queries: List[np.ndarray] = []
    for _ in range(num_queries):
        if rng.random() < basket_repeat_p:
            q = baskets[int(rng.choice(nb, p=b_pop))]
            if rng.random() < 0.3 and len(q) > 2:  # small perturbation
                drop = rng.integers(0, len(q))
                q = np.delete(q, drop)
            queries.append(q.astype(np.int64))
        else:
            queries.append(fresh_query())
    return queries


def make_workload(
    name: str,
    *,
    num_queries: int = 2048,
    scale: float = 0.05,
    seed: int = 0,
) -> tuple[SyntheticWorkload, int, List[np.ndarray]]:
    """Returns (workload, num_rows_scaled, queries) for a paper workload.

    ``scale`` shrinks the table (and proportionally the bag length, floored
    at 8) so tests stay fast; scale=1.0 reproduces Table I sizes.
    """
    wl = WORKLOADS[name]
    rows = max(1024, int(wl.num_rows * scale))
    bag = max(8.0, wl.mean_bag * min(1.0, scale * 4 + 0.75))
    qs = zipf_queries(
        rows, num_queries, bag, zipf_a=wl.zipf_a,
        num_clusters=wl.num_clusters or None, in_cluster_p=wl.in_cluster_p,
        seed=seed,
    )
    return wl, rows, qs


def scale_trace(
    num_rows: int,
    num_queries: int,
    mean_bag: float,
    *,
    num_templates: int | None = None,
    zipf_a: float = 1.05,
    num_clusters: int | None = None,
    in_cluster_p: float = 0.85,
    template_zipf: float = 1.1,
    seed: int = 0,
) -> List[np.ndarray]:
    """Fully vectorized lookup trace for plan-build scale benches.

    :func:`zipf_queries` draws every fresh basket with an
    ``rng.choice(num_rows, p=pop)`` — O(num_rows) PER BASKET, unusable
    beyond ~100k rows.  This generator keeps the same two-level
    structure (Zipf-popular template baskets over Zipf-popular interest
    clusters) but samples everything in flat array passes, so a 10M-row
    / 1M-query trace builds in seconds:

    * rows are ranked by global Zipf popularity and bucketed into
      clusters; within a cluster, popularity order is inherited,
    * every template picks a cluster by cluster popularity, draws
      ``1 + Poisson(mean_bag - 1)`` lookups, each in-cluster w.p.
      ``in_cluster_p`` (by inverse-CDF Zipf rank over the cluster) else
      global, then dedups — one packed sort over the whole flat draw,
    * the query stream samples template ids from a Zipf over templates;
      queries share the template arrays by reference, so the trace
      costs O(num_templates * mean_bag + num_queries) memory.

    Identical queries ARE the point: the co-occurrence build collapses
    them to (pattern, multiplicity) before pair enumeration, which is
    what bounds the 10M-row build.
    """
    if num_rows < 1 or num_queries < 0:
        raise ValueError("num_rows must be >= 1 and num_queries >= 0")
    rng = np.random.default_rng(seed)
    nt = num_templates or max(64, num_rows // 64)
    if not num_clusters:
        num_clusters = max(8, num_rows // 256)
    C = int(num_clusters)

    # global popularity ordering: porder[r] = row with popularity rank r
    pop = zipf_popularity(num_rows, zipf_a, rng)
    porder = np.argsort(-pop, kind="stable").astype(np.int64)

    # cluster bucketing, rows within a cluster kept in popularity order:
    # sort rows by (cluster, popularity rank)
    cluster_of = rng.integers(0, C, size=num_rows)
    prank = np.empty(num_rows, dtype=np.int64)
    prank[porder] = np.arange(num_rows, dtype=np.int64)
    by_cluster = np.lexsort((prank, cluster_of))
    cl_sorted = cluster_of[by_cluster]
    cl_start = np.searchsorted(cl_sorted, np.arange(C + 1))
    cl_size = np.diff(cl_start)

    def zipf_ranks(m: np.ndarray, u: np.ndarray, a: float) -> np.ndarray:
        """Inverse-CDF Zipf(a) rank in [0, m) per draw (continuous
        approximation; exact enough for a synthetic workload)."""
        m = np.maximum(m.astype(np.float64), 1.0)
        if abs(a - 1.0) < 1e-9:
            r = np.power(m, u) - 1.0
        else:
            r = np.power((np.power(m, 1.0 - a) - 1.0) * u + 1.0, 1.0 / (1.0 - a)) - 1.0
        return np.minimum(r.astype(np.int64), (m - 1).astype(np.int64))

    # template cluster choices, Zipf-weighted by cluster popularity mass
    cl_mass = np.zeros(C)
    np.add.at(cl_mass, cl_sorted, pop[by_cluster])
    cl_rank = np.argsort(-cl_mass, kind="stable")
    tpl_c = cl_rank[zipf_ranks(np.full(nt, C), rng.random(nt), template_zipf)]
    tpl_c = tpl_c[cl_size[tpl_c] > 0]
    nt = tpl_c.size

    # flat item draws for all templates at once
    lens = 1 + rng.poisson(max(mean_bag - 1.0, 0.0), size=nt)
    tid = np.repeat(np.arange(nt, dtype=np.int64), lens)
    total = int(lens.sum())
    c_of_draw = tpl_c[tid]
    u = rng.random(total)
    in_c = rng.random(total) < in_cluster_p
    rows_flat = np.empty(total, dtype=np.int64)
    # in-cluster: Zipf rank within the draw's cluster bucket
    r_in = zipf_ranks(cl_size[c_of_draw[in_c]], u[in_c], zipf_a)
    rows_flat[in_c] = by_cluster[cl_start[c_of_draw[in_c]] + r_in]
    # global: Zipf rank over the whole table
    out_c = ~in_c
    rows_flat[out_c] = porder[
        zipf_ranks(np.full(int(out_c.sum()), num_rows), u[out_c], zipf_a)
    ]

    # per-template dedup in ONE packed sort: (template, row) ascending,
    # then drop adjacent duplicates within a template
    if total and num_rows > ((1 << 63) - 1) // max(total, 1):
        raise ValueError(
            f"scale_trace pack overflow: {nt} templates x {num_rows} rows"
        )
    key = tid * np.int64(num_rows) + rows_flat
    key = np.sort(key)
    keep = np.empty(total, dtype=bool)
    keep[0] = True
    np.not_equal(key[1:], key[:-1], out=keep[1:])
    key = key[keep]
    tid_d = key // num_rows
    rows_d = key - tid_d * num_rows
    tlens = np.bincount(tid_d, minlength=nt)
    ends = np.cumsum(tlens)
    starts = ends - tlens
    templates = [rows_d[s:e] for s, e in zip(starts.tolist(), ends.tolist())]
    templates = [t for t in templates if t.size]

    # query stream: Zipf-popular template picks, shared by reference
    pick = zipf_ranks(
        np.full(num_queries, len(templates)), rng.random(num_queries), template_zipf
    )
    return [templates[i] for i in pick.tolist()]
