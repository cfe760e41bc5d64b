"""Lookup traffic: the one generator, driven by a traffic file.

A frozen copy of the arithmetic of ``repro_torch.data.synthetic.scale_trace``
(Zipf-popular rows bucketed into interest clusters, Zipf-popular template
baskets drawn over them), split in three so that each part has a seed of
its own:

* the **catalogue** of a table (popularity ranks, clusters, template
  baskets) comes from the configuration's ``catalogue_seed``;
* the **history** the server's plan is built from (``history_queries``
  bags) comes from the configuration's ``history_seed``;
* the **served stream** comes from the run's ``--seed``.

So the plan is the same in every run of a cell, and the served traffic is
drawn from the distribution the plan was built for.  Three departures from
``scale_trace``: a bag holds exactly as many distinct rows as its table's
bag law gives (repeated draws are rejected and drawn again, so under
``"poisson"`` the mean bag is Table I's "Avg. Lat"; ``scale_trace`` drops
repeats and serves shorter bags); a template whose cluster is empty is
drawn from the global popularity instead of being dropped; and the served
stream replays no template (below).

A table's bag law (:data:`LAWS`) is ``"poisson"``, ``1 + Poisson(bag - 1)``
rows clamped to the table's rows, as ``scale_trace`` draws them, or
``"fixed"``, exactly ``min(bag, rows)`` rows, as a multi-hot feature of a
fixed size looks up.  A fixed law draws no lengths, so it takes nothing
from the generators that the rows are drawn from.

A traffic file's ``kind`` is ``"templates"`` (co-occurring baskets) or
``"independent"`` (every row of every bag drawn on its own from the global
popularity: no templates, no clusters).  Under ``"templates"`` the history
is the template baskets themselves, each picked by a Zipf over templates,
as ``scale_trace`` draws its stream; a served bag picks its template the
same way and is then drawn afresh by that template's law (its cluster, a
new length, new rows), so no served bag is an array of the history and
two served bags are alike only by chance.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

KINDS = ("templates", "independent")
LAWS = ("poisson", "fixed")
#: requests generated at a time from a stream's generators; the stream a
#: seed gives does not depend on how many blocks are drawn
BLOCK_REQUESTS = 64
_MAX_ROUNDS = 64


def zipf_ranks(m: np.ndarray, u: np.ndarray, a: float) -> np.ndarray:
    """Inverse-CDF Zipf(``a``) rank in ``[0, m)`` for each uniform ``u``
    (the continuous approximation ``scale_trace`` uses)."""
    m = np.maximum(np.asarray(m, dtype=np.float64), 1.0)
    if abs(a - 1.0) < 1e-9:
        r = np.power(m, u) - 1.0
    else:
        r = np.power((np.power(m, 1.0 - a) - 1.0) * u + 1.0, 1.0 / (1.0 - a)) - 1.0
    return np.minimum(r.astype(np.int64), (m - 1).astype(np.int64))


@dataclasses.dataclass(frozen=True)
class Clusters:
    """The interest clusters of a table: cluster ``c``'s row of in-cluster
    popularity rank ``k`` is ``by_cluster[start[c] + k]``, for ``k`` below
    ``size[c]``."""

    by_cluster: np.ndarray
    start: np.ndarray
    size: np.ndarray


@dataclasses.dataclass(frozen=True)
class Catalogue:
    """One table's fixed structure: ``bag`` and ``law`` its bag law;
    ``porder[r]`` is the row of popularity rank ``r``; ``templates`` the
    template baskets and ``template_cluster`` the cluster of each (both
    ``None`` for independent traffic)."""

    rows: int
    bag: float
    law: str
    mix: dict
    porder: np.ndarray
    templates: list[np.ndarray] | None
    template_cluster: np.ndarray | None = None
    clusters: Clusters | None = None


def bag_lengths(cat: Catalogue, rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` bag lengths by the table's law, clamped to its rows; under
    ``"poisson"`` one draw from ``rng``, under ``"fixed"`` none."""
    if cat.law == "fixed":
        return np.full(n, min(int(cat.bag), cat.rows), dtype=np.int64)
    return np.minimum(1 + rng.poisson(max(cat.bag - 1.0, 0.0), size=n), cat.rows)


def _draw_global(cat: Catalogue, rng: np.random.Generator, n: int) -> np.ndarray:
    return cat.porder[zipf_ranks(np.full(n, cat.rows), rng.random(n), cat.mix["zipf_a"])]


def _draw_in_clusters(cat: Catalogue, cl: Clusters, rng: np.random.Generator,
                      c: np.ndarray) -> np.ndarray:
    """One row for each entry of ``c`` (a cluster): in the cluster, by its
    Zipf rank there, with probability ``in_cluster_p``, else from the
    global popularity."""
    a = cat.mix["zipf_a"]
    u = rng.random(c.size)
    inside = (rng.random(c.size) < cat.mix["in_cluster_p"]) & (cl.size[c] > 0)
    out = np.empty(c.size, dtype=np.int64)
    ci = c[inside]
    out[inside] = cl.by_cluster[cl.start[ci] + zipf_ranks(cl.size[ci], u[inside], a)]
    out[~inside] = cat.porder[zipf_ranks(np.full(int((~inside).sum()), cat.rows),
                                         u[~inside], a)]
    return out


def distinct_bags(rng: np.random.Generator, lens: np.ndarray, draw) -> list[np.ndarray]:
    """Bags of ``lens[i]`` distinct rows each, sorted.

    ``draw(owner)`` returns one row for each entry of ``owner`` (the bag it
    belongs to).  Draws are made in order and a repeat within a bag is
    rejected, so a bag is a sample without replacement: the first
    ``lens[i]`` distinct rows of its sequence of draws.  Bags still short
    draw again, with more draws, until none is.
    """
    n = lens.size
    out: list[np.ndarray | None] = [None] * n
    todo = np.arange(n, dtype=np.int64)
    factor = 1.5
    for _ in range(_MAX_ROUNDS):
        if todo.size == 0:
            return out  # type: ignore[return-value]
        want = lens[todo]
        count = np.ceil(want * factor).astype(np.int64) + 8
        owner = np.repeat(np.arange(todo.size, dtype=np.int64), count)
        rows = draw(todo[owner]).astype(np.int64)
        # first occurrence of each (bag, row), kept in draw order
        key = owner * np.int64(1 << 32) + rows
        order = np.argsort(key, kind="stable")
        first = np.ones(key.size, dtype=bool)
        first[order[1:]] = key[order[1:]] != key[order[:-1]]
        fresh_owner = owner[first]
        fresh_rows = rows[first]
        starts = np.searchsorted(fresh_owner, np.arange(todo.size))
        ends = np.searchsorted(fresh_owner, np.arange(todo.size), side="right")
        done = (ends - starts) >= want
        for j in np.flatnonzero(done).tolist():
            out[int(todo[j])] = np.sort(fresh_rows[starts[j]:starts[j] + want[j]])
        todo = todo[~done]
        factor *= 2.0
    raise RuntimeError(f"{todo.size} bags found too few distinct rows")


def make_catalogue(rows: int, bag: float, mix: dict, seed, law: str = "poisson") -> Catalogue:
    """The catalogue of one table, from ``seed`` (an int or a list of ints),
    its bags drawn by ``law`` (:data:`LAWS`) with parameter ``bag``."""
    if mix["kind"] not in KINDS:
        raise ValueError(f"traffic kind {mix['kind']!r} not in {KINDS}")
    if law not in LAWS:
        raise ValueError(f"bag law {law!r} not in {LAWS}")
    rng = np.random.default_rng(seed)
    porder = rng.permutation(rows).astype(np.int64)
    if mix["kind"] == "independent":
        return Catalogue(rows, float(bag), law, dict(mix), porder, None)
    a = mix["zipf_a"]
    num_clusters = max(8, rows // mix["rows_per_cluster"])
    prank = np.empty(rows, dtype=np.int64)
    prank[porder] = np.arange(rows, dtype=np.int64)
    cluster_of = rng.integers(0, num_clusters, size=rows)
    # the rows cluster by cluster, each in popularity order: cluster c's
    # rank k is by_cluster[cl_start[c] + k]
    by_cluster = np.lexsort((prank, cluster_of)).astype(np.int64)
    cl_start = np.searchsorted(cluster_of[by_cluster], np.arange(num_clusters + 1))
    clusters = Clusters(by_cluster, cl_start[:-1], np.diff(cl_start))
    # clusters ranked by their popularity mass
    pop = np.arange(1, rows + 1, dtype=np.float64) ** (-a)
    mass = np.zeros(num_clusters)
    np.add.at(mass, cluster_of, pop[prank])
    cl_rank = np.argsort(-mass, kind="stable")
    nt = max(64, rows // mix["rows_per_template"])
    tpl_cluster = cl_rank[zipf_ranks(np.full(nt, num_clusters), rng.random(nt),
                                     mix["template_zipf"])]
    cat = Catalogue(rows, float(bag), law, dict(mix), porder, None, tpl_cluster, clusters)
    templates = distinct_bags(rng, bag_lengths(cat, rng, nt),
                              lambda owner: _draw_in_clusters(cat, clusters, rng,
                                                              tpl_cluster[owner]))
    return dataclasses.replace(cat, templates=templates)


def draw_bags(cat: Catalogue, rng: np.random.Generator, n: int) -> list[np.ndarray]:
    """``n`` bags of the plan history, from ``rng``: under templates each is
    a template's own array, picked by the Zipf over templates."""
    if cat.templates is None:
        return distinct_bags(rng, bag_lengths(cat, rng, n),
                             lambda owner: _draw_global(cat, rng, owner.size))
    pick = zipf_ranks(np.full(n, len(cat.templates)), rng.random(n), cat.mix["template_zipf"])
    return [cat.templates[i] for i in pick.tolist()]


# --- the served stream, drawn with torch on the run's device ---------------
#
# A served bag is drawn by the same law as a template (or, for independent
# traffic, as a history bag), from a torch.Generator on the run's device:
# the window serves hundreds of thousands of fresh bags, which the host
# could not draw within a set-up of a minute.


def _zipf_ranks_t(m: torch.Tensor, u: torch.Tensor, a: float) -> torch.Tensor:
    """:func:`zipf_ranks` on tensors (float64)."""
    m = m.to(torch.float64).clamp_min(1.0)
    if abs(a - 1.0) < 1e-9:
        r = torch.pow(m, u) - 1.0
    else:
        r = torch.pow((torch.pow(m, 1.0 - a) - 1.0) * u + 1.0, 1.0 / (1.0 - a)) - 1.0
    return torch.minimum(r.to(torch.int64), m.to(torch.int64) - 1)


class DeviceCatalogue:
    """A catalogue's arrays on ``device``, for drawing served bags there."""

    def __init__(self, cat: Catalogue, device: torch.device):
        def t(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)

        self.cat = cat
        self.device = device
        self.porder = t(cat.porder)
        if cat.templates is not None:
            self.template_cluster = t(cat.template_cluster)
            self.by_cluster = t(cat.clusters.by_cluster)
            self.start = t(cat.clusters.start)
            self.size = t(cat.clusters.size)

    def _uniform(self, gen: torch.Generator, n: int) -> torch.Tensor:
        return torch.rand(n, generator=gen, device=self.device, dtype=torch.float64)

    def _draw(self, gen: torch.Generator, c: torch.Tensor | None) -> torch.Tensor:
        """One row for each entry of ``c`` (a cluster, or each entry of the
        global popularity when ``c`` is a count)."""
        mix, rows = self.cat.mix, self.cat.rows
        a = mix["zipf_a"]
        if not isinstance(c, torch.Tensor):
            u = self._uniform(gen, c)
            return self.porder[_zipf_ranks_t(torch.full_like(u, rows), u, a)]
        u = self._uniform(gen, c.numel())
        inside = (self._uniform(gen, c.numel()) < mix["in_cluster_p"]) & (self.size[c] > 0)
        size = torch.where(inside, self.size[c], rows)
        rank = _zipf_ranks_t(size, u, a)
        return torch.where(inside, self.by_cluster[(self.start[c] + rank).clamp_max(
            self.by_cluster.numel() - 1)], self.porder[rank.clamp_max(rows - 1)])

    def bags(self, gen: torch.Generator, n: int) -> tuple[np.ndarray, np.ndarray]:
        """``n`` fresh bags: their rows, bag after bag and each sorted, and
        their lengths, as host arrays.

        Each bag holds as many distinct rows as :func:`bag_lengths` gives
        (drawn here from ``gen``): the first that distinct of its sequence
        of draws, as :func:`distinct_bags`.
        """
        cat, dev = self.cat, self.device
        if cat.law == "fixed":
            lens = torch.full((n,), min(int(cat.bag), cat.rows), dtype=torch.int64, device=dev)
        else:
            lens = torch.poisson(torch.full((n,), max(cat.bag - 1.0, 0.0), dtype=torch.float64,
                                            device=dev), generator=gen).to(torch.int64) + 1
            lens = lens.clamp_max(cat.rows)
        cluster = None
        if cat.templates is not None:
            pick = _zipf_ranks_t(torch.full((n,), len(cat.templates), device=dev),
                                 self._uniform(gen, n), cat.mix["template_zipf"])
            cluster = self.template_cluster[pick]
        todo = torch.arange(n, device=dev)
        keys, factor = [], 1.5
        for _ in range(_MAX_ROUNDS):
            if todo.numel() == 0:
                break
            want = lens[todo]
            count = torch.ceil(want * factor).to(torch.int64) + 8
            owner = torch.repeat_interleave(torch.arange(todo.numel(), device=dev), count)
            rows = self._draw(gen, cluster[todo][owner] if cluster is not None else owner.numel())
            # first occurrence of each (bag, row) in draw order, and its rank
            # among its bag's distinct rows
            key = owner * (1 << 32) + rows
            sk, order = torch.sort(key, stable=True)
            first_sorted = torch.ones_like(sk, dtype=torch.bool)
            first_sorted[1:] = sk[1:] != sk[:-1]
            first = torch.empty_like(first_sorted)
            first[order] = first_sorted
            have = torch.zeros(todo.numel(), dtype=torch.int64, device=dev)
            have.index_add_(0, owner, first.to(torch.int64))
            before = torch.cumsum(have, 0) - have
            rank = torch.cumsum(first.to(torch.int64), 0) - 1 - before[owner]
            done = have >= want
            keep = first & (rank < want[owner]) & done[owner]
            keys.append(todo[owner[keep]] * (1 << 32) + rows[keep])
            todo = todo[~done]
            factor *= 2.0
        else:
            raise RuntimeError(f"{todo.numel()} bags found too few distinct rows")
        flat = torch.sort(torch.cat(keys)).values & ((1 << 32) - 1)
        return flat.cpu().numpy(), lens.cpu().numpy()


def seed_of(seed) -> int:
    """One 63-bit seed for a torch.Generator from a list of whole numbers."""
    return int(np.random.SeedSequence(list(seed)).generate_state(1, np.uint64)[0] >> np.uint64(1))


class Stream:
    """The served requests of one run: request ``i`` maps each table name to
    ``samples_per_request`` fresh bags (:meth:`DeviceCatalogue.bags`).
    Requests are drawn in blocks of :data:`BLOCK_REQUESTS` from one
    generator per table, on ``device``, so request ``i`` is the same
    whatever number of requests is drawn (on one kind of device)."""

    def __init__(self, catalogues: dict[str, Catalogue], samples: int, seed,
                 device="cpu"):
        device = torch.device(device)
        self.samples = samples
        self._tables = {}
        for t, n in enumerate(sorted(catalogues)):
            gen = torch.Generator(device=device)
            gen.manual_seed(seed_of([*seed, t]))
            self._tables[n] = (DeviceCatalogue(catalogues[n], device), gen)
        self.requests: list[dict[str, list[np.ndarray]]] = []

    def extend(self, count: int) -> None:
        """Draws requests until at least ``count`` are held."""
        while len(self.requests) < count:
            block = {}
            for n, (dcat, gen) in self._tables.items():
                flat, lens = dcat.bags(gen, BLOCK_REQUESTS * self.samples)
                block[n] = np.split(flat, np.cumsum(lens)[:-1])
            for i in range(BLOCK_REQUESTS):
                s = slice(i * self.samples, (i + 1) * self.samples)
                self.requests.append({n: bags[s] for n, bags in block.items()})

    def __getitem__(self, i: int) -> dict[str, list[np.ndarray]]:
        self.extend(i + 1)
        return self.requests[i]
