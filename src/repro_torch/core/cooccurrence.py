"""Co-occurrence statistics for embedding lookups (ReCross §III-A steps 1-2).

The offline phase of ReCross starts from a *lookup history*: a sequence of
queries, each query being the set of embedding-row ids that one inference
pulls from one table (a multi-hot ``SparseLengthsSum`` bag in DLRM terms).

From the history we build

  * ``freq[i]``      — access frequency of row *i* (power-law in practice),
  * a *co-occurrence graph* — for every unordered pair ``(i, j)`` that
    appears together in at least one query, the number of queries
    containing both,

stored CSR-style (``indptr`` / ``indices`` / ``weights``), symmetric, with
neighbor lists sorted by id.  The graph is the input to the
correlation-aware grouping of :mod:`repro_torch.core.grouping`, which walks the
CSR arrays directly.

Everything here is vectorized NumPy on the host: pair enumeration packs
every (i, j) pair of every query into one int64 key array and counts them
with a single ``np.unique`` — no Python-level loop over queries or pairs —
so Criteo-scale histories (100k+ queries) compile in seconds.  This is
offline preprocessing, exactly as in the paper (the ReRAM image is
computed once, then written to the crossbars before inference).
``_reference_build_cooccurrence`` keeps the original dict-of-Counters loop
as the equivalence oracle for the property tests.

At 10M-row scale the all-at-once pair enumeration is the memory wall:
the flat pair list is O(sum of k² over distinct patterns), which dwarfs
the unique-edge output.  ``build_cooccurrence(..., block_pairs=...)``
caps the enumerated intermediate: distinct patterns are walked in chunks
whose pair budget is at most ``block_pairs`` (always at least one
pattern), each chunk is counted into a sorted (packed key, weight) run,
and runs are consolidated with an LSM-style geometric merge so the
accumulated state never exceeds O(unique edges) while each merge only
touches runs of comparable size.  Integer weight addition is associative
and the final key order is the same ascending packed order, so the
blocked build is bit-identical to the unblocked one for every block
size ≥ 1 pattern.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch.core.progress import StageProgress

Query = Sequence[int]


@dataclasses.dataclass
class CoOccurrenceGraph:
    """Sparse undirected co-occurrence graph in CSR form.

    Attributes:
      num_rows: total number of embedding rows (nodes), including rows that
        never appear in the history (isolated nodes).
      freq: ``(num_rows,)`` int64 — per-row access frequency.
      indptr: ``(num_rows + 1,)`` int64 — CSR row pointers.
      indices: ``(nnz,)`` int64 — neighbor ids, ascending within each row.
        Symmetric: edge (i, j) is stored in both row i and row j.
      weights: ``(nnz,)`` int64 — co-access counts aligned with indices.
      num_queries: number of (non-empty) queries in the history.
    """

    num_rows: int
    freq: np.ndarray
    indptr: np.ndarray
    indices: np.ndarray
    weights: np.ndarray
    num_queries: int

    # ---- basic graph API used by the grouping algorithm -----------------

    def neighbors(self, i: int) -> Dict[int, int]:
        """``{j: weight}`` view of row i (materialized; prefer
        :meth:`neighbor_arrays` in hot loops)."""
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return dict(zip(self.indices[lo:hi].tolist(), self.weights[lo:hi].tolist()))

    def neighbor_arrays(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, weights) CSR slices of row i — zero-copy."""
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.indices[lo:hi], self.weights[lo:hi]

    def weight(self, i: int, j: int) -> int:
        lo, hi = self.indptr[i], self.indptr[i + 1]
        k = lo + np.searchsorted(self.indices[lo:hi], j)
        if k < hi and self.indices[k] == j:
            return int(self.weights[k])
        return 0

    def degree(self, i: int) -> int:
        return int(self.indptr[i + 1] - self.indptr[i])

    @property
    def total_freq(self) -> int:
        return int(self.freq.sum())

    def nodes_by_frequency(self) -> np.ndarray:
        """Row ids sorted by descending access frequency (stable)."""
        # stable sort so equal-frequency rows keep id order (determinism)
        return np.argsort(-self.freq, kind="stable")

    def edge_count(self) -> int:
        return int(self.indices.shape[0]) // 2

    # ---- distribution diagnostics (paper Fig. 2 / Fig. 4) ---------------

    def correlation_counts(self) -> np.ndarray:
        """Number of correlated embeddings per row (paper Fig. 2)."""
        return np.diff(self.indptr).astype(np.int64)

    def powerlaw_alpha(self) -> float:
        """Crude MLE of the power-law exponent of the frequency distribution.

        Used only for reporting (the paper repeatedly observes power-law
        behaviour); not used by any algorithm.
        """
        f = self.freq[self.freq > 0].astype(np.float64)
        if f.size < 2:
            return float("nan")
        fmin = f.min()
        return 1.0 + f.size / np.log(f / fmin + 1e-12).sum()

    # ---- construction ----------------------------------------------------

    @classmethod
    def from_pair_counts(
        cls,
        num_rows: int,
        pair_i: np.ndarray,
        pair_j: np.ndarray,
        pair_w: np.ndarray,
        freq: np.ndarray,
        num_queries: int,
    ) -> "CoOccurrenceGraph":
        """Builds the symmetric CSR arrays from unique (i < j, weight) edges.

        Scatter construction, no sort of the doubled edge list: row r's
        ascending neighbor list is exactly its j-major-ordered incoming
        edges (all ids < r) followed by its i-major-ordered outgoing edges
        (all ids > r), so both halves are placed by segment-rank
        arithmetic; only the (j, i) ordering of the upper triangle needs
        one argsort of E entries (half the edge list).
        """
        pair_i = np.asarray(pair_i, dtype=np.int64)
        pair_j = np.asarray(pair_j, dtype=np.int64)
        pair_w = np.asarray(pair_w, dtype=np.int64)
        n_edges = pair_i.size
        freq = np.asarray(freq, dtype=np.int64)
        if n_edges == 0:
            return cls(
                num_rows=num_rows, freq=freq,
                indptr=np.zeros(num_rows + 1, np.int64),
                indices=np.empty(0, np.int64), weights=np.empty(0, np.int64),
                num_queries=num_queries,
            )
        if (pair_i >= pair_j).any():
            raise ValueError("edges must be upper-triangle (i < j)")
        key = pair_i * np.int64(num_rows) + pair_j
        if np.any(key[1:] <= key[:-1]):  # callers usually pass (i, j)-sorted
            order = np.argsort(key)
            pair_i, pair_j, pair_w = pair_i[order], pair_j[order], pair_w[order]

        deg_out = np.bincount(pair_i, minlength=num_rows).astype(np.int64)
        deg_in = np.bincount(pair_j, minlength=num_rows).astype(np.int64)
        indptr = np.zeros(num_rows + 1, dtype=np.int64)
        np.cumsum(deg_out + deg_in, out=indptr[1:])

        pos_out = indptr[pair_i] + deg_in[pair_i] + segment_ranks(deg_out)

        order_in = np.argsort(pair_j * np.int64(num_rows) + pair_i)
        bj, bi, bw = pair_j[order_in], pair_i[order_in], pair_w[order_in]
        pos_in = indptr[bj] + segment_ranks(deg_in)

        indices = np.empty(2 * n_edges, dtype=np.int64)
        weights = np.empty(2 * n_edges, dtype=np.int64)
        indices[pos_out] = pair_j
        weights[pos_out] = pair_w
        indices[pos_in] = bi
        weights[pos_in] = bw
        return cls(
            num_rows=num_rows, freq=freq, indptr=indptr,
            indices=indices, weights=weights, num_queries=num_queries,
        )

    def unique_edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(i, j, w) arrays of the upper-triangle (i < j) edge list."""
        src = np.repeat(np.arange(self.num_rows, dtype=np.int64), np.diff(self.indptr))
        upper = src < self.indices
        return src[upper], self.indices[upper], self.weights[upper]


def flatten_ragged(queries: Iterable[Query]) -> Tuple[np.ndarray, np.ndarray, int]:
    """Flattens a ragged id history into ``(flat_ids, lengths, num_queries)``.

    Keeps zero-length queries (their length is 0) so callers that index by
    batch position — the query compiler, the per-query diagnostics — keep
    their alignment.  The one flatten idiom shared by the whole offline
    pipeline.
    """
    arrays = [np.asarray(q, dtype=np.int64).ravel() for q in queries]
    nq = len(arrays)
    lengths = np.fromiter((a.size for a in arrays), np.int64, nq)
    if nq == 0 or int(lengths.sum()) == 0:
        return np.empty(0, np.int64), lengths, nq
    flat = np.concatenate([a for a in arrays if a.size])
    return flat, lengths, nq


def segment_ranks(lengths: np.ndarray) -> np.ndarray:
    """``0..len-1`` within each run of a lengths array, concatenated.

    The rank-within-segment companion of :func:`flatten_ragged`; the one
    place the ``arange - repeat(cumsum - lengths)`` index arithmetic
    lives.  Zero-length segments contribute nothing.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    starts = np.cumsum(lengths) - lengths
    return (
        np.arange(int(lengths.sum()), dtype=np.int64)
        - np.repeat(starts, lengths)
    )


def _dedup_within_queries(
    queries: Iterable[Query], num_rows: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Flattens a ragged history into per-query sorted+deduped id runs.

    Returns (rows, query_lengths, num_queries) where ``rows`` concatenates
    each non-empty query's unique ids in ascending order (empty queries
    are dropped; ``num_queries`` counts the non-empty ones).
    """
    flat, lengths, _ = flatten_ragged(queries)
    lengths = lengths[lengths > 0]
    nq = int(lengths.size)
    if nq == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64), 0
    bad = (flat < 0) | (flat >= num_rows)
    if bad.any():
        i = int(flat[bad][0])
        raise ValueError(f"row id {i} out of range [0, {num_rows})")
    qid = np.repeat(np.arange(nq, dtype=np.int64), lengths)
    # pack (qid, row) into one key so a value-only np.sort replaces the
    # far slower lexsort; nq * num_rows stays well under 2^63 for any
    # realistic table/history (guarded just in case)
    if nq * num_rows < 2**62:
        key = np.sort(qid * np.int64(num_rows) + flat)
        keep = np.ones(key.size, dtype=bool)
        keep[1:] = key[1:] != key[:-1]
        key = key[keep]
        rows, qid = key % num_rows, key // num_rows
    else:  # pragma: no cover - overflow guard
        order = np.lexsort((flat, qid))
        flat, qid = flat[order], qid[order]
        keep = np.ones(flat.size, dtype=bool)
        keep[1:] = (flat[1:] != flat[:-1]) | (qid[1:] != qid[:-1])
        rows, qid = flat[keep], qid[keep]
    return rows, np.bincount(qid, minlength=nq).astype(np.int64), nq


def _enumerate_pairs(
    rows: np.ndarray,
    lengths: np.ndarray,
    max_pairs_per_query: int | None,
) -> Tuple[np.ndarray, np.ndarray]:
    """All (left, right) index pairs within each query run, vectorized.

    Pair order within a query matches the reference double loop: left
    position ascending, then right position ascending — which is what
    makes ``max_pairs_per_query`` truncation agree with the loop version.
    """
    n = rows.size
    local = segment_ranks(lengths)
    rep = np.repeat(lengths, lengths) - 1 - local    # left-appearances per elem
    if int(rep.sum()) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    left = np.repeat(np.arange(n, dtype=np.int64), rep)
    right = segment_ranks(rep) + left + 1
    if max_pairs_per_query is not None:
        ppq = lengths * (lengths - 1) // 2
        m = segment_ranks(ppq) < max_pairs_per_query
        left, right = left[m], right[m]
    return left, right


def _dedup_identical_queries(
    rows: np.ndarray, lengths: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapses byte-identical queries into (rows, lengths, multiplicity).

    Recommendation traces repeat template baskets heavily; counting each
    distinct query once and weighting its pairs by multiplicity is exact
    (a pair's count is the number of queries containing it) and shrinks
    the O(k²) pair enumeration by the repeat factor.  Queries are grouped
    by length (equal queries must have equal length), each group is
    deduplicated with one ``np.unique(axis=0)`` over its (n, L) id matrix.
    """
    nq = lengths.size
    starts = np.cumsum(lengths) - lengths
    out_rows, out_lens, out_mult = [], [], []
    for length in np.unique(lengths):
        sel = np.where(lengths == length)[0]
        if length == 0:
            continue
        mat = rows[starts[sel][:, None] + np.arange(length)]
        uniq, mult = np.unique(mat, axis=0, return_counts=True)
        out_rows.append(uniq.ravel())
        out_lens.append(np.full(uniq.shape[0], length, dtype=np.int64))
        out_mult.append(mult.astype(np.int64))
    if not out_rows:
        return rows[:0], lengths[:0], lengths[:0]
    return (
        np.concatenate(out_rows),
        np.concatenate(out_lens),
        np.concatenate(out_mult),
    )


def _check_pair_key_capacity(num_rows: int) -> None:
    """Packed pair keys are ``i * num_rows + j`` — both < num_rows, so the
    encoding needs ``num_rows**2 < 2**63``.  Raised *before* any pair
    allocation so a too-tall table fails loudly and instantly."""
    if num_rows > 3_037_000_499:  # isqrt(2^63): packed keys would wrap
        raise NotImplementedError(
            f"num_rows={num_rows} exceeds int64 pair-key packing "
            f"(limit 3_037_000_499 rows)"
        )


def build_cooccurrence(
    queries: Iterable[Query],
    num_rows: int,
    *,
    max_pairs_per_query: int | None = None,
    block_pairs: int | None = None,
) -> CoOccurrenceGraph:
    """Builds frequency + co-occurrence graph from a lookup history.

    Fully vectorized: the history is flattened once, ids are deduped per
    query with one lexsort, byte-identical queries are collapsed to
    (pattern, multiplicity), and every pair of every distinct pattern is
    counted by ``np.unique`` over packed ``i * num_rows + j`` int64 keys
    with multiplicity weights.

    Args:
      queries: iterable of queries; each query is a sequence of row ids
        (duplicates within a query are collapsed — co-occurrence is a set
        property, matching the paper's "accessed together" definition).
      num_rows: table height.
      max_pairs_per_query: optional cap on the pairs enumerated per query
        (queries are O(k^2) in pairs; DLRM bags are small, k ≲ 100, so the
        default unbounded enumeration is what the paper does).  The first
        pairs in (left, right) position order are kept, matching the
        reference implementation's truncation.
      block_pairs: cap on the number of pairs enumerated at once.  None
        enumerates every pair of every pattern in one flat array (fastest
        when it fits); an integer walks the patterns in chunks of at most
        ``block_pairs`` pairs (at least one pattern per chunk) so the
        peak intermediate is O(block_pairs), not O(total pairs).  The
        result is bit-identical for every value.

    Returns:
      A :class:`CoOccurrenceGraph`.
    """
    _check_pair_key_capacity(num_rows)
    if block_pairs is not None and block_pairs < 1:
        raise ValueError("block_pairs must be >= 1")
    rows, lengths, nq = _dedup_within_queries(queries, num_rows)
    rows, lengths, mult = _dedup_identical_queries(rows, lengths)
    freq = np.bincount(
        rows, weights=np.repeat(mult, lengths).astype(np.float64),
        minlength=num_rows,
    ).astype(np.int64)
    ppq = lengths * (lengths - 1) // 2
    if max_pairs_per_query is not None:
        ppq = np.minimum(ppq, max_pairs_per_query)
    total_pairs = int(ppq.sum())
    if total_pairs == 0:
        e = np.empty(0, np.int64)
        return CoOccurrenceGraph.from_pair_counts(num_rows, e, e, e, freq, nq)
    if block_pairs is None or block_pairs >= total_pairs:
        left, right = _enumerate_pairs(rows, lengths, max_pairs_per_query)
        pair_w = np.repeat(mult, ppq)
        keys = rows[left] * np.int64(num_rows) + rows[right]
        uk, w = _count_packed_keys(keys, pair_w, num_rows)
    else:
        uk, w = _blocked_pair_counts(
            rows, lengths, mult, ppq, num_rows, max_pairs_per_query, block_pairs
        )
    return CoOccurrenceGraph.from_pair_counts(
        num_rows, uk // num_rows, uk % num_rows, w, freq, nq
    )


def _merge_key_runs(
    a: Tuple[np.ndarray, np.ndarray], b: Tuple[np.ndarray, np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    """Merges two sorted-unique (keys, weights) runs, summing weights."""
    k = np.concatenate([a[0], b[0]])
    w = np.concatenate([a[1], b[1]])
    order = np.argsort(k, kind="stable")  # two sorted runs: mergesort is O(n)
    k, w = k[order], w[order]
    starts = np.ones(k.size, dtype=bool)
    starts[1:] = k[1:] != k[:-1]
    idx = np.flatnonzero(starts)
    return k[idx], np.add.reduceat(w, idx)


def _blocked_pair_counts(
    rows: np.ndarray,
    lengths: np.ndarray,
    mult: np.ndarray,
    ppq: np.ndarray,
    num_rows: int,
    max_pairs_per_query: int | None,
    block_pairs: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pair counting with an O(block_pairs) enumerated intermediate.

    Walks the distinct patterns in chunks whose summed pair budget stays
    ≤ ``block_pairs`` (always ≥ 1 pattern so a bag wider than the block
    still makes progress), counts each chunk into a sorted-unique
    (packed key, weight) run, and consolidates runs with a geometric
    merge stack: a run is folded into its neighbor whenever the neighbor
    is less than twice its size, so every edge participates in
    O(log #chunks) merges and the resident runs total O(unique edges).
    """
    row_starts = np.cumsum(lengths) - lengths
    cum = np.cumsum(ppq)
    total = int(cum[-1])
    progress = StageProgress("cooc", total, unit="pairs")
    runs: List[Tuple[np.ndarray, np.ndarray]] = []
    p0 = 0
    num_patterns = int(lengths.size)
    nr = np.int64(num_rows)
    while p0 < num_patterns:
        base = int(cum[p0 - 1]) if p0 else 0
        p1 = max(int(np.searchsorted(cum, base + block_pairs, side="right")), p0 + 1)
        r0 = int(row_starts[p0])
        r1 = int(row_starts[p1 - 1] + lengths[p1 - 1])
        left, right = _enumerate_pairs(
            rows[r0:r1], lengths[p0:p1], max_pairs_per_query
        )
        if left.size:
            pair_w = np.repeat(mult[p0:p1], ppq[p0:p1])
            keys = rows[r0:r1][left] * nr + rows[r0:r1][right]
            runs.append(_count_packed_keys(keys, pair_w, num_rows))
            while len(runs) >= 2 and runs[-2][0].size < 2 * runs[-1][0].size:
                runs[-2:] = [_merge_key_runs(runs[-2], runs[-1])]
        progress.tick(int(cum[p1 - 1]))
        p0 = p1
    progress.finish(total)
    while len(runs) >= 2:
        runs[-2:] = [_merge_key_runs(runs[-2], runs[-1])]
    if not runs:  # pragma: no cover - total_pairs > 0 guarantees a run
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return runs[0]


def _count_packed_keys(
    keys: np.ndarray, weights: np.ndarray, num_rows: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Sums ``weights`` per unique packed pair key; returns sorted
    (keys, weights).

    Hot path packs the weight into the key's low bits so one value-only
    ``np.sort`` + ``np.add.reduceat`` replaces argsort/unique indirection
    (≈3× faster on multi-million-pair histories).  Falls back to
    ``np.unique`` when the combined key would not fit 63 bits.
    """
    w_max = int(weights.max())
    shift = 62 - (num_rows * num_rows).bit_length()
    if shift > 0 and w_max < (1 << shift):
        packed = np.sort((keys << shift) | weights)
        high = packed >> shift
        starts = np.ones(high.size, dtype=bool)
        starts[1:] = high[1:] != high[:-1]
        starts_idx = np.flatnonzero(starts)
        w = np.add.reduceat(packed & ((np.int64(1) << shift) - 1), starts_idx)
        uk = high[starts_idx]
    else:  # pragma: no cover - enormous-multiplicity guard
        uk, inv = np.unique(keys, return_inverse=True)
        w = np.bincount(inv, weights=weights.astype(np.float64)).astype(np.int64)
    return uk, w.astype(np.int64)


def _count_weighted_keys(
    keys: np.ndarray, weights: np.ndarray, num_rows: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(i, j, weight) form of :func:`_count_packed_keys` (legacy callers)."""
    uk, w = _count_packed_keys(keys, weights, num_rows)
    return uk // num_rows, uk % num_rows, w


def _reference_build_cooccurrence(
    queries: Iterable[Query],
    num_rows: int,
    *,
    max_pairs_per_query: int | None = None,
) -> CoOccurrenceGraph:
    """Original pair-by-pair loop implementation (equivalence oracle)."""
    freq = np.zeros(num_rows, dtype=np.int64)
    pair_counts: collections.Counter = collections.Counter()
    num_queries = 0

    for q in queries:
        ids = sorted(set(int(i) for i in q))
        if not ids:
            continue
        num_queries += 1
        for i in ids:
            if not 0 <= i < num_rows:
                raise ValueError(f"row id {i} out of range [0, {num_rows})")
            freq[i] += 1
        pairs = ((ids[a], ids[b]) for a in range(len(ids)) for b in range(a + 1, len(ids)))
        if max_pairs_per_query is not None:
            pairs = _take(pairs, max_pairs_per_query)
        pair_counts.update(pairs)

    if pair_counts:
        items = np.array([(i, j, w) for (i, j), w in pair_counts.items()], dtype=np.int64)
        pi, pj, w = items[:, 0], items[:, 1], items[:, 2]
    else:
        pi = pj = w = np.empty(0, np.int64)
    return CoOccurrenceGraph.from_pair_counts(num_rows, pi, pj, w, freq, num_queries)


def _take(it, n):
    for k, x in enumerate(it):
        if k >= n:
            return
        yield x


def merge_graphs(a: CoOccurrenceGraph, b: CoOccurrenceGraph) -> CoOccurrenceGraph:
    """Merges two histories (e.g. shards of a distributed trace collection).

    This is what a production deployment does: every serving replica logs
    its own lookup histogram, and the offline phase folds them together.
    Pure array concatenation + one ``np.unique`` — no Python loop.
    """
    if a.num_rows != b.num_rows:
        raise ValueError("graphs cover different tables")
    ai, aj, aw = a.unique_edges()
    bi, bj, bw = b.unique_edges()
    keys = np.concatenate([ai, bi]) * np.int64(a.num_rows) + np.concatenate([aj, bj])
    w = np.concatenate([aw, bw])
    uk, inv = np.unique(keys, return_inverse=True)
    mw = np.bincount(inv, weights=w.astype(np.float64)).astype(np.int64)
    return CoOccurrenceGraph.from_pair_counts(
        a.num_rows, uk // a.num_rows, uk % a.num_rows, mw,
        a.freq + b.freq, a.num_queries + b.num_queries,
    )
