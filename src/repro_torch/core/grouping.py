"""Correlation-aware embedding grouping (ReCross §III-B, Algorithm 1).

Greedily partitions embedding rows into groups of ``group_size`` (the
crossbar height, 64 in the paper) such that rows that co-occur in queries
land in the same group.  A query then activates few groups (crossbars /
VMEM tiles) instead of scattering across many.

The implementation follows Algorithm 1 line-for-line, with three
production-grade refinements that do not change the algorithm's semantics:

  * the candidate list is a lazy max-heap keyed by co-occurrence weight
    *into the current group* (Algorithm 1 recomputes the max by a linear
    scan; the heap makes the whole pass O(E log E) instead of O(V·E));
    neighbor expansion reads the graph's CSR slices directly
    (:meth:`CoOccurrenceGraph.neighbor_arrays`), no per-row dicts,
  * candidate weights live in a flat array indexed by row id (bulk
    scatter-add per pick) and each pick pushes ONE heap entry — the
    whole neighbor batch, pre-sorted by ``(-weight, id)`` with NumPy and
    advanced lazily on pop.  Most pushed candidates are never popped
    (a 64-row group consumes 64 picks out of thousands of candidate
    updates), so the batch heap turns ~E per-edge ``heappush`` calls
    into ~V batch pushes,
  * rows with no ungrouped neighbours left fall back to frequency order,
    which is what "foreach embedding in sorted(embeddingList)" yields
    anyway once candidateList is empty.

``_reference_correlation_aware_grouping`` retains the original dict+
per-edge-push loop as the equivalence oracle; the batch-heap pass is
bit-identical (pop order is the same total order on ``(-weight, id)``,
see the invariant note on :func:`correlation_aware_grouping`).

**Epoch-blocked formulation (DESIGN.md §11).** At 10M rows the scalar
pop loop is the plan-build wall: every pick costs one heap pop plus one
CSR push, ~15 interpreter-bound microseconds each.  ``epoch > 1``
switches to a blocked pass that amortises that overhead over whole
rounds: each round bulk-extracts up to ``epoch`` picks from the heap's
top batches — the validated prefix of each batch that outranks the
true second-best head is consumed in ONE vectorized compare — then
pushes the merged CSR neighbourhoods of every pick in the round as a
single scatter-add (``np.subtract.at`` on the packed accumulator) and
one pre-sorted batch.  ``epoch=1`` reproduces the scalar pop-push
interleaving exactly (bit-identical to the oracle, pinned in tests);
``epoch>1`` trades pick-by-pick weight accumulation inside a round for
throughput, with the grouping-quality bound (total intra-group
co-occurrence mass >= 99% of the oracle's, :func:`grouping_quality`)
pinned in tests and recorded by ``benchmarks/pipeline_bench.py``.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cooccurrence import CoOccurrenceGraph
from repro_torch.core.progress import StageProgress


@dataclasses.dataclass
class Grouping:
    """Result of the grouping pass.

    Attributes:
      groups: list of groups; each group is a list of row ids,
        ``len(group) <= group_size`` (only the last group may be short).
      group_of: ``(num_rows,)`` int32 — group index of each row.
      slot_of: ``(num_rows,)`` int32 — slot (wordline) of each row inside
        its group.
      group_size: the crossbar height used.
    """

    groups: List[List[int]]
    group_of: np.ndarray
    slot_of: np.ndarray
    group_size: int

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def group_freq(self, freq: np.ndarray) -> np.ndarray:
        """Aggregate access frequency per group (input to Eq. 1 replication)."""
        out = np.zeros(self.num_groups, dtype=np.int64)
        np.add.at(out, self.group_of, freq)
        return out


def _check_heap_key_capacity(graph: CoOccurrenceGraph, shift: int) -> None:
    """Loud overflow guard on the packed grouping heap keys.

    A candidate's packed key is ``j - weight_into[j] << shift`` where
    ``weight_into[j]`` accumulates edge weights into the current group
    — bounded by the total edge-weight mass of the graph.  If that
    bound shifted up cannot fit int64 alongside the id, a >= 2^20-row /
    heavy-history table would silently alias (weight bits bleeding into
    id bits); fail loudly instead.
    """
    total_w = int(graph.weights.sum()) if graph.weights.size else 0
    if (total_w << shift) + graph.num_rows >= 1 << 63:
        raise ValueError(
            "grouping heap keys overflow int64: "
            f"num_rows={graph.num_rows} (id shift {shift}) with total "
            f"co-occurrence mass {total_w} cannot pack into one key; "
            "shard the lookup history or scale weights down"
        )


def correlation_aware_grouping(
    graph: CoOccurrenceGraph, group_size: int, *, epoch: int = 1
) -> Grouping:
    """Algorithm 1: correlation-aware embedding grouping.

    Args:
      graph: co-occurrence graph from the lookup history.
      group_size: rows per group (= crossbar height / tile rows).
      epoch: picks extracted per bulk round.  ``1`` (default) is the
        scalar batch-heap pass, bit-identical to the retained oracle.
        ``>1`` runs the epoch-blocked pass (module docstring): up to
        ``epoch`` picks are admitted per round before their merged
        neighbourhoods are pushed, trading exact pick-by-pick weight
        accumulation for vectorized throughput under the pinned
        >= 99% intra-group co-occurrence mass bound.

    Returns:
      A :class:`Grouping` covering every row exactly once.
    """
    if group_size < 1:
        raise ValueError("group_size must be >= 1")
    if epoch < 1:
        raise ValueError("epoch must be >= 1")
    n = graph.num_rows
    _check_heap_key_capacity(graph, max(n.bit_length(), 1))
    if epoch > 1:
        groups, cold = _epoch_blocked_pass(graph, group_size, epoch)
        groups = _repack_short_groups(groups, group_size, extra_loose=cold)
        return _grouping_from_groups(groups, n, group_size, check_cover=True)
    grouped = np.zeros(n, dtype=bool)  # groupedIndices
    groups: List[List[int]] = []

    order = graph.nodes_by_frequency()  # sorted(embeddingList)

    # Candidate priorities pack into ONE int64 PER ROW ID:
    # packed[j] = j - weight_into[j] * SCALE (weight 0 → packed[j] = j).
    # Ascending key order is (weight descending, id ascending) — exactly
    # the (-weight, id) pop order of the per-edge heap — so a batch is a
    # single sort, heap comparisons touch plain ints, and a candidate's
    # currency check is ONE int compare (packed[j] == key) instead of a
    # weight decode.  The accumulate "ComputeWeight(embedding,
    # currentEmbedding) over the merged list" is a single fused
    # gather-subtract per pick: packed[nbr] -= weight*SCALE; reset
    # between seeds by restoring only the touched ids to their identity.
    SHIFT = max(n.bit_length(), 1)
    SCALE = 1 << SHIFT
    MASK = SCALE - 1
    packed = np.arange(n, dtype=np.int64)
    # weights pre-scaled once so the push path skips the per-pick mul
    wscale = graph.weights.astype(np.int64) * SCALE
    # bytearray mirror of `grouped` for O(50ns) scalar reads in the pop
    # loop (numpy bool scalars cost ~3x more); the numpy array serves the
    # vectorized bulk staleness check.
    grouped_b = bytearray(n)
    indptr = graph.indptr.tolist()
    indices = graph.indices
    heappush, heappop, heapreplace = (
        heapq.heappush, heapq.heappop, heapq.heapreplace
    )

    for seed in order.tolist():
        if grouped_b[seed]:  # line 3-5: skip already grouped
            continue
        current: List[int] = [seed]
        grouped_b[seed] = 1
        grouped[seed] = True

        # candidateList as a lazy max-heap of sorted neighbor BATCHES.
        # Each entry is (key, seq, cursor, keys): the head of a sorted
        # packed-key batch plus the array to advance through on pop.
        # `seq` is a unique tiebreaker so heapq never compares the array
        # payloads; entries with equal keys are the same candidate at the
        # same weight, so their relative order cannot change the pick
        # sequence.  Pop order over distinct (weight, id) is the same
        # total order the per-edge heap yields — bit-identical groups.
        heap: List[tuple] = []
        touched: List[np.ndarray] = []
        seq = 0

        row = seed
        while len(current) < group_size:
            # ---- push_neighbors(row): one batch heap entry per pick.
            # (The reference loop also pushes after its final pick; that
            # batch is never popped, so skipping it here cannot change
            # the pick sequence — weights are per-seed scoped.) ----
            lo, hi = indptr[row], indptr[row + 1]
            if hi > lo:
                nbr_ids = indices[lo:hi]
                live = ~grouped[nbr_ids]
                ids = nbr_ids[live]
                if ids.size:
                    # CSR neighbor ids are unique within a row, so the
                    # fused gather-subtract is exact; pre-scaled weights
                    # and the packed accumulator make the re-push ONE
                    # arithmetic op on top of the liveness mask
                    pk = packed[ids] - wscale[lo:hi][live]
                    packed[ids] = pk
                    touched.append(ids)
                    if pk.size > 1:
                        pk.sort()          # fresh array → sort in place
                    heappush(heap, (int(pk[0]), seq, 0, pk))
                    seq += 1

            # ---- pop the max-weight candidate (lazy deletion of stale
            # entries): the heap head is the globally best *pushed*
            # (weight, id); skip it unless it still matches the
            # candidate's current weight.  The whole prefix of the top
            # batch that outranks the second-best head can be validated
            # in BULK: weights only grow and grouped only flips on
            # within a seed, so a stale entry is stale forever — skipped
            # entries never need revisiting, and equal keys across
            # batches are the same (weight, id), so consuming ties out
            # of the head first cannot change the pick sequence. ----
            best = None
            stale_s, stale_run = -1, 0
            while heap:
                key, s, k, keys = heap[0]
                # decode key = j - w*SCALE: SCALE is a power of two, so
                # j = key mod SCALE falls out of a mask; currency is one
                # int compare against the packed accumulator
                j = key & MASK
                if not grouped_b[j] and packed[j] == key:
                    # valid head: the common case stays a scalar pop
                    k += 1
                    if k < keys.size:
                        heapreplace(heap, (int(keys[k]), s, k, keys))
                    else:
                        heappop(heap)
                    best = j
                    break
                # stale head.  Staleness is permanent within a seed
                # (weights only grow, grouped only flips on), so a long
                # stale RUN inside one batch can be skipped in bulk:
                # after 8 consecutive stale pops of the same batch,
                # validate vectorized the whole prefix that outranks
                # the true second-best head (the smaller of the root's
                # children).  Equal keys across batches are the same
                # (weight, id), so consuming ties out of the head first
                # cannot change the pick sequence; the streak gate
                # keeps the scalar pop the only cost everywhere else.
                stale_run = stale_run + 1 if s == stale_s else 1
                stale_s = s
                k += 1
                nk = k
                if stale_run >= 8 and keys.size - k > 16:
                    if len(heap) > 2:
                        limit = (heap[1][0] if heap[1][0] < heap[2][0]
                                 else heap[2][0])
                    elif len(heap) > 1:
                        limit = heap[1][0]
                    else:
                        limit = None
                    hi_k = (
                        int(np.searchsorted(keys, limit, side="right"))
                        if limit is not None else keys.size
                    )
                    if hi_k > k:
                        seg = keys[k:hi_k]
                        j_arr = seg & MASK
                        ok = np.nonzero(
                            ~grouped[j_arr] & (packed[j_arr] == seg)
                        )[0]
                        if ok.size:
                            d = int(ok[0])
                            best = int(j_arr[d])
                            nk = k + d + 1
                        else:
                            nk = hi_k
                if nk < keys.size:
                    heapreplace(heap, (int(keys[nk]), s, nk, keys))
                else:
                    heappop(heap)
                if best is not None:
                    break
            if best is None:
                break  # no correlated candidates left: group stays short
            current.append(best)
            grouped_b[best] = 1
            grouped[best] = True
            row = best  # line 17: merge neighbours of the pick

        groups.append(current)
        if touched:
            # weights are per-seed scoped: restore identity packing
            cat = np.concatenate(touched)
            packed[cat] = cat

    # Compact short groups: Algorithm 1 leaves the trailing group short;
    # greedy filling can also produce mid-stream short groups when a
    # connected component is exhausted. Pack those rows together so that
    # only the final group may be short (keeps the crossbar image dense).
    groups = _repack_short_groups(groups, group_size)
    return _grouping_from_groups(groups, n, group_size, check_cover=True)


def _slice_positions(starts: np.ndarray, ends: np.ndarray) -> Optional[np.ndarray]:
    """Concatenated index positions covering ``[starts[i], ends[i])``.

    The vectorized multi-slice gather: one cumsum builds the positions
    of every CSR slice of a round's picks without a Python-level loop
    over picks.  Returns ``None`` when every slice is empty.
    """
    lens = ends - starts
    nz = lens > 0
    if not nz.any():
        return None
    s, e, l = starts[nz], ends[nz], lens[nz]
    offs = np.cumsum(l)
    delta = np.ones(int(offs[-1]), dtype=np.int64)
    delta[0] = s[0]
    if l.size > 1:
        delta[offs[:-1]] = s[1:] - e[:-1] + 1
    return np.cumsum(delta)


def _epoch_blocked_pass(
    graph: CoOccurrenceGraph, group_size: int, epoch: int
) -> tuple[List[List[int]], np.ndarray]:
    """Epoch-blocked grouping rounds (module docstring; DESIGN.md §11).

    Per round: extract up to the round budget of valid picks from the
    heap, then scatter-subtract the merged CSR neighbourhoods of ALL of
    the round's picks into the packed accumulator in one pass
    (``np.subtract.at`` handles duplicate neighbour ids across picks)
    and push them as one pre-sorted batch.  The round budget ramps
    geometrically (1, 2, 4, ... ``epoch``): the first picks define the
    group's core, where pick-by-pick weight accumulation matters most;
    tail fill tolerates blocking.  Extraction is hybrid: a valid head
    whose following ``budget`` keys all outrank the true second-best
    batch head (the smaller of the root's children — the epoch
    boundary) is consumed as one vectorized prefix validation; thin
    prefixes fall back to the scalar pop, and stale runs reuse the
    scalar pass's streak-gated bulk sweep.  Stale entries are stale
    forever within a seed (weights only grow, grouped only flips on),
    so skipped prefixes never need revisiting — the same lazy-deletion
    invariant as the scalar pass.  With ``epoch=1`` every round takes
    exactly one pick before its push and the pass is bit-identical to
    the oracle (pinned in tests).

    Memory: no ``indptr.tolist()`` / ``order.tolist()`` materialisation
    — the seed walk filters frequency-order chunks against ``grouped``
    so a 10M-row table never builds a 10M-element Python list.
    """
    n = graph.num_rows
    SHIFT = max(n.bit_length(), 1)
    SCALE = 1 << SHIFT
    MASK = np.int64(SCALE - 1)
    MASKI = SCALE - 1
    packed = np.arange(n, dtype=np.int64)
    wscale = graph.weights.astype(np.int64) * SCALE
    grouped = np.zeros(n, dtype=bool)
    grouped_b = bytearray(n)
    indptr = graph.indptr.astype(np.int64, copy=False)
    indices = graph.indices
    order = graph.nodes_by_frequency()
    heappush, heappop, heapreplace = (
        heapq.heappush, heapq.heappop, heapq.heapreplace
    )
    deg = np.diff(indptr)
    groups: List[List[int]] = []
    cold: List[np.ndarray] = []
    progress = StageProgress("grouping", n)
    done = 0
    SEED_CHUNK = 1 << 16

    for base in range(0, n, SEED_CHUNK):
        chunk = order[base : base + SEED_CHUNK]
        chunk = chunk[~grouped[chunk]]
        # ---- bulk cold tail: rows with NO co-occurrence edges can
        # never be candidates nor gain weight — the scalar walk would
        # make each a singleton group.  Collect them vectorized (in
        # frequency order) and let the repack chunk them, instead of
        # paying per-seed Python overhead for the (at scale, dominant)
        # edgeless majority.
        zmask = deg[chunk] == 0
        if zmask.any():
            zrows = chunk[zmask]
            grouped[zrows] = True
            cold.append(zrows)
            done += int(zrows.size)
            chunk = chunk[~zmask]
        for seed in chunk.tolist():
            if grouped_b[seed]:
                continue
            current: List[int] = [seed]
            grouped_b[seed] = 1
            grouped[seed] = True
            heap: List[tuple] = []
            touched: List[np.ndarray] = []
            seq = 0
            ramp = 1
            pend1 = seed                       # scalar pending pick
            pend_arrs: List[np.ndarray] = []   # multi-pick rounds

            while len(current) < group_size:
                # ---- merged push of the last round's picks.  The
                # single-pick round keeps the scalar pass's direct CSR
                # slice; multi-pick rounds gather every pick's slice in
                # one cumsum (multi-slice gather) and scatter-subtract
                # once.  Duplicate ids across picks ride along as extra
                # batch entries at the same (post-accumulate) key — the
                # first pop groups the id, the rest fail the check.
                if pend1 >= 0:
                    lo, hi = int(indptr[pend1]), int(indptr[pend1 + 1])
                    pend1 = -1
                    if hi > lo:
                        nbr = indices[lo:hi]
                        live = ~grouped[nbr]
                        ids = nbr[live]
                        if ids.size:
                            pk = packed[ids] - wscale[lo:hi][live]
                            packed[ids] = pk
                            touched.append(ids)
                            if pk.size > 1:
                                pk.sort()
                            heappush(heap, (int(pk[0]), seq, 0, pk))
                            seq += 1
                elif pend_arrs:
                    parr = (pend_arrs[0] if len(pend_arrs) == 1
                            else np.concatenate(pend_arrs))
                    pend_arrs = []
                    pos = _slice_positions(indptr[parr], indptr[parr + 1])
                    if pos is not None:
                        ids = indices[pos]
                        live = ~grouped[ids]
                        ids = ids[live]
                        if ids.size:
                            np.subtract.at(packed, ids, wscale[pos[live]])
                            touched.append(ids)
                            pk = packed[ids]
                            if pk.size > 1:
                                pk.sort()
                            heappush(heap, (int(pk[0]), seq, 0, pk))
                            seq += 1

                # round budget: geometric ramp capped by `epoch` and by
                # the space left in the group
                budget = min(ramp, epoch, group_size - len(current))
                ramp += ramp
                picks_s: List[int] = []
                stale_s, stale_run = -1, 0
                while budget > 0 and heap:
                    key, s, k, keys = heap[0]
                    j = key & MASKI
                    if not grouped_b[j] and packed[j] == key:
                        # valid head.  Rich-prefix probe: if the next
                        # `budget` keys of this batch all outrank the
                        # second-best head, one vectorized validation
                        # admits the whole run.
                        if budget > 1 and keys.size - k > 1:
                            if len(heap) > 2:
                                limit = (heap[1][0] if heap[1][0] < heap[2][0]
                                         else heap[2][0])
                            elif len(heap) > 1:
                                limit = heap[1][0]
                            else:
                                limit = None
                            probe = min(k + budget, keys.size) - 1
                            if limit is None or keys[probe] <= limit:
                                hi_k = (
                                    int(np.searchsorted(keys, limit, side="right"))
                                    if limit is not None else keys.size
                                )
                                seg = keys[k:hi_k]
                                j_arr = seg & MASK
                                ok = np.nonzero(
                                    ~grouped[j_arr] & (packed[j_arr] == seg)
                                )[0]
                                if ok.size > 1:
                                    # duplicate ids carry EQUAL keys,
                                    # adjacent in the sorted prefix — one
                                    # validation must not admit a row twice
                                    vk = seg[ok]
                                    ok = ok[np.concatenate(
                                        ([True], vk[1:] != vk[:-1])
                                    )]
                                take = ok[:budget]
                                picks = j_arr[take]
                                grouped[picks] = True
                                pl = picks.tolist()
                                for p in pl:
                                    grouped_b[p] = 1
                                current.extend(pl)
                                pend_arrs.append(picks)
                                budget -= int(take.size)
                                nk = k + int(take[-1]) + 1
                                if nk < keys.size:
                                    heapreplace(heap, (int(keys[nk]), s, nk, keys))
                                else:
                                    heappop(heap)
                                continue
                        # thin prefix: scalar take of the head
                        k += 1
                        if k < keys.size:
                            heapreplace(heap, (int(keys[k]), s, k, keys))
                        else:
                            heappop(heap)
                        grouped_b[j] = 1
                        grouped[j] = True
                        current.append(j)
                        picks_s.append(j)
                        budget -= 1
                        continue
                    # stale head: scalar advance + the scalar pass's
                    # streak-gated bulk sweep (staleness is permanent)
                    stale_run = stale_run + 1 if s == stale_s else 1
                    stale_s = s
                    k += 1
                    nk = k
                    if stale_run >= 8 and keys.size - k > 16:
                        if len(heap) > 2:
                            limit = (heap[1][0] if heap[1][0] < heap[2][0]
                                     else heap[2][0])
                        elif len(heap) > 1:
                            limit = heap[1][0]
                        else:
                            limit = None
                        hi_k = (
                            int(np.searchsorted(keys, limit, side="right"))
                            if limit is not None else keys.size
                        )
                        if hi_k > k:
                            seg = keys[k:hi_k]
                            j_arr = seg & MASK
                            ok = np.nonzero(
                                ~grouped[j_arr] & (packed[j_arr] == seg)
                            )[0]
                            # position at the first still-valid entry
                            nk = k + int(ok[0]) if ok.size else hi_k
                    if nk < keys.size:
                        heapreplace(heap, (int(keys[nk]), s, nk, keys))
                    else:
                        heappop(heap)

                if picks_s:
                    if not pend_arrs and len(picks_s) == 1:
                        pend1 = picks_s[0]
                    else:
                        pend_arrs.append(np.asarray(picks_s, dtype=np.int64))
                elif not pend_arrs:
                    break  # candidates exhausted: group stays short

            groups.append(current)
            done += len(current)
            if touched:
                cat = np.concatenate(touched)
                packed[cat] = cat
        progress.tick(done)
    progress.finish(done)
    cold_arr = np.concatenate(cold) if cold else _EMPTY_I64
    return groups, cold_arr



_EMPTY_I64 = np.empty(0, dtype=np.int64)


def grouping_quality(graph: CoOccurrenceGraph, grouping: Grouping) -> int:
    """Total intra-group co-occurrence mass of a grouping.

    Sum of edge weights whose endpoints share a group — the objective
    Algorithm 1 greedily maximises.  The epoch-blocked pass ships with
    ``grouping_quality(epoch_pass) >= 0.99 * grouping_quality(oracle)``
    pinned in tests and recorded in BENCH_pipeline.json.
    """
    if graph.indices.size == 0:
        return 0
    rows = np.repeat(
        np.arange(graph.num_rows, dtype=np.int64), np.diff(graph.indptr)
    )
    same = grouping.group_of[rows] == grouping.group_of[graph.indices]
    return int(graph.weights[same].sum())


def _reference_correlation_aware_grouping(
    graph: CoOccurrenceGraph, group_size: int
) -> Grouping:
    """Original dict-backed per-edge-push loop (equivalence oracle)."""
    if group_size < 1:
        raise ValueError("group_size must be >= 1")
    n = graph.num_rows
    grouped = np.zeros(n, dtype=bool)
    groups: List[List[int]] = []
    order = graph.nodes_by_frequency()

    for seed in order:
        seed = int(seed)
        if grouped[seed]:
            continue
        current: List[int] = [seed]
        grouped[seed] = True
        weight_into: Dict[int, int] = {}
        heap: List[tuple] = []

        def push_neighbors(row: int) -> None:
            nbr_ids, nbr_w = graph.neighbor_arrays(row)
            if nbr_ids.size == 0:
                return
            live = ~grouped[nbr_ids]
            for j, w in zip(nbr_ids[live].tolist(), nbr_w[live].tolist()):
                new_w = weight_into.get(j, 0) + w
                weight_into[j] = new_w
                heapq.heappush(heap, (-new_w, j))

        push_neighbors(seed)

        while len(current) < group_size:
            best = None
            while heap:
                negw, j = heapq.heappop(heap)
                if grouped[j] or weight_into.get(j, 0) != -negw:
                    continue
                best = j
                break
            if best is None:
                break
            current.append(best)
            grouped[best] = True
            weight_into.pop(best, None)
            push_neighbors(best)

        groups.append(current)

    groups = _repack_short_groups(groups, group_size)
    group_of = np.full(n, -1, dtype=np.int32)
    slot_of = np.full(n, -1, dtype=np.int32)
    for g, rows in enumerate(groups):
        for s, r in enumerate(rows):
            group_of[r] = g
            slot_of[r] = s
    assert (group_of >= 0).all(), "every row must be grouped"
    return Grouping(groups=groups, group_of=group_of, slot_of=slot_of, group_size=group_size)


def frequency_grouping(graph: CoOccurrenceGraph, group_size: int) -> Grouping:
    """Baseline [33]: group rows purely by descending access frequency.

    Fully vectorized (the 10M-row replan bench builds its layout here):
    row ``order[i]`` lands in group ``i // group_size`` slot
    ``i % group_size`` — two scatters instead of a per-row loop.
    """
    order = graph.nodes_by_frequency()
    n = graph.num_rows
    rank = np.arange(n, dtype=np.int64)
    group_of = np.empty(n, dtype=np.int32)
    slot_of = np.empty(n, dtype=np.int32)
    group_of[order] = (rank // group_size).astype(np.int32)
    slot_of[order] = (rank % group_size).astype(np.int32)
    olist = order.tolist()
    groups = [olist[i : i + group_size] for i in range(0, n, group_size)]
    return Grouping(groups=groups, group_of=group_of, slot_of=slot_of, group_size=group_size)


def naive_grouping(num_rows: int, group_size: int) -> Grouping:
    """Baseline "naïve": map rows to crossbars by original itemID order."""
    groups = [
        list(range(i, min(i + group_size, num_rows)))
        for i in range(0, num_rows, group_size)
    ]
    ids = np.arange(num_rows, dtype=np.int64)
    group_of = (ids // group_size).astype(np.int32)
    slot_of = (ids % group_size).astype(np.int32)
    return Grouping(groups=groups, group_of=group_of, slot_of=slot_of, group_size=group_size)


def _grouping_from_groups(
    groups: List[List[int]],
    num_rows: int,
    group_size: int,
    check_cover: bool = False,
) -> Grouping:
    """Builds the ``group_of`` / ``slot_of`` scatters from a group list.

    Vectorized: one concatenate over the group lists + two scatters —
    the per-row Python loop was itself seconds at 10M rows.
    """
    lens = np.fromiter((len(g) for g in groups), dtype=np.int64, count=len(groups))
    total = int(lens.sum())
    group_of = np.full(num_rows, -1, dtype=np.int32)
    slot_of = np.full(num_rows, -1, dtype=np.int32)
    if total:
        rows = np.concatenate([np.asarray(g, dtype=np.int64) for g in groups])
        gid = np.repeat(np.arange(len(groups), dtype=np.int64), lens)
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        slot = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
        group_of[rows] = gid.astype(np.int32)
        slot_of[rows] = slot.astype(np.int32)
    if check_cover:
        assert (group_of >= 0).all(), "every row must be grouped"
    return Grouping(groups=groups, group_of=group_of, slot_of=slot_of, group_size=group_size)


def _repack_short_groups(
    groups: List[List[int]],
    group_size: int,
    extra_loose: Optional[np.ndarray] = None,
) -> List[List[int]]:
    """Merges short groups into full ones without splitting full groups.

    ``extra_loose`` appends additional ungrouped rows (the epoch pass's
    bulk-collected zero-degree cold tail, in frequency order) to the
    loose pool before chunking — equivalent to those rows having formed
    singleton groups at the end of the walk.
    """
    full = [g for g in groups if len(g) == group_size]
    loose: List[int] = [r for g in groups if len(g) < group_size for r in g]
    if extra_loose is not None and extra_loose.size:
        loose.extend(extra_loose.tolist())
    for i in range(0, len(loose), group_size):
        full.append(loose[i : i + group_size])
    return full


def activations_per_query(
    grouping: Grouping, queries: Sequence[Sequence[int]]
) -> np.ndarray:
    """Distinct groups (crossbars) activated by each query (paper Fig. 9 metric).

    Vectorized: one unique over packed (query, group) keys for the whole
    batch instead of a Python set per query.
    """
    from repro_torch.core.cooccurrence import flatten_ragged

    flat, lens, nq = flatten_ragged(queries)
    if flat.size == 0:
        return np.zeros(nq, dtype=np.int64)
    qid = np.repeat(np.arange(nq, dtype=np.int64), lens)
    ngroups = np.int64(grouping.num_groups)
    touched = np.unique(qid * ngroups + grouping.group_of[flat].astype(np.int64))
    return np.bincount(touched // ngroups, minlength=nq).astype(np.int64)
