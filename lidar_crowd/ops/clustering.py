"""DBSCAN-equivalent clustering on the dense 2.5D column grid.

The reference clusters people with sklearn DBSCAN
(utils/data_processing.py:197, app_simplified.py:107). DBSCAN's
seed-expansion is inherently sequential; the device equivalent computes
the *same* clusters as parallel connected components over the column grid
(ops/columns.py):

  1. core points: |N_eps(p)| >= min_samples (self included — sklearn
     semantics), via the dense 3x3-column pairwise count;
  2. clusters = connected components of the core-core eps-adjacency,
     found by iterated min-label propagation: each sweep takes, for every
     table slot, the min label over eps-neighbors in the 9 adjacent
     columns — a static shift + pairwise mask + min-reduce, all dense
     elementwise work — followed by pointer-jumping (path halving)
     through the point-index label space;
  3. border points adopt the min cluster label among their core neighbors;
     everything else is noise (-1).

The cluster *census* (number of clusters, member sets of core points) is
mathematically identical to DBSCAN's; only border points adjacent to two
clusters may differ (sklearn's choice there is scan-order dependent, i.e.
unspecified). Validated bit-exact against sklearn on the seed-42 fixture
(446 clusters / 2544 noise points).

Labels compact to dense ids 0..n_clusters-1 ordered by each cluster's
minimum point index. Min-label propagation over eps-balls is symmetric by
construction (the pairwise mask is), so no scatter is ever needed.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from lidar_crowd.ops import columns
from lidar_crowd.ops.columns import (
    build_column_grid)

INT_MAX = jnp.iinfo(jnp.int32).max


def _bf_row_chunks(points, mask, chunk):
    n, d = points.shape
    pad = (-n) % chunk
    pp = jnp.pad(points, ((0, pad), (0, 0)))
    mm = jnp.pad(mask, (0, pad))
    return pp.reshape((n + pad) // chunk, chunk, d), \
        mm.reshape((n + pad) // chunk, chunk), n


def dbscan_bruteforce(points: jnp.ndarray, mask: jnp.ndarray, eps: float,
                      min_samples: int, max_iters: int = 40,
                      chunk: int = 2048
                      ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Exact DBSCAN-equivalent via tiled all-pairs distances.

    For padded sets up to ~32K points the full (N, N) masked distance
    reduction — row-chunked so nothing N^2 materialises in device memory —
    needs no spatial structure: it is fused multiply/compare/reduce with
    zero gathers. Works in any dimension and any
    coordinate scaling (the modular variant clusters StandardScaler-warped
    space where spatial bucketing degenerates; this path handles it).
    """
    n = points.shape[0]
    assert n % 32 == 0, "brute-force DBSCAN needs capacity % 32 == 0"
    w = n // 32
    r2 = jnp.asarray(eps, points.dtype) ** 2
    qs, qm, _ = _bf_row_chunks(points, mask, chunk)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))

    # One geometric pass: packed eps-adjacency rows (n, n/32) uint32.
    # Counts are popcounts; every sweep afterwards is coordinate-free
    # bit-select + integer-min.
    def adj_chunk(args):
        q, qmk = args
        d2 = jnp.sum((q[:, None, :] - points[None, :, :]) ** 2, axis=-1)
        hit = (d2 <= r2) & mask[None, :] & qmk[:, None]
        return jnp.sum(
            jnp.where(hit.reshape(q.shape[0], w, 32), weights, 0),
            axis=-1, dtype=jnp.uint32)

    adj = jax.lax.map(adj_chunk, (qs, qm)).reshape(-1, w)[:n]
    counts = jnp.sum(jax.lax.population_count(adj).astype(jnp.int32),
                     axis=1)
    core = mask & (counts >= min_samples)
    core_words = jnp.sum(
        jnp.where(core.reshape(w, 32), weights, 0), axis=-1,
        dtype=jnp.uint32)
    adj_core = adj & core_words[None, :]

    idx = jnp.arange(n, dtype=jnp.int32)
    labels0 = jnp.where(core, idx, INT_MAX)

    def min_sweep(labels, q_select):
        # the bit loop is statically unrolled: 32 scalar-shift steps
        # instead of a (c, w, 32) broadcast shift inside the while_loop
        lab_tiles = labels.reshape(w, 32)

        def chunk_fn(a):
            acc = jnp.full((a.shape[0],), INT_MAX, jnp.int32)
            for k in range(32):
                m = (a >> jnp.uint32(k)) & jnp.uint32(1)
                cand = jnp.where(m == 1, lab_tiles[None, :, k], INT_MAX)
                acc = jnp.minimum(acc, jnp.min(cand, axis=1))
            return acc

        pad = (-n) % chunk
        ap = jnp.pad(adj_core, ((0, pad), (0, 0)))
        out = jax.lax.map(
            chunk_fn, ap.reshape((n + pad) // chunk, chunk, w)
        ).reshape(-1)[:n]
        return jnp.where(q_select, out, INT_MAX)

    def sweep(state):
        labels, _, it = state
        nbr_min = min_sweep(labels, core)
        new = jnp.where(core, jnp.minimum(labels, nbr_min), labels)
        for _ in range(2):  # pointer jumping
            safe = jnp.clip(new, 0, n - 1)
            new = jnp.where(core, jnp.minimum(new, new[safe]), new)
        return new, jnp.any(new != labels), it + 1

    labels, _, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < max_iters), sweep,
        (labels0, jnp.asarray(True), jnp.asarray(0)))

    border_min = min_sweep(labels, mask & ~core)
    labels = jnp.where(mask & ~core & (border_min != INT_MAX),
                       border_min, labels)
    labels = jnp.where(labels == INT_MAX, -1, labels)

    is_rep = (labels == idx) & core
    dense_minus1 = jnp.cumsum(is_rep.astype(jnp.int32)) - 1
    safe = jnp.clip(labels, 0, n - 1)
    dense = jnp.where(labels >= 0, dense_minus1[safe], -1)
    return (dense.astype(jnp.int32), jnp.sum(is_rep.astype(jnp.int32)),
            jnp.asarray(0, jnp.int32))


# Below this padded capacity the tiled all-pairs path wins; above it the
# column grid's O(n * cap^2) dominates O(n^2).
BRUTEFORCE_MAX_POINTS = 32768

# Hard capacity of the brute-force backend when it is the ONLY exact
# option (macroscopic eps, see dbscan_labels): the packed adjacency is
# cap^2/8 bytes — 2.1 GB of device memory at 131072. This also tracks
# the reference's own feasibility wall: sklearn DBSCAN at eps=0.5 in
# standardized space materialises ~cap^2 * pi eps^2 / venue-area
# neighbor int64s (~10 GB at 131k, MemoryError well before 1M), so
# capability parity holds.
BRUTEFORCE_HARD_CAP = 131072


def dbscan_labels(points: jnp.ndarray, mask: jnp.ndarray, eps: float,
                  min_samples: int, ncx: int = 128, ncy: int = 128,
                  column_cap: int = 64, max_iters: int = 40,
                  brute_cap: int = 0
                  ) -> Tuple[jnp.ndarray, jnp.ndarray,
                             jnp.ndarray]:
    """Cluster padded ``points`` (N, D). Returns (labels (N,) int32 with
    -1 noise / dense cluster ids, n_clusters (), overflow () int32 —
    points dropped because a column exceeded ``column_cap``; 0 means the
    result is exact). Dispatches on static capacity alone: tiled
    all-pairs up to ``BRUTEFORCE_MAX_POINTS`` (or ``brute_cap``), the
    column grid (``dbscan_columns``) above.

    ``brute_cap`` raises the all-pairs dispatch ceiling. The modular
    variant clusters StandardScaler-warped space where eps = 0.5 sigma is
    MACROSCOPIC — the venue spans ~7 eps per axis, so every eps-sized
    column holds O(n/49) points and the dense column tables degenerate
    (a measured cap means a (cap, NCX, NCY) table in the hundreds of GB).
    The packed-bitmask brute force is exact in any scaling and is the
    only exact backend there; callers in that regime pass
    ``brute_cap=BRUTEFORCE_HARD_CAP``."""
    if points.shape[0] <= max(brute_cap, BRUTEFORCE_MAX_POINTS):
        return dbscan_bruteforce(points, mask, eps, min_samples,
                                 max_iters=max_iters)
    return dbscan_columns(points, mask, eps, min_samples, ncx=ncx,
                          ncy=ncy, column_cap=column_cap,
                          max_iters=max_iters)


def table_to_point_order(grid, interior_tbl: jnp.ndarray,
                         fill) -> jnp.ndarray:
    """Gather an interior (NCX, NCY, CAP) table back into point order
    (N,), ``fill`` for points outside the grid (invalid / overflow)."""
    flat = jnp.concatenate(
        [columns.pad_interior(interior_tbl, fill).reshape(-1),
         jnp.asarray([fill], interior_tbl.dtype)])
    return flat[jnp.clip(grid.point_pos, 0, grid.table_ptidx.size)]


def ccl_core_labels(grid, core_int: jnp.ndarray, eps: float,
                    max_iters: int = 40, stripe: int = 8,
                    shortcut_rounds: int = 0
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Connected components over the core-core eps-adjacency of a column
    grid: iterated min-label propagation + pointer jumping (the per-sweep
    kernel of dbscan_columns, factored so the spatially-sharded DBSCAN in
    parallel/cluster.py can run it as its per-shard kernel with an
    externally-supplied core mask).

    Labels hold ORIGINAL point indices (the index space of the array
    passed to ``build_column_grid``); at the fixpoint each core point
    carries the min point index of its component. Returns
    (labels_pt (N,), labels_int (NCX, NCY, CAP)) — point order and table
    layout; INT_MAX for non-core slots.
    """
    n = grid.point_pos.shape[0]
    core_pad = columns.pad_interior(core_int, False)
    ptidx_int = grid.table_ptidx[1:-1, 1:-1]
    labels0 = jnp.where(core_int, ptidx_int, INT_MAX)

    def jump(labels_int, labels_by_point):
        """labels hold point indices; chase one hop via point order."""
        safe = jnp.clip(labels_int, 0, n - 1)
        hop = labels_by_point[safe]
        ok = (labels_int != INT_MAX) & (hop != INT_MAX)
        return jnp.where(ok, jnp.minimum(labels_int, hop), labels_int)

    def sweep(state):
        labels, _, it = state
        nbr_min = columns.column_min_label(
            grid, columns.pad_interior(labels, INT_MAX), core_pad, eps,
            INT_MAX, stripe=stripe)
        new = jnp.where(core_int, jnp.minimum(labels, nbr_min), labels)
        # path-halving rounds: each one re-reads the point-order view and
        # chases one hop — a pair of n-gathers, far cheaper than a
        # neighborhood sweep, and together they collapse label chains so
        # long components converge in ~log(diameter) sweeps.
        for _ in range(1 + shortcut_rounds):
            new = jump(new, table_to_point_order(grid, new, INT_MAX))
        return new, jnp.any(new != labels), it + 1

    # initial flag derived from a varying value so the carry's manual
    # axes match inside shard_map (see shard_map docs on scan-vma)
    labels_int, _, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < jnp.asarray(max_iters, s[2].dtype)),
        sweep, (labels0, jnp.any(labels0 >= INT_MAX) | True,
                jnp.asarray(0)))
    return table_to_point_order(grid, labels_int, INT_MAX), labels_int


def dbscan_columns(points: jnp.ndarray, mask: jnp.ndarray, eps: float,
                   min_samples: int, ncx: int = 128, ncy: int = 128,
                   column_cap: int = 64, max_iters: int = 40,
                   stripe: int = 0, shortcut_rounds: int = 0
                   ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Column-grid DBSCAN (see module docstring). Interior label tables are
    (NCX, NCY, CAP); padded views are created per sweep (cheap: one pad of
    the int32 label table) so every neighborhood pass runs striped.

    Each sweep recomputes pairwise distances (column_min_label, ~8
    flops/pair) rather than bit-selecting from a precomputed packed
    adjacency. ``shortcut_rounds`` adds pointer-jumping (path-halving)
    hops per sweep, each two ~n-element gathers, which cut the sweep
    count on sprawling terrain components (graph diameter ~ venue_extent
    / eps). Pair-test work scales as ncells * 9 * cap^2: prefer fine
    cells with a small cap (fit_capacity sizes cap to occupancy).
    """
    n = points.shape[0]
    if stripe <= 0:
        # target ~8-12 sequential stripe steps: big enough to fill the
        # device, small enough that fused per-stripe temps stay in-budget
        stripe = max(8, min(64, ncx // 8))
    grid = build_column_grid(points, mask, min_cell=eps, ncx=ncx, ncy=ncy,
                             cap=column_cap)

    counts = columns.column_counts(grid, eps, stripe=stripe)
    valid_int = grid.table_valid[1:-1, 1:-1]
    core_int = valid_int & (counts >= min_samples)
    core_pad = columns.pad_interior(core_int, False)

    _, labels_int = ccl_core_labels(grid, core_int, eps,
                                    max_iters=max_iters, stripe=stripe,
                                    shortcut_rounds=shortcut_rounds)

    # Border points: min label among core eps-neighbors.
    border_min = columns.column_min_label(
        grid, columns.pad_interior(labels_int, INT_MAX), core_pad, eps,
        INT_MAX, stripe=stripe)
    border_sel = valid_int & ~core_int
    labels_int = jnp.where(border_sel & (border_min != INT_MAX),
                           border_min, labels_int)

    # Back to point order: one gather via each point's table position.
    labels_pt = table_to_point_order(grid, labels_int, INT_MAX)
    labels_pt = jnp.where(labels_pt == INT_MAX, -1, labels_pt)
    labels_pt = jnp.where(mask, labels_pt, -1)

    # Compact representative point-indices -> dense ids.
    idx = jnp.arange(n, dtype=jnp.int32)
    is_rep = (labels_pt == idx) & (labels_pt >= 0)
    dense_minus1 = jnp.cumsum(is_rep.astype(jnp.int32)) - 1
    safe = jnp.clip(labels_pt, 0, n - 1)
    dense = jnp.where(labels_pt >= 0, dense_minus1[safe], -1)
    return (dense.astype(jnp.int32), jnp.sum(is_rep.astype(jnp.int32)),
            grid.overflow)


def _df_add(a, b):
    """Double-float (compensated) addition: (sum, err) pairs with ~2^-48
    effective mantissa. Associative enough for scan use — error growth is
    O(log n) with a fixed reduction tree, vs O(n)*2^-24 for plain f32
    cumsum, which loses ~0.04 m on 16.7M-point prefixes."""
    s1, e1 = a
    s2, e2 = b
    s = s1 + s2
    v = s - s1
    err = (s1 - (s - v)) + (s2 - v)
    return s, err + e1 + e2


def _lane_prefix_df(vals: jnp.ndarray, lanes: int = 128
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inclusive compensated (double-float) prefix over axis 0 of an
    (n, d) array.

    Each of d*lanes columns owns a CONTIGUOUS row chunk: one transpose
    in, one wide associative scan over (chunk, d*lanes), a tiny
    per-lane carry scan, one transpose out. Returns (hi, lo)
    double-float pairs with the O(log n) compensated error model of
    ``_df_add``. The reduction tree is fixed by the shapes, so the bits
    do not depend on the backend."""
    n, d = vals.shape
    lanes = int(lanes)
    chunk = -(-n // lanes)
    npad = chunk * lanes
    v = jnp.pad(vals, ((0, npad - n), (0, 0)))
    v = jnp.transpose(v.reshape(lanes, chunk, d),
                      (1, 2, 0)).reshape(chunk, d * lanes)
    hi, lo = jax.lax.associative_scan(
        _df_add, (v, jnp.zeros_like(v)), axis=0)
    # per-lane totals -> exclusive carries within each channel's lanes
    th = hi[-1].reshape(d, lanes)
    tl = lo[-1].reshape(d, lanes)
    ch_, cl_ = jax.lax.associative_scan(_df_add, (th, tl), axis=1)
    z = jnp.zeros((d, 1), vals.dtype)
    ch_ = jnp.concatenate([z, ch_[:, :-1]], axis=1).reshape(d * lanes)
    cl_ = jnp.concatenate([z, cl_[:, :-1]], axis=1).reshape(d * lanes)
    oh, ol = _df_add((ch_[None, :], cl_[None, :]), (hi, lo))

    def back(a):
        return jnp.transpose(a.reshape(chunk, d, lanes),
                             (2, 0, 1)).reshape(npad, d)[:n]

    return back(oh), back(ol)


def _centroids_sorted(points: jnp.ndarray, seg: jnp.ndarray, k: int
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Segment sums via a stable sort and a compensated prefix scan.

    Exploits that the pipeline's labels are DENSE ids 0..C-1: after a
    stable sort by segment, segment j's rows are contiguous, in point
    order, and its END row holds the inclusive prefix of everything up
    to and including the segment. Each end row's prefix is written to
    slot j (one writer per slot), and per-segment sums are differences
    of ADJACENT slots. Every step has a fixed order of additions, so the
    result is the same bit for bit on every backend and every run — an
    atomic scatter-add sums in an order that changes from run to run,
    and one ulp of a centroid can flip a radius-boundary density count.

    Returns (sums (K, D), counts (K,)); slots >= C are exactly zero."""
    n, d = points.shape
    cols = [points[:, i] for i in range(d)]
    sorted_all = jax.lax.sort((seg,) + tuple(cols), num_keys=1,
                              is_stable=True)
    seg_s = sorted_all[0]
    pts_s = jnp.stack(sorted_all[1:], axis=1)           # (n, d)

    # the row-count prefix needs no scan: an inclusive prefix of ones
    # IS iota+1
    s_hi, s_lo = _lane_prefix_df(pts_s)
    cnt_prefix = jnp.arange(1, n + 1, dtype=jnp.int32)

    is_end = jnp.concatenate([seg_s[1:] != seg_s[:-1],
                              jnp.ones((1,), bool)])
    # rows that end no live segment target slot k, which mode="drop"
    # discards: every kept write has its own slot
    dest = jnp.where(is_end & (seg_s < k), seg_s, k)

    def place(v, fill):
        return jnp.full((k,) + v.shape[1:], fill, v.dtype).at[dest].set(
            v, mode="drop")

    real = place(jnp.ones((n,), bool), False)
    p_hi = place(s_hi, 0.0)
    p_lo = place(s_lo, 0.0)
    p_cnt = place(cnt_prefix, 0)

    def prev(a):
        pad = jnp.zeros_like(a[:1])
        return jnp.concatenate([pad, a[:-1]], axis=0)

    seg_sums = jnp.where(
        real[:, None],
        (p_hi - prev(p_hi)) + (p_lo - prev(p_lo)), 0.0)
    seg_cnt = jnp.where(real, p_cnt - prev(p_cnt), 0)
    return seg_sums, seg_cnt.astype(points.dtype)


def cluster_centroids(points: jnp.ndarray, labels: jnp.ndarray,
                      max_clusters: int
                      ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-cluster centroids (segment mean). Returns
    (centroids (K, D), valid (K,), overflow () int32 — the number of
    clusters whose dense id >= ``max_clusters`` and were therefore dropped
    from the segment sums; 0 means the census is exact). Mirrors
    extract_people_positions (utils/data_processing.py:251-280, which
    never drops a cluster); callers slice the dims they need and must
    surface/retry on nonzero overflow (Pipeline.analyze does).

    One path at every size: ``_centroids_sorted``, whose sums do not
    depend on the device or the run."""
    k = max_clusters
    seg = jnp.where(labels >= 0, labels, k)  # overflow/noise bucket at k
    sums, cnts = _centroids_sorted(points, seg.astype(jnp.int32), k)
    valid = cnts > 0
    # labels are dense 0..n_clusters-1, so clusters dropped by the
    # capacity clamp = max_label + 1 - k when the max spills past k.
    overflow = jnp.maximum(jnp.max(labels, initial=-1) + 1 - k, 0
                           ).astype(jnp.int32)
    return sums / jnp.maximum(cnts, 1.0)[:, None], valid, overflow
