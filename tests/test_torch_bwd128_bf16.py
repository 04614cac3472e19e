"""The width-128 bf16 GraphNet backward (#9 fold at (128, 128, 128), #3
pre-gathered and #7 pe at (128, 128)) as its cluster pipeline computes it,
on the CPU.

``csrc/fused_edge_tail_agg_bf16_w128.cu`` (``bwd``) runs a call as one
launch of thread-block clusters, one CTA a weight (fold: W_e, W_1 .. W_L1,
W_out; pe and pre-gathered: W_1 .. W_L1, W_out), each cluster over a range
of consecutive 64-edge tiles, then one launch that adds the clusters'
partial rows in cluster order.  In step s CTA p runs the forward of tile s
- p and the backward of tile s - (2 n - 2 - p); the activations and
gradients pass between the CTAs' shared memories, and each CTA keeps its
weight gradient in registers.  No card is needed for three things it rests
on:

(a) The schedule, emulated step by step from the kernel's index arithmetic
    (its rings, the two gradient tiles, the tile indices): every tile is
    visited once by each CTA forward and once backward, forward before
    backward and after the CTA before it; every read finds the tile it
    wants, landed in a step before, never in a buffer that the same step
    writes (by cp.async or from another CTA); no ring needs more slots than
    the layout reserves (``kRing`` tiles, 231,936 bytes in all, one CTA an
    SM).  The clusters' tile ranges cover the graph once, one tile at
    least each.  The d_pxi sums of the first CTA (per column one atomic add
    per run of equal receivers in each half of a tile, the receivers found
    from the tile before's last one) equal the receiver sums exactly on
    integer rows at MAgNet[GNN]'s training graphs (1D, 67,572 edges; a 2D
    batch of the published 512-node configuration, 55,916 here) and on a
    hub over four tiles, degree-0 receivers at tile boundaries, E = 1, E a
    multiple of the tile and one past it, and fewer tiles than clusters.

(b) The weight gradients' accumulation.  A CTA adds every tile's dW
    products into one set of f32 accumulators over its whole range (3,072
    edges at the 1D training graph on an H100's 22 clusters of the fold
    entry, 2,304 on the 30 of the others, 3,840 at the eval graph, 67,572
    on a single cluster).  The tensor cores truncate what they add to a
    large accumulator (``truncating_mma`` of
    ``tests/test_torch_fold_tiles.py``, here 16 bf16 products a step, each
    exact in f32): at those ranges dW stays within 1e-3 relative L2 of
    float64 (a tenth of ``chip_smoke.py``'s ``BF16_BWD_L2``: 2e-6 to 5e-6
    at the paths' ranges, 2.5e-4 on one cluster)
    and no element leaves the elementwise bound that it counts
    (``BF16_RTOL`` |want| + ``BF16_BWD_ATOL_REL`` max|want|), so no fresh
    per-tile accumulators are needed (the f32 width-64 backward needed
    them: its bound is 1e-4).

(c) The chain, in the kernel's order and at its rounding points (tile by
    tile, each cluster's dW and bias sums in its own rows added in cluster
    order, d_pxi by runs), against the VJPs of ``fused_edge_tail_agg2rf``
    (fold) and ``fused_edge_tail_agg`` (pre-gathered) at width 128 in
    Pallas interpret mode on a 120-node graph with a degree-0 receiver, at
    the tolerances of ``tests/test_torch_bf16_gnn.py`` and
    ``tests/test_torch_pregathered128.py`` (relative L2 1e-2 per gradient).

The emulations are this test's, not code of the package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from magnet_tpu.ops import pallas_kernels as pk  # noqa: E402
from magnet_tpu.ops.graph import block_graph  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from test_torch_fold_tiles import truncating_mma, warp_receiver  # noqa: E402
from test_torch_fused_edge import _jax_side, _port_args, _problem  # noqa: E402
from test_torch_fwd_tiles import KINDS, degrees  # noqa: E402
from test_torch_gnn2d import load_native_neighbours  # noqa: E402
from test_torch_pregathered128 import _bf16_case, _pallas_fwd_bwd  # noqa: E402

TE = 64                       # edges a tile (kTE)
W = 128                       # the width of the builds under test
MAX_L1 = 3                    # kMaxL1
RING = 2 * (MAX_L1 + 1)       # bwd::kRing, tiles of a CTA's ring
IDX_RING = 2 * (MAX_L1 + 2) + 1  # bwd::kIdxRing
LD = W + 8                    # kLd, the padded bf16 row
SMEM_OPTIN = 232_448          # an H100 block's shared memory, opt-in
GRAD_L2 = 1e-2                # tests/test_torch_bf16_gnn.py's
ENTRIES = ("fold", "pe", "pregathered")
#: the clusters an H100 holds at once (cudaOccupancyMaxActiveClusters,
#: chip_smoke.py's gnn_bf16_kernel_bwd): 5-CTA (fold at L1 = 3), 4-CTA
#: (pe, pre-gathered)
H100_CLUSTERS = (22, 30)


@pytest.fixture(scope="module", autouse=True)
def native_neighbours():
    """The JAX side's MAgNet[GNN] 2D graphs take their k-NN tables from the
    native neighbour search (``test_torch_gnn2d.load_native_neighbours``)."""
    return load_native_neighbours()


def n_ctas(entry, l1):
    """CTAs a cluster: one a weight."""
    return (entry == "fold") + l1 + 1


def layout_bytes():
    """bwd::Layout::bytes: the weight, kRing tiles, two gradient tiles, a
    staging tile and the index ring."""
    tile = TE * LD * 2
    return W * LD * 2 + RING * tile + 2 * tile + tile + IDX_RING * 2 * TE * 4


def cluster_ranges(n_edges, clusters):
    """(first tile, tiles) of each cluster as ``bwd::launch`` and the kernel
    split the tiles: at most one cluster a tile, balanced ranges."""
    n_tiles = -(-n_edges // TE)
    nc = min(clusters, n_tiles)
    return [(c * n_tiles // nc, (c + 1) * n_tiles // nc - c * n_tiles // nc)
            for c in range(nc)]


def depth(n, p):
    """Slots of CTA p's ring (the first CTA's counts the tile staged for
    the next step)."""
    return 2 * n if p == 0 else 2 * (n - p)


def run_cluster(cnt, n, fold, pregathered=False):
    """The kernel's steps for one cluster of n CTAs over its cnt tiles.
    Each CTA's shared tiles are held as {(buffer, slot): tile}; a step's
    reads see the state before it, its writes (cp.async stages, stores into
    another CTA, the tile indices) land at its cluster barrier, but for the
    pre-gathered first CTA's staging tile, which it reads and then
    overwrites within a step (a block barrier between).  Asserts that every
    read finds its tile and that no step reads a buffer it writes; returns
    the events [(step, p, "fwd" or "bwd", tile)] and the largest slot each
    buffer took."""
    lag = 2 * n - 2
    buf = [dict() for _ in range(n)]
    top = {}
    indexers = {0, n - 1}
    # the prologue: the indices of tiles 0 and 1, tile 0's rows
    for t in range(min(cnt, 2)):
        for p in indexers:
            buf[p][("idx", t % IDX_RING)] = t
    if cnt:
        buf[0][("e0_fwd" if fold else "ring", 0)] = 0
        if fold:
            buf[0][("pxj", 0)] = buf[0][("pxi", 0)] = 0
        if pregathered:
            buf[0][("stage", 0)] = 0
        buf[n - 1][("g", 0)] = 0
    events = []
    for s in range(cnt + lag if cnt else 0):
        reads, writes, local = [], [], []
        for p in range(n):
            first, out = p == 0, p == n - 1
            tf, tb = s - p, s - (lag - p)
            if tf >= 0 and tf + 1 < cnt:  # the next step's rows
                if first or out:
                    reads.append((p, "idx", (tf + 1) % IDX_RING, tf + 1))
                if first:
                    writes.append((0, "e0_fwd", (tf + 1) % 2, tf + 1) if fold
                                  else (0, "ring", (tf + 1) % depth(n, 0),
                                        tf + 1))
                if first and fold:
                    writes.append((0, "pxj", (tf + 1) % 2, tf + 1))
                    writes.append((0, "pxi", (tf + 1) % 2, tf + 1))
                if first and pregathered:
                    local.append((0, "stage", 0, tf + 1))
                if out:
                    writes.append((p, "g", (tf + 1) % 2, tf + 1))
            if first and fold and 0 <= tb + 1 < cnt:
                writes.append((0, "e0_bwd", (tb + 1) % 2, tb + 1))
            if p in indexers and tf >= 0 and tf + 2 < cnt:
                reads.append((p, "idx", (tf + 1) % IDX_RING, tf + 1))  # hint
                writes.append((p, "idx", (tf + 2) % IDX_RING, tf + 2))
            if 0 <= tf < cnt:
                if first and not fold:  # h_0 from the receivers (senders)
                    reads.append((p, "idx", tf % IDX_RING, tf))
                if first and fold:
                    reads += [(0, "pxj", tf % 2, tf), (0, "pxi", tf % 2, tf)]
                if first and pregathered:
                    reads.append((0, "stage", 0, tf))
                if out:
                    reads.append((p, "g", tf % 2, tf))
                reads.append((p, "e0_fwd", tf % 2, tf) if fold and first
                             else (p, "ring", tf % depth(n, p), tf))
                events.append((s, p, "fwd", tf))
                if not out:
                    writes.append((p + 1, "ring", tf % depth(n, p + 1), tf))
            if 0 <= tb < cnt:
                if out:
                    assert tb == tf  # bf16(dy) of this step's forward
                else:
                    reads.append((p, "in", tb % 2, tb))
                reads.append((p, "e0_bwd", tb % 2, tb) if fold and first
                             else (p, "ring", tb % depth(n, p), tb))
                if first:
                    reads.append((p, "idx", tb % IDX_RING, tb))
                events.append((s, p, "bwd", tb))
                if not first:
                    writes.append((p - 1, "in", tb % 2, tb))
        written = {w[:3] for w in writes}
        for p, kind, slot, t in reads:
            assert (p, kind, slot) not in written, (s, p, kind, slot)
            assert buf[p].get((kind, slot)) == t, (s, p, kind, slot, t)
        for p, kind, slot, t in writes + local:
            buf[p][(kind, slot)] = t
            top[kind] = max(top.get(kind, 0), slot)
    return events, top


@pytest.mark.parametrize("l1", [0, 1, 3])
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("cnt", [1, 2, 7, 44, 45])
def test_schedule_visits_every_tile_in_order(entry, l1, cnt):
    n, fold = n_ctas(entry, l1), entry == "fold"
    events, top = run_cluster(cnt, n, fold, entry == "pregathered")
    at = {(p, kind, t): s for s, p, kind, t in events}
    assert len(at) == len(events) == 2 * n * cnt  # each once
    for p in range(n):
        for t in range(cnt):
            assert at[p, "fwd", t] <= at[p, "bwd", t]
            if p:
                assert at[p, "fwd", t] > at[p - 1, "fwd", t]
            if p < n - 1:
                assert at[p, "bwd", t] > at[p + 1, "bwd", t]
                assert at[p, "fwd", t] < at[p, "bwd", t]
    assert top.get("ring", 0) < RING
    for kind in ("e0_fwd", "e0_bwd", "pxj", "pxi", "g"):
        assert top.get(kind, 0) < 2, kind
    assert top.get("idx", 0) < IDX_RING


def test_layout_fits_one_cta_an_sm():
    assert layout_bytes() == 231_936 <= SMEM_OPTIN
    assert 2 * layout_bytes() > SMEM_OPTIN + 1024  # one CTA an SM
    # the output CTA's f32 y tile, its two f32 tiles of g rows and
    # LayerNorm's row statistics lie in its ring past its two slots; the
    # fold's first CTA's e0 and node rows take the ring's eight slots
    tile = TE * LD * 2
    assert 2 * tile + 3 * TE * (W + 4) * 4 + 4 * TE * 4 <= RING * tile
    assert 2 + 2 + 2 + 2 <= RING


@pytest.mark.parametrize("clusters", [1, 3, *H100_CLUSTERS, 100_000])
@pytest.mark.parametrize("n_edges", [1, TE, TE + 1, 55_518, 67_572])
def test_cluster_ranges_cover_the_tiles_once(n_edges, clusters):
    ranges = cluster_ranges(n_edges, clusters)
    n_tiles = -(-n_edges // TE)
    assert len(ranges) == min(clusters, n_tiles)
    assert all(cnt >= 1 for _, cnt in ranges)
    assert [t for t0, cnt in ranges for t in range(t0, t0 + cnt)] == list(
        range(n_tiles))
    counts = {cnt for _, cnt in ranges}
    assert max(counts) - min(counts) <= 1


def window_count(start, e):
    """IndexLoad::finish's count of the row starts at or before e among the
    first 31 of the 32 sorted ``start``: five halving steps, each lane
    reading the start its count so far points at."""
    below = 0
    for step in (16, 8, 4, 2, 1):
        if start[below + step - 1] <= e:
            below += step
    return below


@pytest.mark.parametrize("seed", range(4))
def test_five_step_search_counts_the_row_starts(seed):
    """The search equals tile128::warp_receiver's 32 comparisons wherever
    the kernel uses it (edges before the window's last start), on windows
    with runs of equal starts (receivers of degree 0) and the padding past
    the last node."""
    rng = np.random.default_rng(seed)
    start = np.sort(rng.integers(0, 200, 32))
    pad = int(rng.integers(0, 6))
    start[32 - pad:] = 2**31 - 1
    for e in range(int(start.min()) - 2, 210):
        if e < start[31]:
            assert window_count(start, e) == int((start <= e).sum())


def cluster_d_pxi(vals, rowptr, clusters):
    """d_pxi as the first CTAs sum it: each cluster's tiles in order, their
    receivers as tile128::tile_indices finds them (the cluster's first tile
    searched afresh, the next from the last receiver of the tile before),
    then per column one sum (an atomic add) per run of equal receivers in
    each half of a tile."""
    n_edges = len(vals)
    out = np.zeros((len(rowptr) - 1, vals.shape[1]))
    for t0, cnt in cluster_ranges(n_edges, clusters):
        hint = -1
        for t in range(t0, t0 + cnt):
            base = t * TE
            nv = min(TE, n_edges - base)
            rcv = np.concatenate([
                warp_receiver(rowptr, base + 32 * w, min(32, nv - 32 * w),
                              hint)[:max(0, min(32, nv - 32 * w))]
                for w in range(2)])
            hint = int(rcv[nv - 1])
            for half in range(2):
                r = rcv[32 * half:min(nv, 32 * half + 32)]
                if not len(r):
                    continue
                starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
                sums = np.add.reduceat(vals[base + 32 * half:base + 32 * half
                                            + len(r)], starts, axis=0)
                np.add.at(out, r[starts], sums)
    return out


def path_rowptrs():
    """The receiver CSR of MAgNet[GNN]'s 1D training graph (67,572 edges)
    and of a 2D batch at the published 512-node irregular configuration."""
    from magnet_tpu_torch.time_bwd import gnn2d_train_graph
    from magnet_tpu_torch.time_fwd import gnn_train_graph

    return {"gnn_1d_train": gnn_train_graph().rowptr.numpy(),
            "gnn_2d_train": gnn2d_train_graph().rowptr.numpy()}


@pytest.fixture(scope="module")
def path_graphs():
    return path_rowptrs()


def _integer_sums(rowptr, clusters, seed):
    deg = np.diff(rowptr)
    vals = np.random.default_rng(seed).integers(
        -8, 9, (int(rowptr[-1]), 16)).astype(np.float64)
    want = np.zeros((len(deg), 16))
    np.add.at(want, np.repeat(np.arange(len(deg)), deg), vals)
    got = cluster_d_pxi(vals, rowptr, clusters)
    np.testing.assert_array_equal(got, want)
    assert (got[deg == 0] == 0).all()


@pytest.mark.parametrize("clusters", H100_CLUSTERS)
@pytest.mark.parametrize("path", ["gnn_1d_train", "gnn_2d_train"])
def test_d_pxi_runs_are_exact_at_the_path_sizes(path_graphs, path, clusters):
    rowptr = path_graphs[path]
    assert path != "gnn_1d_train" or rowptr[-1] == 67_572
    _integer_sums(rowptr, clusters, seed=clusters)


@pytest.mark.parametrize("clusters", [1, 3, 1_000])
@pytest.mark.parametrize("kind", KINDS)
def test_d_pxi_runs_are_exact_at_the_edge_cases(kind, clusters):
    rng = np.random.default_rng(len(kind) + clusters)
    deg = degrees(kind, TE, rng)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    if kind == "hub":
        assert deg.max() >= 3 * TE
    if kind == "one":
        assert rowptr[-1] == 1
    _integer_sums(rowptr, clusters, seed=clusters)


# ---- (b) the weight gradients' accumulation --------------------------------

def bf16(a):
    """a rounded to bf16, kept in float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .bfloat16().float().numpy()


def running_dw(x, d, fresh_per_tile):
    """x^T . d as mma.sync m16n8k16 forms it: k-steps of 16 edges, the 16
    products added to the f32 accumulator (``truncating_mma``), one
    accumulator over every edge (the kernel), or a fresh one a tile added
    in f32."""
    if not fresh_per_tile:
        acc = np.zeros((x.shape[1], d.shape[1]), np.float32)
        for k0 in range(0, len(x), 16):
            acc = truncating_mma(acc, x[k0:k0 + 16].T, d[k0:k0 + 16])
        return acc
    run = np.zeros((x.shape[1], d.shape[1]), np.float32)
    for t in range(0, len(x), TE):
        run += running_dw(x[t:t + TE], d[t:t + TE], False)
    return run


def dw_errors(edges, fresh_per_tile, seed=0, width=32):
    """A CTA's dW over ``edges`` edges against float64: its relative L2
    and the elements outside chip_smoke's counted bound.  Operands at the
    kernel's scales: bf16 relu activations (half zero) and bf16 gradients
    of one sign per column's mean (so the sums grow with the range)."""
    rng = np.random.default_rng(seed)
    x = bf16(np.maximum(rng.standard_normal((edges, width)) * 0.5, 0))
    d = bf16((rng.standard_normal((edges, width)) + 0.5) * 0.05)
    want = x.astype(np.float64).T @ d.astype(np.float64)
    got = running_dw(x, d, fresh_per_tile).astype(np.float64)
    err = np.abs(got - want)
    bound = chip_smoke.BF16_RTOL * np.abs(want) \
        + chip_smoke.BF16_BWD_ATOL_REL * np.abs(want).max()
    return (np.linalg.norm(got - want) / np.linalg.norm(want),
            int((err > bound).sum()))


#: a CTA's edges, at most: the GNN 1D training graph (1,056 tiles) on 22
#: and 30 clusters, the eval graph (1,317) on 22, and the 1D training graph
#: in a single cluster
CTA_EDGES = {"train_22": 48 * TE, "train_30": 36 * TE, "eval_22": 60 * TE,
             "train_1": 67_572}


@pytest.mark.parametrize("case", sorted(CTA_EDGES))
def test_one_running_accumulator_lies_inside_the_bf16_tolerances(case):
    l2, outside = dw_errors(CTA_EDGES[case], fresh_per_tile=False)
    assert outside == 0
    assert l2 < chip_smoke.BF16_BWD_L2 / 10, l2


def test_the_truncation_shows_at_one_accumulator():
    """The emulation sees the truncation: the single accumulator is
    further from float64 than fresh per-tile ones."""
    running = dw_errors(CTA_EDGES["train_22"], fresh_per_tile=False)[0]
    fresh = dw_errors(CTA_EDGES["train_22"], fresh_per_tile=True)[0]
    assert running > fresh > 0, (running, fresh)


# ---- (c) the chain in the kernel's order -----------------------------------

def _rnd(t):
    return t.bfloat16().float()


def pipeline_bwd(entry, src, we, be, pxj, pxi, senders, rowptr, w_rest,
                 b_rest, w_out, b_out, ln_s, ln_b, g, clusters):
    """The cluster pipeline's gradients, tile by tile in each cluster's
    range: the forward recomputed per tile (h_k rounded to bf16), LayerNorm's
    backward to bf16(dy), then CTA by CTA from the output back: dW_p +=
    x_p^T . d in the cluster's rows, da = (d . W_p^T) masked by x_p > 0,
    its column sums the bias gradient of the layer before, d = bf16(da);
    the fold's first CTA d_e0 = bf16(d . W_e^T); d_pxi the f32 sums of
    bf16(dz) by runs, d_pxj those over the senders (fold) or the f32 sums
    of dz (pe); the clusters' rows added in cluster order.  Returns the
    wrapper's gradients in their dtypes."""
    f = torch.Tensor.float
    fold = entry == "fold"
    n, E, l1 = rowptr.numel() - 1, src.shape[0], w_rest.shape[0]
    weights = ([we] if fold else []) + list(w_rest) + [w_out]
    biases = ([be] if fold else []) + list(b_rest) + [b_out]
    n_w = len(weights)
    deg = (rowptr[1:] - rowptr[:-1]).long()
    receivers = torch.repeat_interleave(torch.arange(n), deg)
    d_src = torch.zeros(E, W)
    d_pxi = torch.zeros(n, W)
    d_pxj = torch.zeros(n, W)
    rows_w, rows_b = [], []
    for t0, cnt in cluster_ranges(E, clusters):
        dw = torch.zeros(n_w, W, W)
        db = torch.zeros(n_w + 2, W)
        for t in range(t0, t0 + cnt):
            e = torch.arange(t * TE, min(E, (t + 1) * TE))
            r = receivers[e]
            xs = []
            if fold:
                s = senders[e].long()
                xs.append(f(src[e]))
                z = (f(be) + (f(pxj)[s] + f(pxi)[r])) + f(src[e]) @ f(we)
            elif entry == "pe":
                s = senders[e].long()
                z = (f(src[e]) + f(pxj)[s]) + f(pxi)[r]
            else:
                z = f(src[e]) + f(pxi)[r]
            h = _rnd(torch.relu(z))
            for k in range(l1):
                xs.append(h)
                h = _rnd(torch.relu(f(b_rest[k]) + h @ f(w_rest[k])))
            xs.append(h)
            y = f(b_out) + h @ f(w_out)
            mu = y.mean(1, keepdim=True)
            var = (y - mu).pow(2).mean(1, keepdim=True)
            rstd = torch.rsqrt(var + fe.LN_EPS)
            xhat = (y - mu) * rstd
            gv = _rnd(g[r])
            dx = gv * ln_s
            dy = rstd * (dx - dx.mean(1, keepdim=True)
                         - xhat * (dx * xhat).mean(1, keepdim=True))
            db[n_w - 1] += dy.sum(0)
            db[n_w] += (gv * xhat).sum(0)
            db[n_w + 1] += gv.sum(0)
            d = _rnd(dy)
            for p in reversed(range(n_w)):
                x = xs[p]
                dw[p] += x.T @ d
                da = d @ f(weights[p]).T
                if fold and p == 0:
                    d_src[e] = _rnd(da)
                    d_pxj.index_add_(0, s, d)
                    dz = d
                    break
                da = torch.where(x > 0, da, torch.zeros(()))
                if p:
                    db[p - 1] += da.sum(0)
                    d = _rnd(da)
                    continue
                d_src[e] = _rnd(da)
                if entry == "pe":
                    d_pxj.index_add_(0, s, da)
                dz = _rnd(da)
            for half in (e[:32], e[32:]):
                if len(half):
                    d_pxi.index_add_(0, receivers[half],
                                     dz[half - t * TE])
        rows_w.append(dw)
        rows_b.append(db)
    d_w, d_b = rows_w[0], rows_b[0]
    for a, b in zip(rows_w[1:], rows_b[1:]):
        d_w, d_b = d_w + a, d_b + b
    bf = torch.bfloat16
    k = int(fold)
    tail = (d_w[k:k + l1].to(bf), d_b[k:k + l1].to(bf), d_w[-1].to(bf),
            d_b[n_w - 1].to(bf), d_b[n_w], d_b[n_w + 1])
    if fold:
        return (d_src.to(bf), d_w[0].to(bf), d_b[0].to(bf), d_pxj.to(bf),
                d_pxi.to(bf), *tail)
    if entry == "pe":
        return (d_src.to(bf), d_pxj.to(bf), d_pxi.to(bf), *tail)
    return (d_src.to(bf), d_pxi.to(bf), *tail)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


FOLD_BF16 = ("e0", "we", "be", "pxj", "pxi", "w_rest", "b_rest", "w_out",
             "b_out")
PRE_BF16 = ("h0", "pxi", "w_rest", "b_rest", "w_out", "b_out")


def fold_vjp(p, g, monkeypatch):
    """The VJP of ``fused_edge_tail_agg2rf`` on p's bf16 operands in
    interpret mode (``tests/test_torch_bf16_gnn.py``'s): every gradient in
    the port's layout."""
    args, chunks, n = _jax_side(p)
    a = [x.astype(jnp.bfloat16) if i < 9 else x for i, x in enumerate(args)]
    blk = block_graph(p["s"], p["r"], n)
    T, et = blk.senders.shape
    key = p["r"].astype(np.int64) * n + p["s"]
    slot_key = blk.receivers.reshape(T, et).astype(np.int64) * n + blk.senders
    live = blk.mask > 0
    e_idx = np.searchsorted(key, slot_key[live])
    g_pad = np.zeros((T * 128, W), np.float32)
    g_pad[:n] = g
    dummy = jnp.zeros((1, 128), jnp.int32)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    _, vjp = jax.vjp(
        lambda *x: pk.fused_edge_tail_agg2rf(*x, *a[11:], *chunks, dummy,
                                             dummy), *a[:11])
    d = vjp(jnp.asarray(g_pad.reshape(T, 128, W)))
    return (np.asarray(d[0], np.float32)[live][np.argsort(e_idx)], d[1], d[2],
            np.asarray(d[3])[:n], np.asarray(d[4]).reshape(-1, W)[:n], *d[5:])


@pytest.mark.parametrize("clusters", [1, 3])
def test_fold_pipeline_matches_fused2rf_vjp(monkeypatch, clusters):
    p = _problem(3, n=120, Ce=W, H=W, C=W, seed=173)
    for k in FOLD_BF16:
        p[k] = bf16(p[k])
    n = p["n"]
    g = np.random.default_rng(17).normal(size=(n, W)).astype(np.float32)
    want = fold_vjp(p, g, monkeypatch)
    port, graph = _port_args(p)
    port = [t.bfloat16() if t.is_floating_point() and i < 11 else t
            for i, t in enumerate(port)]
    assert -(-graph.n_edge // TE) > clusters  # several tiles a cluster
    got = pipeline_bwd("fold", *port, torch.from_numpy(g), clusters)
    for name, a, b in zip(fe.GRAD_NAMES, got, want):
        assert a.dtype == (torch.bfloat16 if name in FOLD_BF16
                           else torch.float32), name
        assert tuple(a.shape) == np.shape(b), name
        assert rel_l2(a.float().numpy(), np.asarray(b, np.float32)) \
            < GRAD_L2, name
    np.testing.assert_array_equal(got[4][n // 2].float().numpy(), 0.0)


@pytest.mark.parametrize("clusters", [1, 3])
def test_pregathered_pipeline_matches_fused_edge_tail_agg_vjp(monkeypatch,
                                                               clusters):
    p, graph, ops = _bf16_case(3, seed=177)
    n = p["n"]
    g = np.random.default_rng(18).normal(size=(n, W)).astype(np.float32)
    _, want = _pallas_fwd_bwd(p, g, monkeypatch)
    h0, pxi, rowptr, *tail = ops
    got = pipeline_bwd("pregathered", h0, None, None, None, pxi, None,
                       rowptr, *tail, torch.from_numpy(g), clusters)
    for name, a, b in zip(fe.GRAD_NAMES_PREGATHERED, got, want):
        assert a.dtype == (torch.bfloat16 if name in PRE_BF16
                           else torch.float32), name
        assert tuple(a.shape) == np.shape(b), name
        assert rel_l2(a.float().numpy(), np.asarray(b, np.float32)) \
            < GRAD_L2, name
    np.testing.assert_array_equal(got[1][n // 2].float().numpy(), 0.0)


@pytest.mark.parametrize("entry", ENTRIES)
def test_pipeline_equals_the_plain_version_at_l1_0_and_1(entry):
    """The emulation against the port's bf16 plain versions at the shallow
    depths the chip checks (the small graph's L1 = 1) and L1 = 0, where the
    first CTA is the output CTA (pe, pre-gathered): within 1e-2 relative
    L2."""
    p = _problem(1, n=120, Ce=W, H=W, C=W, seed=181)
    port, graph = _port_args(p)
    port = [t.bfloat16() if t.is_floating_point() and i < 11 else t
            for i, t in enumerate(port)]
    e0, we, be, pxj, pxi, senders, rowptr, *tail = port
    g = torch.from_numpy(np.random.default_rng(19).normal(
        size=(p["n"], W)).astype(np.float32))
    for l1 in (0, 1):
        t = [tail[0][:l1], tail[1][:l1], *tail[2:]]
        if entry == "fold":
            want = fe.fused_edge_tail_agg_bf16_bwd_plain(*port[:7], *t, g)
            got = pipeline_bwd("fold", *port[:7], *t, g, 3)
        elif entry == "pe":
            want = fe.fused_edge_tail_agg_pe_bf16_bwd_plain(
                e0, pxj, pxi, senders, rowptr, None, None, *t, g)
            got = pipeline_bwd("pe", e0, None, None, pxj, pxi, senders,
                               rowptr, *t, g, 3)
        else:
            want = fe.fused_edge_tail_agg_pregathered_bf16_bwd_plain(
                e0, pxi, rowptr, *t, g)
            got = pipeline_bwd("pregathered", e0, None, None, None, pxi,
                               None, rowptr, *t, g, 3)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            if b.numel():
                assert rel_l2(a.float().numpy(), b.float().numpy()) \
                    < GRAD_L2, (entry, l1)
