"""The width-64 GraphNet backward (#9 at (Ce, H, C) = (32, 64, 32), #3 at
(H, C) = (64, 32)) as its tiled kernel computes it, on the CPU.

``csrc/fused_edge_tail_agg_bwd.cu`` (``w64``) walks a CSR graph in tiles of
``ops.fused_edge.BWD_TILE`` consecutive edges on a persistent grid, runs
every product on the tensor cores in 3xTF32 and keeps a block's weight
gradients in f32 registers across its tiles.  No card is needed for three
things it rests on:

(a) The walk.  The grid ``launch`` picks (at most one block per SM, each
    block a run of consecutive tiles, every block at least one), the tile
    indices as the kernel finds them (``tile128::warp_receiver`` with the
    last receiver of the tile before, emulated in
    ``tests/test_torch_fold_tiles.py``) and the d_pxi sums (a thread per
    column sums each run of equal receivers in an eighth of a tile and adds
    it with one atomic) equal the receiver sum exactly on integer-valued
    rows: a hub over three tiles and more, degree-0 receivers at tile
    boundaries, E = 1, E a multiple of the tile and one past it; every
    degree-0 row stays exactly 0.

(b) The numerics.  The whole backward chain (recompute, LayerNorm's
    backward, the data and weight gradients of every layer, the node
    scatters) with each product in 3xTF32, split as the kernel splits
    (``split_fast``) and as the width-128 backward does (``split``), at
    ``chip_smoke.py``'s operand scales and the main paths' mean in-degrees
    (13.2 at MAgNet[CNN] 1D's training graph, 8.9 at 2D's): against
    float64 every gradient lies inside ``BWD_RTOL`` / ``BWD_ATOL_REL``
    elementwise (the worst element at 1.0% of its bound for #9, 0.8% for
    #3, as with plain f32 products) and within 4e-6 relative L2, where one
    TF32 product leaves 14k-20k elements outside, the worst at ~1,600x its
    bound.  g is zero on the receivers of relu ties (within 1e-5 of the
    layer's RMS), as ``chip_smoke.tie_receivers`` zeroes it.

(c) The weight gradients' accumulation.  The tensor cores truncate what they
    add to a large accumulator (``tests/test_torch_fold_tiles.py`` emulates
    one ``mma``).  Over a block's edge range at the two main paths' sizes
    (~513 edges at the 1D training graph on 132 SMs, ~2,272 at 2D's batch-32
    graph) one running accumulator leaves its worst element at 0.28% and
    1.1% of the bound, 9x and 26x the kernel's scheme (0.03%, 0.04%: a
    fresh accumulator per 64-edge tile, added to the running sums in f32);
    the gap grows with the range.

The emulations are this test's, not code of the package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from magnet_tpu_torch.ops import fused_edge  # noqa: E402
from test_torch_fold_tiles import (  # noqa: E402
    tensor_core_layer,
    tile_receivers,
)
from test_torch_fwd_tiles import (  # noqa: E402
    KINDS,
    degrees,
    graph,
)
from test_torch_fwd_tiles import (  # noqa: E402
    three_products as split_fast_products,
)
from test_torch_tf32_split import one_product  # noqa: E402
from test_torch_tf32_split import (  # noqa: E402
    three_products as split_products,
)

TE = fused_edge.BWD_TILE
H = 64
SMS = 132  # an H100's SMs: one block each


def grid(n_edges, cap):
    """(blocks, tiles a block) as ``w64::launch`` picks them."""
    n_tiles = -(-n_edges // TE)
    per_block = -(-n_tiles // cap)
    return -(-n_tiles // per_block), per_block


def d_pxi_walk(vals, rowptr, cap):
    """d_pxi as the kernel sums it: on the grid ``launch`` picks, each tile's
    receivers as the blocks find them, then per column one sum (an atomic
    add) per run of equal receivers in each eighth of a tile."""
    n_edges = len(vals)
    blocks, _ = grid(n_edges, cap)
    rcv_all = tile_receivers(rowptr, blocks)
    assert (rcv_all >= 0).all()  # every edge in some block's tiles
    out = np.zeros((len(rowptr) - 1, vals.shape[1]))
    part = TE * H // 512  # edges of an eighth (512 threads, H columns)
    for t in range(-(-n_edges // TE)):
        base = t * TE
        n_valid = min(TE, n_edges - base)
        rcv = rcv_all[base:base + n_valid]
        for q in range(512 // H):
            e_beg, e_end = q * part, min(q * part + part, n_valid)
            if e_beg >= e_end:
                continue
            at, s = rcv[e_beg], np.zeros(vals.shape[1])
            for e in range(e_beg, e_end):
                if rcv[e] != at:
                    out[at] += s
                    at, s = rcv[e], np.zeros(vals.shape[1])
                s = s + vals[base + e]
            out[at] += s
    return out


@pytest.mark.parametrize("n_edges", [1, TE, TE + 1, 1_057 * TE + 32,
                                     4_685 * TE + 38])
def test_grid_gives_every_block_a_tile(n_edges):
    blocks, per_block = grid(n_edges, SMS)
    n_tiles = -(-n_edges // TE)
    assert blocks <= SMS
    assert (blocks - 1) * per_block < n_tiles <= blocks * per_block
    # the kernel's block_tiles, from gridDim.x = blocks
    assert -(-n_tiles // blocks) == per_block


def test_grids_of_the_main_paths():
    """9 tiles a block at the 1D training graph, 36 at 2D batch 32."""
    assert grid(67_680, SMS) == (118, 9)
    assert grid(299_894, SMS) == (131, 36)


@pytest.mark.parametrize("cap", [1, 3, SMS])
@pytest.mark.parametrize("kind", KINDS)
def test_d_pxi_walk_equals_the_receiver_sum(kind, cap):
    rng = np.random.default_rng(len(kind) + cap)
    deg = degrees(kind, TE, rng)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    e = int(rowptr[-1])
    if kind == "multiple":
        assert e % TE == 0
    if kind == "one_past":
        assert e % TE == 1
    if kind == "one":
        assert e == 1
    if kind == "hub":
        assert deg.max() >= 3 * TE
    if kind == "boundaries":
        assert (deg[np.flatnonzero(rowptr[1:] % TE == 0)[:-1] + 1] == 0).any()
    vals = rng.integers(-8, 9, (e, H)).astype(np.float64)
    want = np.zeros((len(deg), H))
    np.add.at(want, np.repeat(np.arange(len(deg)), deg), vals)
    got = d_pxi_walk(vals, rowptr, cap)
    np.testing.assert_array_equal(got, want)
    assert (got[deg == 0] == 0).all()


def bwd_chain(src, we, be, pxj, pxi, senders, receivers, n, w_rest, b_rest,
              w_out, b_out, ln_s, ln_b, g, mm):
    """The width-64 backward's function: the gradients of sum(out * g),
    ``fused_edge.GRAD_NAMES`` order for the fold (``we`` not None), else
    ``GRAD_NAMES_PREGATHERED``.  ``mm`` is every product (None: float64
    throughout, else f32 with mm(a, b))."""
    f = np.float64 if mm is None else np.float32
    mm = mm or (lambda a, b: a @ b)
    fold = we is not None
    z = (mm(src, we) + be + pxj[senders] if fold else src) + pxi[receivers]
    hs = [np.maximum(z, 0).astype(f)]
    for w, b in zip(w_rest, b_rest):
        hs.append(np.maximum(mm(hs[-1], w) + b, 0).astype(f))
    y = (mm(hs[-1], w_out) + b_out).astype(f)
    c = y.shape[1]
    mu = y.mean(-1, keepdims=True, dtype=f)
    d = y - mu
    rstd = (1 / np.sqrt((d * d).mean(-1, keepdims=True, dtype=f)
                        + f(fused_edge.LN_EPS))).astype(f)
    xhat = (d * rstd).astype(f)
    ge = g[receivers]
    dx = (ge * ln_s).astype(f)
    dy = (rstd * (dx - dx.sum(-1, keepdims=True) / c
                  - xhat * (dx * xhat).sum(-1, keepdims=True) / c)).astype(f)
    d_tail = [mm(hs[-1].T, dy), dy.sum(0), (ge * xhat).sum(0), ge.sum(0)]
    da = (mm(dy, w_out.T) * (hs[-1] > 0)).astype(f)
    d_wr, d_br = [], []
    for k in reversed(range(len(w_rest))):
        d_wr.insert(0, mm(hs[k].T, da))
        d_br.insert(0, da.sum(0))
        da = (mm(da, w_rest[k].T) * (hs[k] > 0)).astype(f)
    d_pxi = np.zeros((n, da.shape[1]), f)
    np.add.at(d_pxi, receivers, da)
    l1 = len(w_rest)
    tail = (np.reshape(d_wr, (l1, H, H)).astype(f),
            np.reshape(d_br, (l1, H)).astype(f), *d_tail)
    if not fold:
        return (da, d_pxi, *tail)
    d_pxj = np.zeros_like(d_pxi)
    np.add.at(d_pxj, senders, da)
    return (mm(da, we.T), mm(src.T, da), da.sum(0), d_pxj, d_pxi, *tail)


def tie_free_g(src, we, be, pxj, pxi, senders, receivers, n, w_rest, b_rest,
               g):
    """g with the receivers of relu ties zeroed (chip_smoke.tie_receivers:
    a pre-activation within 1e-5 of its layer's RMS from 0, in float64)."""
    d = [np.asarray(t, np.float64) for t in (src, pxj, pxi)]
    z = (d[0] @ we + be + d[1][senders] if we is not None else d[0]) + \
        d[2][receivers]
    near = np.zeros(len(z), bool)
    for k in range(len(w_rest) + 1):
        near |= (np.abs(z) < 1e-5 * np.sqrt((z ** 2).mean())).any(1)
        if k < len(w_rest):
            z = np.maximum(z, 0) @ w_rest[k] + b_rest[k]
    g = g.copy()
    g[np.unique(receivers[near])] = 0
    return g


#: (entry, main path's mean in-degree range, nodes)
CHAIN_CASES = {"fold": ((9, 18), 192), "pregathered": ((5, 13), 256)}


def chain_case(entry, seed):
    """The entry at chip_smoke's operand scales (L1 = 3) on a graph of its
    main path's mean in-degree: (f32 operands, float64 gradients)."""
    (lo, hi), n = CHAIN_CASES[entry]
    rng = np.random.default_rng(seed)
    receivers, n = graph(n, lo, hi, rng)
    senders = rng.integers(0, n, len(receivers))
    e = len(receivers)

    def f(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    fold = entry == "fold"
    src = f(e, 32 if fold else H)
    we, be = (f(32, H), f(H)) if fold else (None, None)
    ops = [src, we, be, f(n, H), f(n, H), senders, receivers, n, f(3, H, H),
           f(3, H), f(H, 32), f(32), 1 + f(32, scale=0.1), f(32, scale=0.1)]
    g = rng.standard_normal((n, 32)).astype(np.float32)
    ops.append(tie_free_g(*ops[:10], g))
    want = bwd_chain(*[o.astype(np.float64) if isinstance(o, np.ndarray)
                       and o.dtype == np.float32 else o for o in ops],
                     mm=None)
    return ops, want


def grad_errors(got, want):
    """chip_smoke.compare_grad's measures, in numpy: elements outside
    BWD_RTOL |want| + BWD_ATOL_REL max |want|, and the relative L2 error."""
    err = np.abs(np.asarray(got, np.float64) - want)
    top = np.abs(want).max()
    bound = chip_smoke.BWD_RTOL * np.abs(want) + chip_smoke.BWD_ATOL_REL * top
    return {"n_outside": int((err > bound).sum()),
            "over_bound": float((err / bound).max()),
            "rel_l2": float(np.linalg.norm(err) / np.linalg.norm(want))}


@pytest.mark.parametrize("entry", sorted(CHAIN_CASES))
def test_chain_matches_plain_autograd_in_float64(entry):
    """The numpy chain is the plain backward's function."""
    ops, want = chain_case(entry, seed=1)
    src, we, be, pxj, pxi, senders, receivers, n, *tail, g = [
        torch.from_numpy(o).double() if isinstance(o, np.ndarray)
        and o.dtype == np.float32 else o for o in ops]
    deg = np.bincount(receivers, minlength=n)
    rowptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])).int()
    if entry == "fold":
        got = fused_edge.fused_edge_tail_agg_bwd_plain(
            src, we, be, pxj, pxi, torch.from_numpy(senders).int(), rowptr,
            *tail, g)
    else:
        got = fused_edge.fused_edge_tail_agg_pregathered_bwd_plain(
            src, pxi, rowptr, *tail, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("split", ["split_fast", "split"])
@pytest.mark.parametrize("entry", sorted(CHAIN_CASES))
def test_three_tf32_products_lie_inside_the_backward_tolerances(entry, split):
    ops, want = chain_case(entry, seed=1)
    mm = split_fast_products if split == "split_fast" else split_products
    for got, w in zip(bwd_chain(*ops, mm=mm), want):
        e = grad_errors(got, w)
        assert e["n_outside"] == 0, e
        assert e["rel_l2"] <= chip_smoke.BWD_L2 / 100, e


@pytest.mark.parametrize("entry", sorted(CHAIN_CASES))
def test_one_tf32_product_does_not(entry):
    ops, want = chain_case(entry, seed=1)
    errors = [grad_errors(got, w)
              for got, w in zip(bwd_chain(*ops, mm=one_product), want)]
    assert sum(e["n_outside"] for e in errors) > 0, errors
    assert max(e["over_bound"] for e in errors) > 2, errors


def block_dw(h, da, per_tile):
    """A block's dW = h^T . da over its edges as the tensor cores form it
    (split_fast, the small products apart): ``per_tile``, a fresh
    accumulator per tile of TE edges added to the running sums in f32, as
    the kernel does; else one accumulator over the whole range."""
    if not per_tile:
        return tensor_core_layer(h.T.copy(), da, np.float32(0), apart=True)
    run = np.zeros((h.shape[1], da.shape[1]), np.float32)
    for t in range(0, len(h), TE):
        run += tensor_core_layer(h[t:t + TE].T.copy(), da[t:t + TE],
                                 np.float32(0), apart=True)
    return run


#: a block's edges at the two main paths: 1D training (67,680 edges) and
#: 2D batch 32 (299,894) over 132 SMs
BLOCK_EDGES = {"cnn_1d_train": 513, "cnn_2d_b32": 2_272}


def dw_share(edges, per_tile, seed=0):
    """The worst element of a block's dW over its share of the backward's
    elementwise bound, at the kernel's scales: relu activations (half
    zero) and gradients of one sign per column's mean (so that the sums
    grow with the range, as the main paths' dW do)."""
    rng = np.random.default_rng(seed)
    h = np.maximum(rng.standard_normal((edges, H)) * 0.5, 0).astype(np.float32)
    da = ((rng.standard_normal((edges, H)) + 0.5) * 0.05).astype(np.float32)
    want = h.astype(np.float64).T @ da.astype(np.float64)
    got = block_dw(h, da, per_tile)
    return grad_errors(got, want)["over_bound"]


@pytest.mark.parametrize("path", sorted(BLOCK_EDGES))
def test_fresh_accumulators_per_tile_keep_the_margin(path):
    edges = BLOCK_EDGES[path]
    per_tile = dw_share(edges, per_tile=True)
    running = dw_share(edges, per_tile=False)
    assert per_tile <= 0.02, per_tile
    assert running >= 3 * per_tile, (running, per_tile)
