"""The fold-e GraphNet forward (#8) as its tiled kernels compute it, on the
CPU.

Both builds of the fold entry (``csrc/fused_edge_tail_agg.cu``: ``w64`` at
(Ce, H, C) = (32, 64, 32), ``w128`` at (128, 128, 128)) walk a CSR graph in
tiles of ``ops.fused_edge.FWD_TILE`` consecutive edges on a persistent grid
and run every product on the tensor cores in 3xTF32.  No card is needed for
three things they rest on:

(a) The walk.  The tile indices as the kernels find them (each block's
    tiles consecutive, ``block_tiles``; the receivers of a tile's two warps
    of 32 edges by ``tile128::warp_receiver``, from the last receiver of the
    tile before in the block, emulated here step by step) equal the CSR's
    receivers; and the receiver sums (``tests/test_torch_fwd_tiles.py``'s
    emulation of ``csr_tile``) at this tile and at the widths the two builds
    sum (C = 32 and 128) equal the plain receiver sum exactly on
    integer-valued float64 rows: a hub over three tiles and more, degree-0
    receivers at tile boundaries, E = 1, E a multiple of the tile, E one
    past it, and a clamped last range.

(b) The numerics.  ``split_fast``'s 3xTF32 through #8's whole fold chain
    (the first product e0 . W_e whose accumulators start at b_e + pxj[s] +
    pxi[i], the tail layers, LayerNorm, the receiver sums): at (32, 64, 32)
    with the Ce = 32 first product and at (128, 128, 128) with five K = 128
    products, at ``chip_smoke.py``'s operand scales and the main paths' mean
    in-degrees (30.4 at MAgNet[CNN] 1D's eval graph, 20.6 at MAgNet[GNN]'s
    eval LR u HR graph).  Against float64 the worst element lies inside
    ``KERNEL_RTOL`` / ``KERNEL_ATOL`` (1e-4) by more than 4x: it uses 6.2%
    (w64) and 4.9% (w128) of its bound at seed 1 (4.2-9.1% and 4.9-6.3% over
    seeds 1-3), within 3x of what plain f32 products use (1.1-2.5x over
    those seeds).  One TF32 product lies outside the bound: 162x (w64) and
    218x (w128) of it at seed 1 (122-318x over seeds 1-3).

    The tensor cores add each block of products to the accumulator aligned
    to the largest addend and truncate the rest, so small terms lose their
    low bits toward zero; emulated, a single accumulator puts the worst
    element of the 199-edge receiver of ``chip_smoke.tile_edges_graph`` at
    width 128 at 1.0x the bound, where the kernels' two accumulators
    (``tf32x3::mma3_apart``: the small products apart) keep it at 0.16x
    (0.20x with every sum rounded to nearest).

(c) Parity with the JAX package.  The port's ``fused_edge_tail_agg`` on the
    CPU (its plain path) matches ``fused_edge_tail_agg2rf`` in Pallas
    interpret mode, and the oracle ``_fused2re_ref_impl``, at both kernel
    widths (``tests/test_torch_fused_edge.py`` holds them at (16, 32, 8)),
    on a graph with a receiver of degree 0; rtol 1e-4, atol 1e-5 as there.

The emulations are this test's, not code of the package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from magnet_tpu.ops import pallas_kernels as pk  # noqa: E402
from magnet_tpu_torch.ops import fused_edge  # noqa: E402
from test_torch_fused_edge import (  # noqa: E402
    ATOL,
    RTOL,
    _jax_side,
    _port_args,
    _problem,
)
from test_torch_fwd_tiles import (  # noqa: E402
    KINDS,
    degrees,
    graph,
    pregathered_chain,
    share_of_bound,
    three_products,
    tile_walk,
)
from test_torch_tf32_split import one_product, tf32  # noqa: E402

TE = fused_edge.FWD_TILE
#: the columns each fold build sums: w64 (C = 32) and w128 (C = 128)
WIDTHS = (32, 128)


def receiver_of(rowptr, e):
    """The last i with rowptr[i] <= e (tile128::receiver_of)."""
    return int(np.searchsorted(rowptr, e, side="right")) - 1


def warp_receiver(rowptr, base, n_valid, hint=-1):
    """tile128::warp_receiver for the 32 lanes of a warp: the receivers of
    edges base .. base + 31 (lanes past n_valid unspecified)."""
    n_nodes = len(rowptr) - 1
    lanes = np.arange(32)
    lo, hi = (0, n_nodes) if hint < 0 else (hint, hint)
    while hi - lo > 1:
        step = (hi - lo + 31) >> 5
        i = lo + lanes * step
        le = (i < hi) & (rowptr[np.minimum(i, n_nodes)] <= base)
        assert le[0]  # lane 0 (i = lo) always holds
        lo += int(np.flatnonzero(le).max()) * step
        hi = min(hi, lo + step)
    e = base + lanes
    j = lo + 1 + lanes
    start = np.where(j <= n_nodes, rowptr[np.minimum(j, n_nodes)], 2**31 - 1)
    r = lo + (start[None, :] <= e[:, None]).sum(1)
    window_end = start[31]
    for lane in range(32):
        if lane < n_valid and e[lane] >= window_end:
            r[lane] = receiver_of(rowptr, e[lane])
    return r


def tile_receivers(rowptr, blocks):
    """The receivers every tile's edges get, as the kernels find them on a
    grid of ``blocks`` persistent blocks (block_tiles, tile_indices)."""
    n_edges = int(rowptr[-1])
    n_tiles = -(-n_edges // TE)
    per_block = -(-n_tiles // blocks)
    got = np.full(n_edges, -1)
    for b in range(blocks):
        t_beg, t_end = b * per_block, min(n_tiles, (b + 1) * per_block)
        hint = -1
        for t in range(t_beg, t_end):
            rcv = np.zeros(TE, int)
            for w in range(2):  # warps 0 and 1, 32 edges each
                base = t * TE + 32 * w
                n_valid = min(32, n_edges - base)
                r = warp_receiver(rowptr, base, n_valid, hint)
                for lane in range(max(0, n_valid)):
                    rcv[32 * w + lane] = r[lane]
            n_valid = min(TE, n_edges - t * TE)
            got[t * TE:t * TE + n_valid] = rcv[:n_valid]
            hint = int(rcv[n_valid - 1])
    return got


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_tile_indices_are_the_receivers(kind, blocks):
    rng = np.random.default_rng(len(kind) + blocks)
    deg = degrees(kind, TE, rng)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    got = tile_receivers(rowptr, blocks)
    np.testing.assert_array_equal(got, np.repeat(np.arange(len(deg)), deg))


def test_tile_indices_cross_runs_of_empty_receivers():
    """A tile whose receivers lie past the 32 row starts a warp reads (a run
    of degree-0 receivers) takes receiver_of for them."""
    deg = np.array([3] + [0] * 70 + [40] + [0] * 40 + [30, 1])
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    for blocks in (1, 2):
        np.testing.assert_array_equal(
            tile_receivers(rowptr, blocks),
            np.repeat(np.arange(len(deg)), deg))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("width", WIDTHS)
def test_fold_tile_walk_equals_the_receiver_sum(width, kind):
    rng = np.random.default_rng(len(kind) + width)
    deg = degrees(kind, TE, rng)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    e = int(rowptr[-1])
    if kind == "multiple":
        assert e % TE == 0
    if kind == "one_past":
        assert e % TE == 1
    if kind == "hub":
        assert deg.max() >= 3 * TE
    vals = rng.integers(-8, 9, (e, width)).astype(np.float64)
    want = np.zeros((len(deg), width))
    np.add.at(want, np.repeat(np.arange(len(deg)), deg), vals)
    got, part, read = tile_walk(vals, rowptr, TE)
    np.testing.assert_array_equal(got, want)
    assert (got[deg == 0] == 0).all()
    assert not np.isnan(part[sorted(read)]).any()


@pytest.mark.parametrize("width", WIDTHS)
def test_fold_tile_walk_clamps_the_last_range(width):
    rng = np.random.default_rng(width)
    deg = degrees("hub", TE, rng)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    cut = int(rowptr[-1]) - 7
    vals = rng.integers(-8, 9, (cut, width)).astype(np.float64)
    want = np.zeros((len(deg), width))
    np.add.at(want, np.repeat(np.arange(len(deg)), deg)[:cut], vals)
    got, _, _ = tile_walk(vals, rowptr, TE)
    np.testing.assert_array_equal(got, want)


def fold_chain(e0, we, be, pxj, pxi, senders, receivers, n, *tail, mm):
    """#8's function: z = e0 . W_e + b_e + pxj[s] + pxi[i], then #2's chain
    (``mm`` as there: None is float64 throughout)."""
    prod = e0 @ we if mm is None else mm(e0, we)
    return pregathered_chain(prod + be + pxj[senders], pxi, receivers, n,
                             *tail, mm)


#: (Ce, H, C, mean in-degree's range, nodes) of the two builds' cases
FOLD_CASES = {"w64": (32, 64, 32, (25, 36), 192),
              "w128": (128, 128, 128, (16, 26), 96)}


def fold_case(build, seed):
    """#8 at chip_smoke.kernel_operands' scales (L1 = 3) on a graph of the
    build's main path's mean in-degree: (f32 operands, float64 result)."""
    ce, h, c, (lo, hi), n = FOLD_CASES[build]
    rng = np.random.default_rng(seed)
    receivers, n = graph(n, lo, hi, rng)
    senders = rng.integers(0, n, len(receivers))

    def f(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    ops = (f(len(receivers), ce), f(ce, h), f(h), f(n, h), f(n, h), senders,
           receivers, n, f(3, h, h), f(3, h), f(h, c), f(c),
           1 + f(c, scale=0.1), f(c, scale=0.1))
    want = fold_chain(*[o.astype(np.float64) if isinstance(o, np.ndarray)
                        and o.dtype == np.float32 else o for o in ops],
                      mm=None)
    return ops, want


def test_fold_cases_have_the_main_paths_mean_in_degrees():
    for build, want in (("w64", 186_624 / 6_144), ("w128", 84_256 / 4_096)):
        ops, _ = fold_case(build, seed=1)
        mean = len(ops[6]) / ops[7]
        assert abs(mean - want) < 1.5, (build, mean, want)


@pytest.mark.parametrize("build", sorted(FOLD_CASES))
def test_three_tf32_products_lie_well_inside_the_kernel_tolerance(build):
    ops, want = fold_case(build, seed=1)
    rtol, atol = chip_smoke.KERNEL_RTOL, chip_smoke.KERNEL_ATOL
    share = share_of_bound(fold_chain(*ops, mm=three_products), want, rtol,
                           atol)
    assert share <= 0.25, share
    f32 = share_of_bound(
        fold_chain(*ops, mm=lambda a, b: (a @ b).astype(np.float32)), want,
        rtol, atol)
    assert share <= 3 * f32, (share, f32)


@pytest.mark.parametrize("build", sorted(FOLD_CASES))
def test_one_tf32_product_lies_outside_the_kernel_tolerance(build):
    ops, want = fold_case(build, seed=1)
    rtol, atol = chip_smoke.KERNEL_RTOL, chip_smoke.KERNEL_ATOL
    three = share_of_bound(fold_chain(*ops, mm=three_products), want, rtol,
                           atol)
    one = share_of_bound(fold_chain(*ops, mm=one_product), want, rtol, atol)
    assert one > 10, one
    assert one > 100 * three, (one, three)


def tf32_truncate(x):
    """The top 19 bits of f32 x: the tensor cores' reading of an f32
    operand as TF32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def truncating_mma(c, a, b):
    """c + a . b for one k = 8 step of mma.sync .tf32 as modelled here: the
    products exact, every addend (c and the 8 products) truncated toward
    zero at 2^-23 of the largest one's binade, the sum truncated to f32."""
    terms = np.concatenate(
        [c[:, None, :].astype(np.float64),
         a[:, :, None].astype(np.float64) * b[None, :, :]], axis=1)
    top = np.abs(terms).max(1, keepdims=True)
    q = 2.0 ** (np.floor(np.log2(np.where(top > 0, top, 1.0))) - 23)
    total = (np.trunc(terms / q) * q).sum(1)
    out = total.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(total)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


def tensor_core_layer(h, w, bias, apart):
    """h . w + bias in three TF32 products as the forwards issue them
    (split_fast, k-steps of 8, the accumulator starting at the bias):
    ``apart``, the two small products in an accumulator of their own added
    at the end (mma3_apart), else all three in one (mma3)."""
    ah, bh = tf32(h), tf32(w)
    al = tf32_truncate((h - ah).astype(np.float32))
    bl = tf32_truncate((w - bh).astype(np.float32))
    acc = np.broadcast_to(bias, (h.shape[0], w.shape[1])).astype(np.float32)
    corr = np.zeros_like(acc)
    for k0 in range(0, h.shape[1], 8):
        k = slice(k0, k0 + 8)
        small = corr if apart else acc
        small = truncating_mma(small, al[:, k], bh[k])
        small = truncating_mma(small, ah[:, k], bl[k])
        if apart:
            corr = small
            acc = truncating_mma(acc, ah[:, k], bh[k])
        else:
            acc = truncating_mma(small, ah[:, k], bh[k])
    return (acc + corr).astype(np.float32)


@pytest.mark.parametrize("apart", [True, False])
def test_small_products_apart_keep_a_hub_inside_the_bound(apart):
    """The width-128 pre-gathered forward on chip_smoke's tile graph (a
    199-edge receiver), accumulation emulated, against the plain version
    (in f32, as on the card)."""
    tiles = chip_smoke.tile_edges_graph(TE, seed=35)
    ops = chip_smoke.pregathered_operands(tiles, 128, 128, 3, seed=37,
                                          dev="cpu")
    want = fused_edge.fused_edge_tail_agg_pregathered_plain(*ops)
    h0, pxi, rowptr, *tail = [t.numpy() for t in ops]
    n = len(rowptr) - 1
    receivers = np.repeat(np.arange(n), np.diff(rowptr))
    got = pregathered_chain(
        h0, pxi, receivers, n, *tail,
        lambda a, b: tensor_core_layer(a, b, np.float32(0), apart))
    share = share_of_bound(got, want.double().numpy(),
                           chip_smoke.KERNEL_RTOL, chip_smoke.KERNEL_ATOL)
    if apart:
        assert share <= 0.25, share
    else:
        assert share > 0.5, share


#: the kernel widths (Ce, H, C)
KERNEL_WIDTHS = sorted(fused_edge.KERNEL_WIDTHS["fold"])


@pytest.mark.parametrize("widths", KERNEL_WIDTHS)
def test_plain_matches_jax_oracle_at_kernel_widths(widths):
    ce, h, c = widths
    p = _problem(3, Ce=ce, H=h, C=c, seed=ce)
    args, _, n = _jax_side(p)
    want = np.asarray(pk._fused2re_ref_impl(*args)).reshape(-1, c)[:n]
    port_args, g = _port_args(p)
    got = fused_edge.fused_edge_tail_agg_plain(*port_args).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert g.degree[n // 2] == 0
    np.testing.assert_array_equal(got[n // 2], 0.0)


@pytest.mark.parametrize("widths", KERNEL_WIDTHS)
def test_wrapper_cpu_matches_pallas_interpret_at_kernel_widths(monkeypatch,
                                                                widths):
    ce, h, c = widths
    p = _problem(3, Ce=ce, H=h, C=c, seed=ce + 1)
    args, chunks, n = _jax_side(p)
    dummy = jnp.zeros((1, 128), jnp.int32)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    want = np.asarray(pk.fused_edge_tail_agg2rf(*args, *chunks, dummy, dummy))
    want = want.reshape(-1, c)[:n]
    port_args, g = _port_args(p)
    before = dict(fused_edge.launch_counts())
    got = fused_edge.fused_edge_tail_agg(*port_args).numpy()
    assert fused_edge.launch_counts() == before  # the CPU path: no kernel
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert g.degree[n // 2] == 0
    np.testing.assert_array_equal(got[n // 2], 0.0)
