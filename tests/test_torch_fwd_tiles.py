"""The tiled forward kernels' arithmetic, on the CPU.

The MPNN forward (#10, #4: ``csrc/fused_mpnn_edge_agg.cu``) and the
width-64 pre-gathered GraphNet forward (#2: ``csrc/fused_edge_tail_agg.cu``,
``w64``) walk a CSR graph in tiles of consecutive edges and sum each
receiver's rows without atomics (``csr_tile`` in ``csrc/tile_mm.cuh``).  No
card is needed for two things they rest on:

(a) The receiver sums.  A numpy emulation of the device code, step by
    step: each thread's serial sum of its column over a segment of the
    tile's rows (runs inside the segment written, the first and last run's
    sums left in its first and last row), the join of the segments in
    order, the partial rows a receiver leaves in each tile it crosses, in a
    scratch of ``ops.graph.part_rows`` rows (the helper that sizes the
    wrappers' buffer), and the second kernel's sum of those rows in tile
    order.  On integer-valued float64 rows, where every association gives
    the same sum, it must equal the plain receiver sum exactly, with every
    degree-0 row zero, every partial row it reads written first, and no row
    past the edge count read; at the TE each wrapper passes to its kernel
    and at the widths they sum (C = 128 for #10, 32 for #2).

(b) The products in 3xTF32 as the forwards split them (``split_fast``: hi
    = x rounded to TF32, lo = x - hi, which the tensor cores truncate; the
    backward kernels round lo too, ``tests/test_torch_tf32_split.py``)
    through #2's whole chain (H 64, C 32, L1 3, LayerNorm, receiver sums)
    and through #10's (H 128, swish on both sides), at ``chip_smoke.py``'s
    operand scales and the main paths' mean in-degrees (8.9 and 32): against
    float64 they lie inside the kernel tolerances (``KERNEL_RTOL`` /
    ``KERNEL_ATOL``, ``MPNN_RTOL`` / ``MPNN_ATOL``, all 1e-4) by more than 4x:
    the worst element uses 3.0% (#2) and 1.6% (#10) of its bound (seed 1;
    2.6-3.2% and 1.6-1.8% over seeds 1-3), within 2x of what plain f32
    products use (1.8%, 1.2%).  One TF32 product would leave no margin:
    its worst element lies at 112x (#2) and 48x (#10) of its bound (88-112x
    and 37-50x over seeds 1-3).

The emulations are this test's, not code of the package.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from magnet_tpu_torch.ops import fused_edge, mpnn_edge  # noqa: E402
from magnet_tpu_torch.ops.graph import part_rows  # noqa: E402
from test_torch_tf32_split import one_product, tf32  # noqa: E402

# the tiles the wrappers pass to their kernels: #10/#4, and #2 (with the
# width-128 builds)
TILES = {"mpnn": mpnn_edge.FWD_TILE, "pregathered": fused_edge.FWD_TILE}
# the columns each kernel sums (one thread a column, 256 threads a block)
WIDTHS = {"mpnn": 128, "pregathered": 32}


def tile_walk(vals, rowptr, te, threads=256):
    """(out, part, rows read) as the kernels form them: ``vals`` (E, C) are
    the rows of the E edges the kernel was given (rowptr may end past E: its
    ranges are clamped), ``te`` the tile, ``threads`` a block's."""
    n_edges, c = vals.shape
    n = len(rowptr) - 1
    receivers = np.repeat(np.arange(n), np.diff(rowptr))[:n_edges]
    n_tiles = -(-n_edges // te)
    n_seg = threads // c          # segments of a tile, one thread a column
    rows_seg = te // n_seg        # rows of a segment
    part = np.full((part_rows(n_edges, te), c), np.nan)
    out = np.zeros((n, c))
    for t in range(n_tiles):
        base = t * te
        n_valid = min(te, n_edges - base)
        rcv = receivers[base:base + n_valid]
        # the tile's buffer; rows past n_valid hold whatever it held: NaN
        # here, so that any use of them shows
        tile = np.full((te, c), np.nan)
        tile[:n_valid] = vals[base:base + n_valid]

        def flush(r, s):
            starts = rowptr[r] >= base
            ends = min(rowptr[r + 1], n_edges) <= base + te
            if starts and ends:
                out[r] = s
            else:
                part[2 * t + int(starts)] = s

        # step 1: each segment in order (every column at once); a run inside
        # it is written, its first and last run's sums left in its first
        # and last row
        for q in range(n_seg):
            e0, e1 = q * rows_seg, min(q * rows_seg + rows_seg, n_valid)
            if e0 >= e1:
                continue
            r, s, first, in_first = rcv[e0], np.zeros(c), None, True
            for e in range(e0, e1):
                if rcv[e] != r:
                    if in_first:
                        first = s
                    else:
                        out[r] = s
                    in_first, r, s = False, rcv[e], np.zeros(c)
                s = s + tile[e]
            if in_first:
                tile[e0] = s
            else:
                tile[e0], tile[e1 - 1] = first, s
        # step 2: the segments joined in order
        cur, acc = -1, None
        for k in range(n_seg):
            a = k * rows_seg
            if a >= n_valid:
                break
            z = min(a + rows_seg, n_valid) - 1
            if rcv[a] == cur:
                acc = acc + tile[a]
            else:
                if cur >= 0:
                    flush(cur, acc)
                cur, acc = rcv[a], tile[a]
            if rcv[z] != rcv[a]:
                flush(cur, acc)
                cur, acc = rcv[z], tile[z]
        if cur >= 0:
            flush(cur, acc)
    # the second kernel: block b owns the receiver that crosses the boundary
    # at edge te (b + 1) and starts in the tile before it
    read = set()
    for b in range(n_tiles - 1):
        e = (b + 1) * te
        r = int(np.searchsorted(rowptr, e, side="right")) - 1
        beg = rowptr[r]
        if beg >= e or beg < e - te:
            continue
        t0, t1 = beg // te, (min(rowptr[r + 1], n_edges) - 1) // te
        total = part[2 * t0 + 1].copy()
        read.add(2 * t0 + 1)
        for t in range(t0 + 1, t1 + 1):
            total += part[2 * t]
            read.add(2 * t)
        out[r] = total
    return out, part, read


def degrees(kind, te, rng):
    """In-degrees of the receivers of a test graph, by kind."""
    if kind == "hub":
        # a receiver that starts mid-tile and spans four tiles, degree-0
        # receivers around it, then random degrees
        head = [0, 5, 0, 3 * te + 7, 0, 0]
        return np.array(head + list(rng.integers(0, 2 * te, 40)) + [0, 0])
    if kind == "boundaries":
        # receivers that end exactly on tile boundaries, with degree-0
        # receivers on both sides of them; E = 5 te
        return np.array([0, te - 3, 3, 0, 0, te, 0, 2 * te, 0, 1, te - 1, 0])
    if kind == "one":
        return np.array([0, 1, 0])
    d = list(rng.integers(0, 2 * te, 30))
    target = -(-sum(d) // te) * te + (1 if kind == "one_past" else 0)
    return np.array(d + [target - sum(d), 0])


KINDS = ("hub", "boundaries", "one", "multiple", "one_past")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("path", sorted(TILES))
def test_tile_walk_equals_the_receiver_sum(path, kind):
    te = TILES[path]
    rng = np.random.default_rng(len(kind) + te)
    deg = degrees(kind, te, rng)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    e = int(rowptr[-1])
    if kind == "multiple":
        assert e % te == 0
    if kind == "one_past":
        assert e % te == 1
    if kind == "hub":
        assert deg.max() >= 3 * te
    vals = rng.integers(-8, 9, (e, WIDTHS[path])).astype(np.float64)
    want = np.zeros((len(deg), WIDTHS[path]))
    np.add.at(want, np.repeat(np.arange(len(deg)), deg), vals)
    got, part, read = tile_walk(vals, rowptr, te)
    np.testing.assert_array_equal(got, want)
    assert (got[deg == 0] == 0).all()
    assert not np.isnan(part[sorted(read)]).any()  # every row read was written
    assert len(part) == part_rows(e, te)


@pytest.mark.parametrize("path", sorted(TILES))
def test_tile_walk_clamps_the_last_range(path):
    """rowptr ending past the E rows given: the kernels clamp every range to
    the E rows (no row past them is read)."""
    te = TILES[path]
    rng = np.random.default_rng(te)
    deg = degrees("hub", te, rng)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    cut = int(rowptr[-1]) - 7
    vals = rng.integers(-8, 9, (cut, WIDTHS[path])).astype(np.float64)
    want = np.zeros((len(deg), WIDTHS[path]))
    np.add.at(want, np.repeat(np.arange(len(deg)), deg)[:cut], vals)
    got, _, _ = tile_walk(vals, rowptr, te)
    np.testing.assert_array_equal(got, want)


def truncate(x):
    """The top 19 bits of f32 x: a TF32 value by truncation, as the tensor
    cores read an f32 operand."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def three_products(a, b):
    """a . b as the forward kernels take it (tf32x3::split_fast): hi = x
    rounded to TF32, lo = x - hi read by the tensor cores as TF32 (so
    truncated); a_lo b_hi + a_hi b_lo, then a_hi b_hi, summed in f32."""
    ah, bh = tf32(a), tf32(b)
    al = truncate((a - ah).astype(np.float32))
    bl = truncate((b - bh).astype(np.float32))
    acc = (al @ bh).astype(np.float32) + (ah @ bl).astype(np.float32)
    return (acc + ah @ bh).astype(np.float32)


def graph(n, lo, hi, rng):
    """(receivers, n): random in-degrees in [lo, hi)."""
    return np.repeat(np.arange(n), rng.integers(lo, hi, n)), n


def receiver_sum(y, receivers, n):
    out = np.zeros((n, y.shape[1]), y.dtype)
    np.add.at(out, receivers, y)
    return out


def pregathered_chain(h0, pxi, receivers, n, w_rest, b_rest, w_out, b_out,
                      ln_s, ln_b, mm):
    """#2's function; ``mm`` the product (None: float64 throughout, else
    f32 with mm(a, b) for every product)."""
    f = np.float64 if mm is None else np.float32
    mm = mm or (lambda a, b: a @ b)
    h = np.maximum(h0 + pxi[receivers], 0).astype(f)
    for w, b in zip(w_rest, b_rest):
        h = np.maximum(mm(h, w) + b, 0).astype(f)
    y = (mm(h, w_out) + b_out).astype(f)
    mu = y.mean(-1, keepdims=True, dtype=f)
    d = y - mu
    var = (d * d).mean(-1, keepdims=True, dtype=f)
    y = (d / np.sqrt(var + f(fused_edge.LN_EPS)) * ln_s + ln_b).astype(f)
    return receiver_sum(y, receivers, n)


def swish(z):
    return z / (1 + np.exp(-z))


def mpnn_chain(send, pr, receivers, n, w, b, mm):
    """#10's function, as ``pregathered_chain``."""
    f = np.float64 if mm is None else np.float32
    mm = mm or (lambda a, c: a @ c)
    h1 = swish(send + pr[receivers]).astype(f)
    h2 = swish(mm(h1, w) + b).astype(f)
    return receiver_sum(h2, receivers, n)


def share_of_bound(got, want, rtol, atol):
    """The worst element's error over its bound atol + rtol |want|."""
    err = np.abs(got.astype(np.float64) - want)
    return float((err / (atol + rtol * np.abs(want))).max())


def pregathered_case(seed):
    """#2 at chip_smoke.pregathered_operands' scales, mean in-degree ~9."""
    rng = np.random.default_rng(seed)
    h, c, l1 = 64, 32, 3
    receivers, n = graph(256, 4, 15, rng)

    def f(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    ops = (f(len(receivers), h), f(n, h), receivers, n, f(l1, h, h),
           f(l1, h), f(h, c), f(c), 1 + f(c, scale=0.1), f(c, scale=0.1))
    want = pregathered_chain(*[o.astype(np.float64) if isinstance(
        o, np.ndarray) and o.dtype == np.float32 else o for o in ops], None)
    return ops, want


def mpnn_case(seed):
    """#10 at chip_smoke.mpnn_operands' scales, in-degree 32."""
    rng = np.random.default_rng(seed)
    h = 128
    receivers, n = graph(128, 32, 33, rng)
    senders = rng.integers(0, n, len(receivers))
    pxj = (rng.standard_normal((n, h)) * 0.5).astype(np.float32)
    pr = (rng.standard_normal((n, h)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((h, h)) * 0.15).astype(np.float32)
    b = (rng.standard_normal(h) * 0.1).astype(np.float32)
    ops = (pxj[senders], pr, receivers, n, w, b)
    want = mpnn_chain(pxj[senders].astype(np.float64), pr.astype(np.float64),
                      receivers, n, w.astype(np.float64),
                      b.astype(np.float64), None)
    return ops, want


CASES = {"pregathered": (pregathered_case, pregathered_chain,
                         chip_smoke.KERNEL_RTOL, chip_smoke.KERNEL_ATOL),
         "mpnn": (mpnn_case, mpnn_chain, chip_smoke.MPNN_RTOL,
                  chip_smoke.MPNN_ATOL)}


@pytest.mark.parametrize("path", sorted(CASES))
def test_three_tf32_products_lie_well_inside_the_kernel_tolerance(path):
    case, chain, rtol, atol = CASES[path]
    ops, want = case(seed=1)
    share = share_of_bound(chain(*ops, three_products), want, rtol, atol)
    assert share <= 0.25, share
    # within a few times plain f32 products
    f32 = share_of_bound(chain(*ops, lambda a, b: (a @ b).astype(np.float32)),
                         want, rtol, atol)
    assert share <= 2 * f32, (share, f32)


@pytest.mark.parametrize("path", sorted(CASES))
def test_one_tf32_product_lies_outside_the_kernel_tolerance(path):
    case, chain, rtol, atol = CASES[path]
    ops, want = case(seed=1)
    three = share_of_bound(chain(*ops, three_products), want, rtol, atol)
    one = share_of_bound(chain(*ops, one_product), want, rtol, atol)
    assert one > 10, one
    assert one > 100 * three, (one, three)
