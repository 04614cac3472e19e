"""The bf16 GraphNet forwards (#8 fold, #2 pre-gathered and #6 pe) at width
64 ((32, 64, 32) / (64, 32)) and width 128 ((128, 128, 128) / (128, 128))
as their warpgroup kernels compute them, on the CPU.

``fwd::wgmma_fwd_kernel`` of ``csrc/fused_edge_tail_agg_bf16.cu`` (two
blocks an SM) and of ``csrc/fused_edge_tail_agg_bf16_w128.cu`` (one block
an SM) runs block b over the tiles [b T / B, (b + 1) T / B) of 64 CSR
edges; its two warpgroups each walk half of them (the first the first
half, rounded up) with their own tiles, named barriers and index slots,
every weight resident once in shared memory; each product is a ``wgmma``
with A from registers along the chain; LayerNorm runs in the accumulator
layout; bf16(y) goes to the warpgroup's tile and the receiver sums are
one more product of it, D = S . Y with S the tile's run matrix
(``wg::run_matrix``, ``wg::store_runs``), whose partial rows a second
launch adds.  No card is needed for three things it rests on:

(a) The walk: every tile is walked once, by one warpgroup, in order within
    its range, at every path graph's tile count and at E = 1, a short last
    tile and a warpgroup without a tile; and the receiver sums, emulated
    from the kernel's index arithmetic (each warpgroup's first tile's
    receivers by a full search, the next from the last receiver of the one
    before; the runs' 0/1 matrix S and D = S . Y; the partial rows of the
    receivers that cross a tile and their sum in tile order) equal the
    exact sums on integer rows, with receivers across tiles, warpgroups
    and blocks; and S's register fragments hold S.

(b) The shared-memory layouts at both widths for each entry and L1 = 0..3
    (every tile on a 1,024-byte boundary; two blocks an SM at width 64 and
    one at width 128 under 232,448 bytes), and the addresses the products
    read: the width-128 tiles stored as two 64-column halves of 128-byte
    rows in the 128-byte swizzle, read back through an m64n128k16
    descriptor (MN-major B: LBO from one half to the other; K-major A: the
    k-step's start moved into the second half), the descriptor's fields
    holding the kernel's offsets (the y tile too, as S . Y's B), and the y
    tiles' stores free of bank conflicts.

(c) The chain in the accumulator layout's order and at its rounding points
    (the accumulators started at the bias, or the fold's b_e + (pxj[s] +
    pxi[i]); bias, relu and the bf16 repack into the next product's A
    fragments; LayerNorm's statistics by the four threads of a quad; the
    receiver sums of (a)), against the bf16 plain versions
    (``fused_edge_tail_agg_bf16_plain``, ``_pregathered_bf16_plain`` and
    ``_pe_bf16_plain``) at both widths and L1 = 0..3, within
    ``chip_smoke.py``'s bf16 forward tolerance (``compare_bf16``: 1e-2
    |want| + 2e-2 elementwise and 1e-3 relative L2).

The emulations are this test's, not code of the package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from magnet_tpu_torch.time_fwd import operands as c_operands  # noqa: E402
from magnet_tpu_torch.time_fwd import to_bf16  # noqa: E402
from test_torch_bwd64_bf16 import at, ranges, swz  # noqa: E402
from test_torch_fold_tiles import warp_receiver  # noqa: E402

TE = 64                # edges a tile (kTE)
SMS = 132              # an H100's SMs
SMEM_OPTIN = 232_448   # an H100 block's shared memory, opt-in
SMEM_SM = 233_472      # an H100 SM's shared memory (1,024 reserved a block)
#: blocks an SM of each width's forward
PER_SM = {64: 2, 128: 1}
WIDTHS = {64: {"fold": (32, 64, 32), "pe": (64, 64, 32),
               "pregathered": (64, 64, 32)},
          128: {e: (128, 128, 128) for e in ("fold", "pe", "pregathered")}}
ENTRIES = ("fold", "pe", "pregathered")
#: edges of the main paths' graphs: MAgNet[CNN] 1D eval and training, 2D
#: eval and training (32 samples), MAgNet[GNN] eval and training
PATH_EDGES = {"cnn_1d_eval": 186_624, "cnn_1d_train": 67_680,
              "cnn_2d_eval": 647_664, "cnn_2d_train_b32": 299_894,
              "gnn_eval": 84_256, "gnn_train": 67_572}


# ---- (a) the walk and the receiver sums -----------------------------------

def group_ranges(n_edges, width, cap=None):
    """Every warpgroup's [t_beg, t_end) of a call over n_edges: the grid's
    blocks, min(T, cap), cap the blocks the card holds at once."""
    n_tiles = -(-n_edges // TE)
    cap = SMS * PER_SM[width] if cap is None else cap
    return [g for pair in ranges(n_tiles, cap) for g in pair]


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("n_edges", [1, 63, 64, 65, 2 * TE * SMS + 1,
                                     *PATH_EDGES.values()])
def test_walk_covers_every_tile_once_in_order(width, n_edges):
    n_tiles = -(-n_edges // TE)
    seen = []
    for t_beg, t_end in group_ranges(n_edges, width):
        assert 0 <= t_beg <= t_end <= n_tiles
        seen += list(range(t_beg, t_end))
    assert seen == list(range(n_tiles))  # once each, in order
    groups = group_ranges(n_edges, width)
    grid = min(n_tiles, SMS * PER_SM[width])
    assert len(groups) == 2 * grid
    # the block's first warpgroup takes the first half, rounded up
    for (a0, a1), (b0, b1) in zip(groups[::2], groups[1::2]):
        assert a1 == b0 and 0 <= (a1 - a0) - (b1 - b0) <= 1
    if n_tiles < 2 * grid:  # E = 1, 63, 64, 65: some warpgroup walks none
        assert any(t0 == t1 for t0, t1 in groups)


def tile_receivers(rowptr, t_beg, t_end, n_edges):
    """The receivers of each tile of a warpgroup's range as the kernel finds
    them: the first tile's by a full search (tile_indices), each next one's
    from the last receiver of the tile before (IndexLoad); zero past the
    edge count."""
    out, hint = {}, -1
    for tile in range(t_beg, t_end):
        rcv = np.zeros(TE, np.int64)
        for half in range(2):
            base = tile * TE + 32 * half
            n_valid = min(32, n_edges - base)
            if n_valid > 0:
                r = warp_receiver(rowptr, base, n_valid,
                                  hint if tile > t_beg else -1)
                rcv[32 * half:32 * half + n_valid] = r[:n_valid]
        n_valid = min(TE, n_edges - tile * TE)
        hint = int(rcv[n_valid - 1])
        out[tile] = rcv
    return out


def run_starts(rcv, n_valid):
    """wg::run_starts: bit e (0 < e < n_valid) where edge e starts a run."""
    bits = 0
    for e in range(1, n_valid):
        if rcv[e] != rcv[e - 1]:
            bits |= 1 << e
    return bits


def run_of(starts, e):
    """The run of edge e: the run starts at or before it."""
    return bin((starts << (63 - e)) & (2 ** 64 - 1)).count("1")


def run_first(starts, run):
    """wg::run_first: the run-th start (0 for run 0)."""
    if run == 0:
        return 0
    for _ in range(run - 1):
        starts &= starts - 1
    return (starts & -starts).bit_length() - 1


def run_bounds(starts, run, n_valid):
    """wg::run_matrix's [lo, hi) of a row: the run's first edge and the
    next start (n_valid for the last run; empty past the runs)."""
    n_runs = bin(starts).count("1") + 1
    if run >= n_runs:
        return 64, 64
    lo = run_first(starts, run)
    after = starts & ~((2 << lo) - 1) if lo < 63 else 0
    return lo, ((after & -after).bit_length() - 1 if after else n_valid)


def run_matrix(starts, n_valid):
    """S (64 x 64) of wg::run_matrix: S[R][e] = 1 where edge e < n_valid
    lies in run R."""
    s = np.zeros((TE, TE), np.float32)
    for e in range(n_valid):
        s[run_of(starts, e), e] = 1.0
    return s


def tile_runs(y, rcv, rowptr, n_edges, tile, n_valid, out, part):
    """One tile's receiver sums as the kernel forms them: D = S . Y in f32
    (the runs' sums of the bf16 rows y, (TE, C)), each run's row of D to
    out, or to a partial row where the run crosses the tile
    (wg::store_runs, with the row starts of csr_tile::edge_ends)."""
    starts = run_starts(rcv, n_valid)
    d = run_matrix(starts, n_valid) @ y
    n_runs, base = bin(starts).count("1") + 1, tile * TE
    first_start, last_end = rowptr[rcv[0]], rowptr[rcv[n_valid - 1] + 1]
    for run in range(n_runs):
        begins = run != 0 or first_start >= base
        ends = run != n_runs - 1 or min(last_end, n_edges) <= base + TE
        if begins and ends:
            out[rcv[run_first(starts, run)]] = d[run]
        else:
            part[2 * tile + (1 if begins else 0)] = d[run]


def forward_sums(y, rowptr, width, cap=None):
    """out (N, C) f32 of the rows y (E, C) as a call forms it: each
    warpgroup's tiles (tile_runs), then cross_tile_sum_kernel's sum of the
    partial rows in tile order."""
    n_edges, c_width = y.shape
    n = len(rowptr) - 1
    n_tiles = -(-n_edges // TE)
    out = np.zeros((n, c_width), np.float32)
    part = np.full((2 * n_tiles, c_width), np.nan, np.float32)
    for t_beg, t_end in group_ranges(n_edges, width, cap):
        for tile, rcv in tile_receivers(rowptr, t_beg, t_end,
                                        n_edges).items():
            n_valid = min(TE, n_edges - tile * TE)
            rows = np.zeros((TE, c_width), np.float32)
            rows[:n_valid] = y[tile * TE:tile * TE + n_valid]
            tile_runs(rows, rcv, rowptr, n_edges, tile, n_valid, out, part)
    for b in range(n_tiles - 1):  # cross_tile_sum_kernel, block b
        e = (b + 1) * TE
        r = int(np.searchsorted(rowptr, e, side="right")) - 1
        beg = rowptr[r]
        if beg >= e or beg < e - TE:
            continue
        t0, t1 = beg // TE, (min(rowptr[r + 1], n_edges) - 1) // TE
        s = part[2 * t0 + 1]
        for t in range(t0 + 1, t1 + 1):
            s = (s + part[2 * t]).astype(np.float32)
        out[r] = s
    return out


def graphs():
    return {"small_line": chip_smoke.small_line_graph(),
            "one_edge": chip_smoke.one_edge_graph(),
            "tiles": chip_smoke.tile_edges_graph(TE, seed=5)}


@pytest.mark.parametrize("cap", [1, 3, None])
@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("name", ["small_line", "one_edge", "tiles"])
def test_receiver_sums_are_exact_on_integer_rows(name, width, cap):
    """Integer rows sum exactly in f32 in any order: the kernel's runs, its
    product S . Y, partial rows and their sum must give every receiver its
    edges' sum, degree-0 receivers nothing.  cap 1 and 3: few blocks, so
    each warpgroup walks several tiles and receivers cross warpgroups and
    blocks; None: the card's grid (most warpgroups one tile or none)."""
    graph = graphs()[name]
    rowptr = graph.rowptr.numpy().astype(np.int64)
    c_width = 32 if width == 64 else 128
    rng = np.random.default_rng(len(rowptr) + width)
    y = rng.integers(-8, 9, (graph.n_edge, c_width)).astype(np.float32)
    got = forward_sums(y, rowptr, width, cap)
    receivers = np.repeat(np.arange(len(rowptr) - 1), np.diff(rowptr))
    want = np.zeros_like(got)
    np.add.at(want, receivers, y)
    np.testing.assert_array_equal(got, want)
    if name == "tiles":  # receiver 3 spans four tiles (partial rows)
        assert np.diff(rowptr)[3] == 3 * TE + 7


# ---- (b) layouts, swizzles and descriptors ---------------------------------

def round_up(x, m):
    return -(-x // m) * m


def layout64(entry, l1):
    """fwd::Layout<E> of the width-64 source: (bytes, tiles' offsets)."""
    fold, j = entry == "fold", entry != "pregathered"
    tile_h, tile_c = TE * 64 * 2, TE * 32 * 2
    src = 0
    pxj = src + (tile_c if fold else tile_h)
    pxi = pxj + j * tile_h
    y = pxi + tile_h
    idx = y + tile_c
    group = round_up(idx + 4 * TE * 4, 1024)
    we = 2 * group
    wo = we + fold * 32 * 64 * 2
    wr = wo + 64 * 32 * 2
    vec = wr + l1 * 64 * 64 * 2
    nbytes = vec + (fold * 64 + 3 * 32 + l1 * 64) * 4 + 1024
    tiles = {"we": we, "wo": wo, **{f"w{k + 1}": wr + k * 8192
                                    for k in range(l1)},
             **{f"group{q}_{k}": q * group + v for q in range(2)
                for k, v in (("src", src), ("pxj", pxj), ("pxi", pxi),
                             ("y", y))}}
    return nbytes, tiles


def layout128(entry, l1):
    """fwd::Layout<E> of the width-128 source: (bytes, tiles' offsets)."""
    fold = entry == "fold"
    tile, weight = TE * 256, 128 * 256
    y = tile
    group = round_up(y + tile + 4 * TE * 4, 1024)
    we = 2 * group
    wo = we + fold * weight
    wr = wo + weight
    nbytes = wr + l1 * weight + 1024
    tiles = {"we": we, "wo": wo, **{f"w{k + 1}": wr + k * weight
                                    for k in range(l1)},
             **{f"group{q}_{k}": q * group + v for q in range(2)
                for k, v in (("src", 0), ("y", y))}}
    return nbytes, tiles


@pytest.mark.parametrize("l1", range(4))
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("width", [64, 128])
def test_layout_fits_and_aligns(width, entry, l1):
    nbytes, tiles = (layout64 if width == 64 else layout128)(entry, l1)
    assert nbytes <= SMEM_OPTIN
    # the blocks an SM, the 1,024 bytes each reserves included
    assert PER_SM[width] * (nbytes + 1024) <= SMEM_SM
    assert all(v % 1024 == 0 for v in tiles.values())
    if width == 128:  # two warpgroups' tiles, then the weights
        assert tiles["we"] == 2 * (2 * TE * 256 + 1024)
    if l1 == 3:
        assert nbytes == {64: {"fold": 86_400, "pe": 90_240,
                               "pregathered": 73_856},
                          128: {"fold": 232_448, "pe": 199_680,
                                "pregathered": 199_680}}[width][entry]


def at2(rows, r, c):
    """fwd::at2<R>: (r, c) of a bf16 tile of 128 columns stored as two
    64-column halves of ``rows`` rows of 128 bytes (the 128-byte swizzle)."""
    return (c // 64) * rows * 128 + at(r, c % 64, 128)


@pytest.mark.parametrize("rows", [TE, 128])
def test_halves_are_a_bijection_that_keeps_chunks_whole(rows):
    offs = np.array([[at2(rows, r, c) for c in range(128)]
                     for r in range(rows)])
    assert sorted(offs.ravel()) == list(range(0, rows * 256, 2))
    assert ((offs[:, ::8] % 16) == 0).all()  # 16-byte pieces (cp.async)
    assert (np.diff(offs.reshape(rows, 16, 8), axis=2) == 2).all()
    # stage_w128's piece k of row r lands where at2 puts column 8 k
    for r in range(0, rows, 7):
        for k in range(16):
            dst = (k >> 3) * rows * 128 + swz(r * 128 + (k & 7) * 16, 128)
            assert dst == at2(rows, r, 8 * k)


def desc_fields(start, lbo, row_bytes=128):
    """wg::desc's 64-bit value and its fields read back: (start, LBO, SBO,
    layout), in bytes."""
    layout = 1 if row_bytes == 128 else 2
    d = (((start & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16)
         | ((8 * row_bytes >> 4) << 32) | (layout << 62))
    return ((d & 0x3FFF) << 4, ((d >> 16) & 0x3FFF) << 4,
            ((d >> 32) & 0x3FFF) << 4, d >> 62)


def n128_b_address(j, n, k, lbo, sbo=1024):
    """The unswizzled address of element (k, n) of k-step j of an MN-major
    m64n128k16 B (PTX / CuTe's canonical 128-byte-swizzle MN-major layout:
    ((8 elements, 8 chunks, halves), (8 rows, row groups)) with strides
    ((2, 16, LBO), (128, SBO))), the start moved 16 rows a k-step."""
    return 16 * 128 * j + (n // 64) * lbo + (k // 8) * sbo + (k % 8) * 128 \
        + 2 * (n % 64)


def n128_a_address(j, m, k, half):
    """The unswizzled address of element (m, k) of k-step j of product_w128's
    K-major A: the start 32 bytes a k-step along a half's row, k-steps 4-7
    in the second half (``half`` bytes on)."""
    return (j // 4) * half + 32 * (j % 4) + (m // 8) * 1024 + (m % 8) * 128 \
        + 2 * k


def test_n128_descriptors_read_the_elements_where_the_kernel_stores_them():
    weight_half, tile_half = 128 * 128, TE * 128
    # the descriptor's fields hold the kernel's offsets (14 bits of 16 B)
    base = 67_584  # a weight's offset in the width-128 layout
    assert desc_fields(base, weight_half) == (base, weight_half, 1024, 1)
    # B: W (K = 128 rows, N = 128), h . W and y's products
    got = [swz(n128_b_address(j, n, k, weight_half), 128)
           for j in range(8) for n in range(128) for k in range(16)]
    want = [at2(128, 16 * j + k, n)
            for j in range(8) for n in range(128) for k in range(16)]
    assert got == want
    # B: the y tile (K = 64 edges, N = 128) of the receiver sums' S . Y
    got = [swz(n128_b_address(j, n, k, tile_half), 128)
           for j in range(4) for n in range(128) for k in range(16)]
    want = [at2(TE, 16 * j + k, n)
            for j in range(4) for n in range(128) for k in range(16)]
    assert got == want
    # A: the fold's e0 tile (M = 64 rows, K = 128), K-major
    got = [swz(n128_a_address(j, m, k, tile_half), 128)
           for j in range(8) for m in range(TE) for k in range(16)]
    want = [at2(TE, m, 16 * j + k)
            for j in range(8) for m in range(TE) for k in range(16)]
    assert got == want


def acc_place(t, i):
    """wgmma.cuh: thread t's accumulator d[i] at (row, column)."""
    w, lane = t // 32, t % 32
    return (16 * w + lane // 4 + 8 * ((i // 2) % 2),
            8 * (i // 4) + 2 * (lane % 4) + i % 2)


def a_place(t, j, q):
    """wgmma.cuh: register A fragment a[j][q] of thread t at (row, first of
    its two columns)."""
    w, lane = t // 32, t % 32
    return 16 * w + lane // 4 + 8 * (q % 2), 16 * j + 8 * (q // 2) + \
        2 * (lane % 4)


@pytest.mark.parametrize("n_cols", [32, 64, 128])
def test_repacked_accumulator_is_the_next_products_a(n_cols):
    """relu_pack: the pair d[i], d[i + 1] becomes a[i / 8][(i / 2) % 4],
    the A fragment of the same rows and columns (K = n_cols)."""
    for t in range(128):
        for i in range(0, n_cols // 2, 2):
            assert acc_place(t, i) == a_place(t, i // 8, (i // 2) % 4)
            assert acc_place(t, i + 1)[1] == acc_place(t, i)[1] + 1


@pytest.mark.parametrize("width", [64, 128])
def test_y_tile_stores_are_free_of_bank_conflicts(width):
    """The LayerNorm epilogue's 32-bit stores of a warp (one accumulator
    pair a lane) into the y tile (width 64: 64-byte rows in the 64-byte
    swizzle; width 128: two 64-column halves, at2) touch 32 distinct
    banks."""
    cols = 32 if width == 64 else 128

    def offset(r, c):
        return at(r, c, 64) if width == 64 else at2(TE, r, c)

    offs = sorted(offset(r, c) for r in range(TE) for c in range(cols))
    assert offs == list(range(0, TE * cols * 2, 2))
    for i in range(0, cols // 2, 2):  # a store instruction of warp 0
        banks = {(offset(*acc_place(t, i)) // 4) % 32 for t in range(32)}
        assert len(banks) == 32


#: receivers of a tile's 64 edges: one receiver, 64 of one edge, runs of
#: random lengths, a short last tile
RUN_CASES = {"one": [7] * TE, "distinct": list(range(TE)),
             "random": list(np.repeat(np.arange(12), [1, 9, 3, 2, 17, 1, 1,
                                                      8, 5, 4, 9, 4])),
             "short": [3, 3, 4, 9, 9]}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_run_matrix_sums_each_run(case):
    """wg::run_starts / run_first / run_matrix: S . Y is each run's sum, a
    run's first edge has its receiver, every edge one run; and the A
    fragments (a[j][q], the pairs of mma_rs_n64's layout), formed from each
    row's [first edge, next start), hold S."""
    rcv = np.array(RUN_CASES[case] + [0] * (TE - len(RUN_CASES[case])))
    n_valid = len(RUN_CASES[case])
    starts = run_starts(rcv, n_valid)
    n_runs = bin(starts).count("1") + 1
    assert n_runs == 1 + int((np.diff(rcv[:n_valid]) != 0).sum())
    s = run_matrix(starts, n_valid)
    assert (s.sum(0)[:n_valid] == 1).all() and (s.sum(0)[n_valid:] == 0).all()
    y = np.random.default_rng(1).integers(-9, 9, (TE, 32)).astype(np.float32)
    d = s @ y
    for run in range(n_runs):
        first = run_first(starts, run)
        edges = [e for e in range(n_valid) if run_of(starts, e) == run]
        assert edges[0] == first and len(set(rcv[edges])) == 1
        np.testing.assert_array_equal(d[run], y[edges].sum(0))
    assert (d[n_runs:] == 0).all()
    for t in range(128):  # the fragments wg::run_matrix builds
        for j in range(4):
            for q in range(4):
                r, e = a_place(t, j, q)
                lo, hi = run_bounds(starts, r, n_valid)
                got = [float(lo <= e < hi), float(lo <= e + 1 < hi)]
                assert got == [s[r, e], s[r, e + 1]]


# ---- (c) the chain in the accumulator layout's order ----------------------

def bf16(a):
    """a rounded to bf16 (to nearest even), kept in float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .bfloat16().float().numpy()


def quad_sum(parts):
    """A row's sum over the four threads of its quad: xor 1 then xor 2."""
    s0, s1, s2, s3 = (np.float32(p) for p in parts)
    return np.float32(np.float32(s0 + s1) + np.float32(s2 + s3))


def layer_norm_rows(y, ln_s, ln_b):
    """bf16(LayerNorm(y)) as the epilogue forms it: thread t of a quad sums
    its columns 8 j + 2 t, + 1 (j = 0, 1, ...), in that order (width 128:
    each pair first); the quad's sums; the two-pass variance by fmaf."""
    n_cols = y.shape[1]
    out = np.empty_like(y)
    for e in range(y.shape[0]):
        v = y[e].astype(np.float32)
        cols = [[8 * j + 2 * t + p for j in range(n_cols // 8)
                 for p in (0, 1)] for t in range(4)]
        mus = []
        for t in range(4):
            s = np.float32(0)
            if n_cols == 128:
                for j in range(n_cols // 8):
                    s = np.float32(s + np.float32(v[cols[t][2 * j]]
                                                  + v[cols[t][2 * j + 1]]))
            else:
                for c in cols[t]:
                    s = np.float32(s + v[c])
            mus.append(s)
        mu = np.float32(quad_sum(mus) * np.float32(1.0 / n_cols))
        vs = []
        for t in range(4):
            s = np.float32(0)
            for c in cols[t]:
                d = np.float64(np.float32(v[c] - mu))
                s = np.float32(d * d + np.float64(s))  # fmaf
            vs.append(s)
        var = np.float32(quad_sum(vs) * np.float32(1.0 / n_cols))
        rstd = np.float32(1.0 / np.sqrt(np.float64(np.float32(var + 1e-5))))
        out[e] = (((v - mu) * rstd).astype(np.float32) * ln_s
                  + ln_b).astype(np.float32)
    return bf16(out)


def kernel_fwd(entry, ops, width, cap):
    """The warpgroup forward of ``entry`` on its wrapper's operands ``ops``
    (bf16, as the plain version takes them), as the kernel rounds: (N, C)
    f32."""
    f = [t.float().numpy() if t.is_floating_point() else t.numpy()
         for t in ops]
    if entry == "fold":
        e0, we, be, pxj, pxi, senders, rowptr = f[:7]
        tail = f[7:]
    elif entry == "pregathered":
        h0, pxi, rowptr = f[:3]
        tail = f[3:]
    else:
        pe, pxj, pxi, senders, rowptr = f[:5]
        tail = f[7:]
    w_rest, b_rest, w_out, b_out, ln_s, ln_b = tail
    rowptr = rowptr.astype(np.int64)
    receivers = np.repeat(np.arange(len(rowptr) - 1), np.diff(rowptr))
    if entry == "fold":
        # the accumulators start at b_e + (pxj[s] + pxi[i]); the product
        # adds e0 . W_e
        z = (be + (pxj[senders] + pxi[receivers])).astype(np.float32)
        z = (z + (e0 @ we).astype(np.float32)).astype(np.float32)
        h = bf16(np.maximum(z, 0))
    elif entry == "pregathered":
        h = bf16(np.maximum((h0 + pxi[receivers]).astype(np.float32), 0))
    else:
        z = ((pe + pxj[senders]).astype(np.float32) + pxi[receivers])
        h = bf16(np.maximum(z.astype(np.float32), 0))
    for k in range(w_rest.shape[0]):  # bias first, then the product
        h = bf16(np.maximum((b_rest[k] + (h @ w_rest[k]).astype(np.float32))
                            .astype(np.float32), 0))
    y = (b_out + (h @ w_out).astype(np.float32)).astype(np.float32)
    return forward_sums(layer_norm_rows(y, ln_s, ln_b), rowptr, width, cap)


def entry_operands(entry, graph, width, l1, seed):
    ce, h, c = WIDTHS[width][entry]
    if entry == "fold":
        return to_bf16(chip_smoke.kernel_operands(graph, ce, h, c, l1, seed,
                                                  "cpu"))
    if entry == "pregathered":
        return to_bf16(chip_smoke.pregathered_operands(graph, h, c, l1, seed,
                                                       "cpu"))
    src, _, _, pxj, pxi, senders, rowptr, *tail = to_bf16(
        c_operands("pe", graph, h, h, c, l1, seed, "cpu"))
    return (src, pxj, pxi, senders, rowptr, graph.snd_ptr, graph.snd_perm,
            *tail)


PLAIN = {"fold": fe.fused_edge_tail_agg_bf16_plain,
         "pregathered": fe.fused_edge_tail_agg_pregathered_bf16_plain,
         "pe": fe.fused_edge_tail_agg_pe_bf16_plain}


@pytest.mark.parametrize("l1", range(4))
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("width", [64, 128])
def test_chain_in_kernel_order_matches_the_plain_version(width, entry, l1):
    """On the tile graph with a grid of 3 blocks (receivers across tiles,
    warpgroups and blocks; degree-0 receivers between them)."""
    graph = chip_smoke.tile_edges_graph(TE, seed=7)
    ops = entry_operands(entry, graph, width, l1, seed=60 + l1)
    got = torch.from_numpy(kernel_fwd(entry, ops, width, cap=3))
    want = PLAIN[entry](*ops)
    res = chip_smoke.compare_bf16(got, want)
    assert res["ok"], res
    zero = graph.degree == 0
    assert zero.any() and (got[zero] == 0).all()
