"""The width-64 bf16 GraphNet backward (#9 fold at (32, 64, 32), #3
pre-gathered and #7 pe at (64, 32)) as its warpgroup kernel computes it, on
the CPU.

``csrc/fused_edge_tail_agg_bf16.cu`` (``bwd::wgmma_bwd_kernel``) runs a call
on one block an SM, block b over the tiles [b T / B, (b + 1) T / B) of 64
CSR edges; its two warpgroups each walk half of them (the first the first
half, rounded up) with their own tiles in shared memory, one shared copy of
the weights, named barriers of their own and their weight gradients summed
in their products' accumulators (each group's sums added, group 0's then
group 1's, into the block's partial row); a second launch adds the blocks'
partial rows in block order.  No card is needed for three things it rests
on:

(a) The walk, emulated phase by phase from the kernel's index arithmetic
    (the buffers' slots, the cp.async groups and their waits, the
    warpgroup's barriers): every tile is walked once, by one warpgroup, in
    order within its range; every read finds the tile it wants, landed
    (its copy waited for before a barrier), never in a buffer that its
    phase writes or copies into; mutations of a slot fail it.  Cases: the
    path graphs' tile counts on an H100's 132 blocks, a block with one tile
    (its second warpgroup idle), E = 1 and more blocks than tiles.  The
    layout fits in 232,448 bytes (one block an SM) with every tile on a
    1,024-byte boundary, and the swizzled address map is a bijection within
    each tile that agrees with the addresses a wgmma descriptor reads (the
    K-major and MN-major forms of each operand).

(b) The weight gradients' accumulation.  A warpgroup adds every tile's dW
    products into one set of f32 accumulators (k-steps of 16 edges, as
    ``truncating_mma`` of ``tests/test_torch_fold_tiles.py`` models the
    tensor cores' truncation), over its whole range: at the 2D batch-32
    graph (4,686 tiles on 132 blocks: 18 a warpgroup) and the 1D training
    graph (1,058: 5) the result stays within a tenth of ``chip_smoke.py``'s
    ``BF16_BWD_L2`` of float64, no element outside its counted bound.

(c) The chain, in the kernel's order and at its rounding points (tile by
    tile in each warpgroup's range; the accumulators started at the bias
    (and the fold's b_e + (pxj[s] + pxi[i])); LayerNorm's backward from
    bf16(g); dW += x^T . bf16(d); da = (bf16(d) . W^T) masked by x > 0, its
    unrounded column sums the bias gradients; d_pxi by runs in each half of
    a tile; the warpgroups' sums added in order, then the blocks'), against
    the VJPs of ``fused_edge_tail_agg2rf`` (fold), ``fused_edge_tail_agg``
    (pre-gathered) and ``fused_edge_tail_agg2`` (pe, d_pxj one rounding of
    the f32 sum of dz) at (32, 64, 32) / (64, 32) in Pallas interpret mode,
    at L1 = 0, 1 and 3, within 1e-2 relative L2 a gradient (the tolerance
    of ``tests/test_torch_bf16.py``, ``tests/test_torch_bf16_2d.py`` and
    ``tests/test_torch_pe64.py``).

The emulations are this test's, not code of the package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from magnet_tpu_torch.ops import fused_edge as fe  # noqa: E402
from magnet_tpu_torch.ops.graph import csr_from_edges  # noqa: E402
from test_torch_bf16 import _pallas_grads  # noqa: E402
from test_torch_bf16_2d import _pallas_fwd_bwd  # noqa: E402
from test_torch_fold_tiles import truncating_mma, warp_receiver  # noqa: E402
from test_torch_fused_edge import _port_args, _problem  # noqa: E402
from test_torch_pe64 import _fused2_vjp, _pe_case, _port_ops  # noqa: E402

TE = 64                 # edges a tile (kTE)
CE, H, C = 32, 64, 32   # the widths of the build under test
SMS = 132               # an H100's SMs: the grid's blocks at most
SMEM_OPTIN = 232_448    # an H100 block's shared memory, opt-in
GRAD_L2 = 1e-2          # the width-64 bf16 tests' relative L2
ENTRIES = ("fold", "pe", "pregathered")
#: tiles of the main paths' graphs: MAgNet[CNN] 1D training (67,680
#: edges), 2D training batches of 32 (299,894) and 8 samples
PATH_TILES = {"cnn_1d_train": 1_058, "cnn_2d_train_b32": 4_686,
              "cnn_2d_train_b8": 1_172}


# ---- (a) the walk ----------------------------------------------------------

def ranges(n_tiles, blocks):
    """Each block's two warpgroup ranges [t_beg, t_end), as the kernel
    splits the tiles over the launch's grid (min(T, blocks) blocks)."""
    grid = min(n_tiles, blocks)
    out = []
    for b in range(grid):
        b0, b1 = b * n_tiles // grid, (b + 1) * n_tiles // grid
        mid = b0 + (b1 - b0 + 1) // 2
        out.append(((b0, mid), (mid, b1)))
    return out


class Walk:
    """One warpgroup's shared tiles as {(buffer, slot): tile}, its cp.async
    groups, its product groups and its phases (the stretches between its
    barriers): a phase's plain reads see the state before it and its plain
    writes land at its barrier; a copy lands at the barrier after a wait
    that covers its group; a product's reads last from its issue until a
    wait covers its group and a barrier follows (each warp's wait covers
    only its own part of a product).  Asserts every read finds its tile
    landed, that no phase reads a slot it writes or copies into, and that
    nothing writes a slot a product may still read."""

    def __init__(self):
        self.buf, self.groups, self.open, self.landing = {}, [], [], []
        self.reads, self.writes, self.copies = [], [], []
        self.in_flight = set()
        self.products, self.product_open, self.retiring = [], [], []

    def read(self, name, slot, tile):
        self.reads.append((name, slot, tile))

    def write(self, name, slot, tile):
        assert (name, slot) not in self._reading(), (name, slot, tile)
        self.writes.append((name, slot, tile))

    def copy(self, name, slot, tile):
        assert (name, slot) not in self._reading(), (name, slot, tile)
        self.open.append((name, slot, tile))
        self.copies.append((name, slot))

    def commit(self):
        self.groups.append(self.open)
        for name, slot, _ in self.open:
            self.in_flight.add((name, slot))
        self.open = []

    def wait(self, n):
        """cp.async.wait_group n: all but the n newest groups done."""
        done = self.groups[:len(self.groups) - n] if n else self.groups
        self.groups = self.groups[len(done):]
        self.landing += [c for group in done for c in group]

    def product(self, *reads):
        """A wgmma product reading (buffer, slot, tile) ... from shared
        memory (in place when it is issued); one from registers reads
        none."""
        for name, slot, tile in reads:
            assert (name, slot) not in self.in_flight, (name, slot, tile)
            assert self.buf.get((name, slot)) == tile, (name, slot, tile)
        self.product_open += [r[:2] for r in reads]

    def product_commit(self):
        self.products.append(self.product_open)
        self.product_open = []

    def product_wait(self, n):
        """wgmma.wait_group n: all but the n newest product groups done,
        in this warp; the slots they read stay taken until a barrier."""
        done = max(len(self.products) - n, 0)
        self.retiring += self.products[:done]
        self.products = self.products[done:]

    def _reading(self):
        return {r for group in self.products + self.retiring for r in group}

    def barrier(self):
        written = {w[:2] for w in self.writes} | set(self.copies)
        for name, slot, tile in self.reads:
            assert (name, slot) not in written, (name, slot, tile)
            assert (name, slot) not in self.in_flight, (name, slot, tile)
            assert self.buf.get((name, slot)) == tile, (name, slot, tile)
        for name, slot, tile in self.writes + self.landing:
            self.buf[(name, slot)] = tile
        for name, slot, _ in self.landing:
            self.in_flight.discard((name, slot))
        self.reads, self.writes, self.copies, self.landing = [], [], [], []
        self.retiring = []


def walk(entry, l1, t_beg, t_end, mutation=None):
    """The phases of one warpgroup's walk over [t_beg, t_end), from the
    kernel's index arithmetic and order (cur = it & 1; da_k in da((L1 - k)
    & 1); the e0 tiles double-buffered, the other rows single; the forward
    layers after the first and the data-gradient products read their A
    from registers, so they hold no tile); ``mutation`` changes one slot
    or one step.  Returns the tiles walked, in order."""
    fold, gathers = entry == "fold", entry != "pregathered"
    w = Walk()
    e0_slot = (lambda s: 0) if mutation == "one_e0_tile" else (lambda s: s)
    da_slot = (lambda a: 0) if mutation == "one_da_tile" else (lambda a: a)

    def stage_tile(tile, buf):
        w.read("idx", buf, tile)
        w.copy("e0" if fold else "src", e0_slot(buf) if fold else 0, tile)
        if gathers:
            w.copy("pxj", 0, tile)
        w.copy("pxi", 0, tile)

    def from_registers():
        w.product()
        w.product_commit()

    walked = []
    if t_beg < t_end:
        w.write("idx", 0, t_beg)    # warps 0 and 1, from no hint
        w.barrier()
        stage_tile(t_beg, 0)
        w.commit()
        w.read("idx", 0, t_beg)
        w.copy("g", 0, t_beg)
        w.commit()
        w.barrier()  # the block's, once the weights are in
    for it, tile in enumerate(range(t_beg, t_end)):
        cur, nxt, more = it & 1, (it & 1) ^ 1, tile + 1 < t_end
        w.wait(1)
        w.barrier()
        # h_0, the next tile's indices
        w.read("idx", cur, tile)
        if fold:
            w.product(("e0", e0_slot(cur), tile))
            w.product_commit()
            w.product_wait(0)
        else:
            w.read("src", 0, tile)
        if gathers:
            w.read("pxj", 0, tile)
        w.read("pxi", 0, tile)
        w.write("act", 0, tile)
        if more:
            w.write("idx", nxt, tile + 1)
        w.wait(0 if mutation != "g_unwaited" else 1)
        w.barrier()
        if more and mutation != "stage_early":
            stage_tile(tile + 1, nxt)
        w.commit()
        # the forward layers (no barrier between them) and y
        for k in range(1, l1 + 1):
            if k == 1:
                w.product(("act", 0, tile))
                w.product_commit()
            else:
                from_registers()
            w.product_wait(0)
            w.write("act", k, tile)
        if l1 == 0:
            w.product(("act", 0, tile))
            w.product_commit()
        else:
            from_registers()
        w.product_wait(0)
        # LayerNorm's backward; da_L1 from registers
        w.read("g", 0, tile)
        w.write("dy", 0, tile)
        from_registers()
        if mutation == "stage_g_early" and more:
            w.read("idx", nxt, tile + 1)
            w.copy("g", 0, tile + 1)
        w.barrier()
        if more and mutation != "stage_g_early":
            w.read("idx", nxt, tile + 1)
            w.copy("g", 0, tile + 1)
        w.commit()
        # dW_out in a group of its own; da_L1's epilogue
        w.product(("act", l1, tile), ("dy", 0, tile))
        w.product_commit()
        w.product_wait(1)
        w.read("act", l1, tile)  # the mask
        w.write("da", da_slot(0), tile)
        for k in range(l1, 0, -1):
            b = (l1 - k) & 1
            from_registers()           # da_{k-1}
            if mutation == "dw_retired_after_barrier":
                w.barrier()
                w.product_wait(1)
            else:
                w.product_wait(1)      # the dW above, retired
                w.barrier()
            w.product(("act", k - 1, tile), ("da", da_slot(b), tile))
            w.product_commit()
            w.product_wait(1)
            w.read("act", k - 1, tile)
            w.write("da", da_slot(b ^ 1), tile)
        # dz: the fold's d_e0 (registers) and dW_e, d_src, the atomics
        if fold:
            from_registers()
        w.barrier()
        w.read("da", da_slot(l1 & 1), tile)
        w.read("idx", cur, tile)
        if fold:
            w.product(("da", da_slot(l1 & 1), tile),
                      ("e0", e0_slot(cur), tile))
            w.product_commit()
            w.product_wait(1)
        if mutation == "stage_early" and more:
            stage_tile(tile + 1, nxt)
        if mutation != "no_tile_end_wait":
            w.product_wait(0)
        walked.append(tile)
    if t_beg < t_end:
        w.wait(0)
        w.barrier()
    return walked


@pytest.mark.parametrize("l1", [0, 3])
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("n_tiles", [1, 2, 131, 133, *PATH_TILES.values()])
def test_walk_visits_every_tile_once_in_order(entry, l1, n_tiles):
    seen = []
    for groups in ranges(n_tiles, SMS):
        assert groups[0][1] - groups[0][0] >= 1  # every block a tile
        for t_beg, t_end in groups:
            assert walk(entry, l1, t_beg, t_end) == list(range(t_beg, t_end))
            seen += range(t_beg, t_end)
    assert seen == list(range(n_tiles))


@pytest.mark.parametrize("mutation", ["one_e0_tile", "one_da_tile",
                                      "g_unwaited", "stage_early",
                                      "stage_g_early",
                                      "dw_retired_after_barrier",
                                      "no_tile_end_wait"])
def test_walk_fails_where_a_slot_or_a_step_is_moved(mutation):
    entry = "pe" if mutation == "no_tile_end_wait" else "fold"
    with pytest.raises(AssertionError):
        for l1 in (0, 3):
            walk(entry, l1, 0, 5, mutation)


def test_grid_gives_every_sm_work_at_the_path_graphs():
    for tiles in PATH_TILES.values():
        groups = ranges(tiles, SMS)
        assert len(groups) == SMS
        sizes = [g[0][1] - g[0][0] + g[1][1] - g[1][0] for g in groups]
        assert max(sizes) - min(sizes) <= 1
        halves = [g[1][1] - g[1][0] for g in groups]
        assert min(halves) >= 1  # both warpgroups walk
    one = ranges(1, SMS)
    assert one == [((0, 1), (1, 1))]  # E = 1: the second warpgroup idle


def layout(entry, l1):
    """bwd::Layout<L1, E>: (bytes, the tiles' offsets, a warpgroup's
    index slots' offset in its part)."""
    fold, j = entry == "fold", entry != "pregathered"
    tile_h, tile_c, tile_g = TE * H * 2, TE * C * 2, TE * C * 4
    wr = fold * CE * H * 2
    wo = wr + l1 * H * H * 2
    group = wo + H * C * 2
    act = 0
    da = act + (l1 + 1) * tile_h
    dy = da + 2 * tile_h
    src = dy + tile_c
    pxj = src + (2 * tile_c if fold else tile_h)
    pxi = pxj + j * tile_h
    g = pxi + tile_h
    idx = g + tile_g
    sums = idx + 4 * TE * 4
    n_sums = fold * H + l1 * H + 3 * C
    group_bytes = -(-(sums + 4 * n_sums * 4) // 1024) * 1024
    vec = group + 2 * group_bytes
    nbytes = vec + (fold * H + l1 * H + 2 * C) * 4 + 1024
    tiles = {"we": 0, "wr": wr, "wo": wo, **{
        f"group{q}_{k}": group + q * group_bytes + v
        for q in range(2) for k, v in (("act", act), ("da", da), ("dy", dy),
                                       ("src", src), ("pxj", pxj),
                                       ("pxi", pxi), ("g", g))}}
    return nbytes, tiles, idx


@pytest.mark.parametrize("l1", range(4))
@pytest.mark.parametrize("entry", ENTRIES)
def test_layout_fits_one_block_an_sm(entry, l1):
    nbytes, tiles, idx = layout(entry, l1)
    assert nbytes <= SMEM_OPTIN
    assert 2 * nbytes > SMEM_OPTIN or l1 < 3  # one block an SM at L1 = 3
    assert all(v % 1024 == 0 for v in tiles.values())
    # warpgroup 0's tiles hold its weight gradients' slots at the end
    assert (32 * max(l1, 1) + 32) * 128 * 4 <= idx
    if l1 == 3:
        assert nbytes == {"fold": 221_440, "pe": 215_040,
                          "pregathered": 198_656}[entry]


def swz(o, row_bytes):
    """wg::swz: the 16-byte chunk XOR the row's place in its 8-row (128)
    or 2-row-pair (64) swizzle atom."""
    mask = 0x70 if row_bytes == 128 else 0x30
    return o ^ ((o >> 3) & mask)


def at(row, col, row_bytes):
    return swz(row * row_bytes + 2 * col, row_bytes)


@pytest.mark.parametrize("row_bytes", [64, 128])
def test_swizzle_is_a_bijection_that_keeps_chunks_whole(row_bytes):
    cols = row_bytes // 2
    offs = np.array([[at(r, c, row_bytes) for c in range(cols)]
                     for r in range(TE)])
    assert sorted(offs.ravel()) == list(range(0, TE * row_bytes, 2))
    # a 16-byte piece of a row stays whole (cp.async, 16-byte loads)
    assert ((offs[:, ::8] % 16) == 0).all()
    assert (np.diff(offs.reshape(TE, cols // 8, 8), axis=2) == 2).all()
    # a column piece's 8 rows fall on distinct 16-byte bank groups: a
    # warp's access in the accumulator layout is free of bank conflicts
    for c in range(0, cols, 8):
        banks = {(at(r, c, row_bytes) // 16) % 8 for r in range(8)}
        assert len(banks) == 8


def descriptor_address(row_bytes, mn_major, j, mn, k):
    """The unswizzled byte address a wgmma descriptor of wgmma.cuh
    (SBO = 8 rows, the k-step's start moved as desc_step moves it) gives
    element (mn, k) of k-step j of an operand, before the hardware's
    swizzle of the address bits: K-major rows are the M (or N) index,
    MN-major rows the K index (one swizzle atom wide)."""
    sbo = 8 * row_bytes
    if mn_major:
        start = 16 * row_bytes * j
        return start + (k // 8) * sbo + (k % 8) * row_bytes + 2 * mn
    start = 32 * j
    return start + (mn // 8) * sbo + (mn % 8) * row_bytes + 2 * k


@pytest.mark.parametrize("row_bytes", [64, 128])
@pytest.mark.parametrize("mn_major", [False, True])
def test_descriptors_read_the_elements_where_the_kernel_stores_them(
        row_bytes, mn_major):
    width = row_bytes // 2  # elements a row
    rows = TE
    if mn_major:   # (K rows of `width` MN elements): k-steps over the rows
        pairs = [(j, mn, k) for j in range(rows // 16) for mn in range(width)
                 for k in range(16)]
        want = [at(16 * j + k, mn, row_bytes) for j, mn, k in pairs]
    else:          # (M rows of `width` K elements)
        pairs = [(j, mn, k) for j in range(width // 16) for mn in range(rows)
                 for k in range(16)]
        want = [at(mn, 16 * j + k, row_bytes) for j, mn, k in pairs]
    got = [swz(descriptor_address(row_bytes, mn_major, j, mn, k), row_bytes)
           for j, mn, k in pairs]
    assert got == want


# ---- (b) the weight gradients' accumulation --------------------------------

def bf16(a):
    """a rounded to bf16, kept in float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .bfloat16().float().numpy()


def running_dw(x, d):
    """x^T . d as a warpgroup's accumulators form it: k-steps of 16 edges,
    each step's products added to the f32 accumulator by
    ``truncating_mma``, one accumulator over every edge of the range."""
    acc = np.zeros((x.shape[1], d.shape[1]), np.float32)
    for k0 in range(0, len(x), 16):
        acc = truncating_mma(acc, x[k0:k0 + 16].T, d[k0:k0 + 16])
    return acc


def dw_errors(edges, n_out, seed=0):
    """A warpgroup's dW (H x n_out) over ``edges`` edges against float64:
    its relative L2 and the elements outside chip_smoke's counted bound;
    operands at the kernel's scales (bf16 relu activations, half zero, and
    bf16 gradients of one sign per column's mean)."""
    rng = np.random.default_rng(seed)
    x = bf16(np.maximum(rng.standard_normal((edges, H)) * 0.5, 0))
    d = bf16((rng.standard_normal((edges, n_out)) + 0.5) * 0.05)
    want = x.astype(np.float64).T @ d.astype(np.float64)
    got = running_dw(x, d).astype(np.float64)
    err = np.abs(got - want)
    bound = chip_smoke.BF16_RTOL * np.abs(want) \
        + chip_smoke.BF16_BWD_ATOL_REL * np.abs(want).max()
    return (np.linalg.norm(got - want) / np.linalg.norm(want),
            int((err > bound).sum()))


@pytest.mark.parametrize("n_out", [H, C])
@pytest.mark.parametrize("path", ["cnn_2d_train_b32", "cnn_1d_train"])
def test_one_running_accumulator_lies_inside_the_bf16_tolerances(path,
                                                                 n_out):
    longest = max(t1 - t0 for groups in ranges(PATH_TILES[path], SMS)
                  for t0, t1 in groups)
    assert longest == {"cnn_2d_train_b32": 18, "cnn_1d_train": 5}[path]
    l2, outside = dw_errors(longest * TE, n_out)
    assert outside == 0
    assert 0 < l2 < chip_smoke.BF16_BWD_L2 / 10, l2


# ---- (c) the chain in the kernel's order -----------------------------------

def _rnd(t):
    return t.bfloat16().float()


def kernel_bwd(entry, src, we, be, pxj, pxi, senders, rowptr, w_rest,
               b_rest, w_out, b_out, ln_s, g, blocks):
    """The kernel's gradients, tile by tile in each warpgroup's range on a
    grid of ``blocks``: the forward recomputed from the accumulators'
    starts, LayerNorm's backward to bf16(dy), then from the output layer
    back: dW += x^T . bf16(d), da = (bf16(d) . W^T) masked by x > 0, its
    column sums the bias gradient of the layer below; the fold's dW_e,
    d_e0 = bf16(bf16(dz) . W_e^T) and d_pxj the f32 sums of bf16(dz); the
    pe's d_pxj one rounding of the f32 sums of dz; d_pxi the f32 sums of
    bf16(dz) by runs in each half of a tile.  Each warpgroup's sums in
    f32, added in order (warpgroup 0 + 1), then the blocks' in order.
    Returns the wrapper's gradients in their dtypes."""
    f = torch.Tensor.float
    fold = entry == "fold"
    n, E, l1 = rowptr.numel() - 1, src.shape[0], w_rest.shape[0]
    deg = (rowptr[1:] - rowptr[:-1]).long()
    receivers = torch.repeat_interleave(torch.arange(n), deg)
    d_src = torch.zeros(E, src.shape[1])
    d_pxi = torch.zeros(n, H)
    d_pxj = torch.zeros(n, H)
    sizes = (CE * H if fold else 0, H, l1 * H * H, l1 * H, H * C, C, C, C)
    total = None
    for groups in ranges(-(-E // TE), blocks):
        block = None
        for t_beg, t_end in groups:
            dwe, dbe = torch.zeros(CE, H), torch.zeros(H)
            dwr, dbr = torch.zeros(l1, H, H), torch.zeros(l1, H)
            dwo, dbo = torch.zeros(H, C), torch.zeros(C)
            dls, dlb = torch.zeros(C), torch.zeros(C)
            for t in range(t_beg, t_end):
                e = torch.arange(t * TE, min(E, (t + 1) * TE))
                r = receivers[e]
                if fold:
                    s = senders[e].long()
                    z = (f(be) + (f(pxj)[s] + f(pxi)[r])) + f(src[e]) @ f(we)
                elif entry == "pe":
                    s = senders[e].long()
                    z = (f(src[e]) + f(pxj)[s]) + f(pxi)[r]
                else:
                    z = f(src[e]) + f(pxi)[r]
                hs = [_rnd(torch.relu(z))]
                for k in range(l1):
                    hs.append(_rnd(torch.relu(f(b_rest[k])
                                              + hs[-1] @ f(w_rest[k]))))
                y = f(b_out) + hs[-1] @ f(w_out)
                mu = y.mean(1, keepdim=True)
                var = (y - mu).pow(2).mean(1, keepdim=True)
                rstd = torch.rsqrt(var + fe.LN_EPS)
                xhat = (y - mu) * rstd
                gv = _rnd(g[r])
                dx = gv * ln_s
                dy = rstd * (dx - dx.mean(1, keepdim=True)
                             - xhat * (dx * xhat).mean(1, keepdim=True))
                dbo += dy.sum(0)
                dls += (gv * xhat).sum(0)
                dlb += gv.sum(0)
                d = _rnd(dy)
                dwo += hs[-1].T @ d
                da = torch.where(hs[-1] > 0, d @ f(w_out).T, torch.zeros(()))
                for k in range(l1, 0, -1):
                    dbr[k - 1] += da.sum(0)
                    d = _rnd(da)
                    dwr[k - 1] += hs[k - 1].T @ d
                    da = torch.where(hs[k - 1] > 0, d @ f(w_rest[k - 1]).T,
                                     torch.zeros(()))
                dz16 = _rnd(da)
                if fold:
                    dbe += da.sum(0)
                    dwe += f(src[e]).T @ dz16
                    d_src[e] = _rnd(dz16 @ f(we).T)
                    d_pxj.index_add_(0, s, dz16)
                else:
                    d_src[e] = dz16
                    if entry == "pe":
                        d_pxj.index_add_(0, s, da)
                for half in (e[:TE // 2], e[TE // 2:]):
                    if len(half):
                        d_pxi.index_add_(0, receivers[half],
                                         dz16[half - t * TE])
            sums = torch.cat([a.reshape(-1) for a in (
                dwe if fold else torch.zeros(0), dbe if fold
                else torch.zeros(0), dwr, dbr, dwo, dbo, dls, dlb)])
            block = sums if block is None else block + sums
        total = block if total is None else total + block
    d_we, d_be, d_wr, d_br, d_wo, d_bo, d_ls, d_lb = total.split(
        [sizes[0], sizes[1] if fold else 0, *sizes[2:]])
    bf = torch.bfloat16
    tail = (d_wr.view(l1, H, H).to(bf), d_br.view(l1, H).to(bf),
            d_wo.view(H, C).to(bf), d_bo.to(bf), d_ls, d_lb)
    if fold:
        return (d_src.to(bf), d_we.view(CE, H).to(bf), d_be.to(bf),
                d_pxj.to(bf), d_pxi.to(bf), *tail)
    if entry == "pe":
        return (d_src.to(bf), d_pxj.to(bf), d_pxi.to(bf), *tail)
    return (d_src.to(bf), d_pxi.to(bf), *tail)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


FOLD_BF16 = ("e0", "we", "be", "pxj", "pxi", "w_rest", "b_rest", "w_out",
             "b_out")


def _held(names, got, want, n_zero, pxi_at):
    for name, a, b in zip(names, got, want):
        assert a.dtype == (torch.float32 if name in ("ln_s", "ln_b")
                           else torch.bfloat16), name
        assert tuple(a.shape) == np.shape(b), name
        if a.numel():
            assert rel_l2(a.float().numpy(), np.asarray(b, np.float32)) \
                < GRAD_L2, name
    np.testing.assert_array_equal(got[pxi_at][n_zero].float().numpy(), 0.0)


@pytest.mark.parametrize("l1", [0, 1, 3])
def test_fold_chain_matches_fused2rf_vjp(monkeypatch, l1):
    p = _problem(l1, n=80, Ce=CE, H=H, C=C, seed=190 + l1)
    for k in FOLD_BF16:
        p[k] = bf16(p[k])
    g = np.random.default_rng(20 + l1).normal(size=(p["n"], C)) \
        .astype(np.float32)
    want = _pallas_grads(p, g, monkeypatch)
    port, graph = _port_args(p)
    port = [t.bfloat16() if t.is_floating_point() and i < 11 else t
            for i, t in enumerate(port)]
    assert -(-graph.n_edge // TE) > 2  # both warpgroups of a block walk
    got = kernel_bwd("fold", *port[:11], port[11], torch.from_numpy(g), 1)
    _held(fe.GRAD_NAMES, got, [want[k] for k in fe.GRAD_NAMES], p["n"] // 2,
          4)


@pytest.mark.parametrize("l1", [0, 1, 3])
def test_pregathered_chain_matches_fused_edge_tail_agg_vjp(monkeypatch, l1):
    p = _problem(l1, n=80, Ce=CE, H=H, C=C, seed=200 + l1)
    p["h0"] = np.random.default_rng(210 + l1).normal(
        size=(len(p["s"]), H)).astype(np.float32) * 0.3
    for k in ("h0", "pxi", "w_rest", "b_rest", "w_out", "b_out"):
        p[k] = bf16(p[k])
    n = p["n"]
    g = np.random.default_rng(30 + l1).normal(size=(n, C)).astype(np.float32)
    _, want = _pallas_fwd_bwd(p, g, monkeypatch)
    graph = csr_from_edges(torch.from_numpy(p["s"]), torch.from_numpy(p["r"]),
                           n)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()
         if k in ("h0", "pxi", "w_rest", "b_rest", "w_out", "b_out", "ln_s")}
    got = kernel_bwd("pregathered", t["h0"].bfloat16(), None, None, None,
                     t["pxi"].bfloat16(), None, graph.rowptr,
                     *(t[k].bfloat16() for k in ("w_rest", "b_rest", "w_out",
                                                 "b_out")),
                     t["ln_s"], torch.from_numpy(g), 3)
    _held(fe.GRAD_NAMES_PREGATHERED, got, want, n // 2, 1)


@pytest.mark.parametrize("l1", [0, 1, 3])
def test_pe_chain_matches_fused2_vjp(monkeypatch, l1):
    p, gs, graph, e_idx, live = _pe_case(l1, seed=220 + l1, bf16=True)
    n = graph.n_node
    g = np.random.default_rng(40 + l1).normal(size=(n, C)).astype(np.float32)
    monkeypatch.setenv("MAGNET_TPU_PALLAS_INTERPRET", "1")
    _, want = _fused2_vjp(p, gs, graph, e_idx, live, g, jnp.bfloat16)
    pe, pxj, pxi, senders, rowptr, _, _, *tail = _port_ops(p, graph,
                                                           torch.bfloat16)
    got = kernel_bwd("pe", pe, None, None, pxj, pxi, senders, rowptr,
                     *tail[:5], torch.from_numpy(g), 2)
    zero = (graph.degree == 0).nonzero().flatten()
    _held(fe.GRAD_NAMES_PE, got, want, zero, 2)


def test_kernel_order_equals_the_plain_versions_on_a_multi_block_grid():
    """The emulation on many blocks (one tile each, and a block of two
    tiles) equals the port's bf16 plain versions within 1e-2 relative L2
    at L1 = 3, every entry: the blocks' sums and the warpgroups' splits
    do not move it."""
    p = _problem(3, n=120, Ce=CE, H=H, C=C, seed=230)
    port, graph = _port_args(p)
    port = [t.bfloat16() if t.is_floating_point() and i < 11 else t
            for i, t in enumerate(port)]
    e0, we, be, pxj, pxi, senders, rowptr, *tail = port
    g = torch.from_numpy(np.random.default_rng(50).normal(
        size=(p["n"], C)).astype(np.float32))
    n_tiles = -(-graph.n_edge // TE)
    for blocks in (n_tiles, n_tiles - 1):
        want = fe.fused_edge_tail_agg_bf16_bwd_plain(*port, g)
        got = kernel_bwd("fold", *port[:11], port[11], g, blocks)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            if b.numel():
                assert rel_l2(a.float().numpy(), b.float().numpy()) < GRAD_L2
        h0 = e0[:, :1].repeat(1, H)
        want = fe.fused_edge_tail_agg_pregathered_bf16_bwd_plain(
            h0, pxi, rowptr, *tail, g)
        got = kernel_bwd("pregathered", h0, None, None, None, pxi, None,
                         rowptr, *tail[:5], g, blocks)
        for a, b in zip(got, want):
            if b.numel():
                assert rel_l2(a.float().numpy(), b.float().numpy()) < GRAD_L2


def test_receiver_runs_in_halves_from_the_warp_search():
    """d_pxi's runs start where tile128::warp_receiver (from the tile
    before's last receiver) places each half's receivers: on a hub graph
    every edge's receiver is found, so the half-tile runs sum each
    receiver's edges exactly (integer rows)."""
    deg = np.array([0, 130, 0, 0, 3, 1, 70, 0, 2], np.int64)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    n_edges = int(rowptr[-1])
    vals = np.random.default_rng(3).integers(-8, 9, (n_edges, 4)).astype(
        np.float64)
    want = np.zeros((len(deg), 4))
    np.add.at(want, np.repeat(np.arange(len(deg)), deg), vals)
    for blocks in (1, 2, 100):
        got = np.zeros_like(want)
        for groups in ranges(-(-n_edges // TE), blocks):
            for t_beg, t_end in groups:
                hint = -1
                for t in range(t_beg, t_end):
                    base = t * TE
                    nv = min(TE, n_edges - base)
                    rcv = np.concatenate([
                        warp_receiver(rowptr, base + 32 * w,
                                      min(32, nv - 32 * w), hint)
                        [:max(0, min(32, nv - 32 * w))] for w in range(2)])
                    hint = int(rcv[nv - 1])
                    for h0 in range(0, nv, TE // 2):
                        r = rcv[h0:h0 + TE // 2]
                        starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
                        np.add.at(got, r[starts], np.add.reduceat(
                            vals[base + h0:base + h0 + len(r)], starts,
                            axis=0))
        np.testing.assert_array_equal(got, want)
