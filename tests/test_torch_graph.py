"""Port host graph vs magnet_tpu.ops.graph.radius_graph_np: identical edge
sets (exact integer comparison), and the batched CSR invariants."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from magnet_tpu.ops.graph import radius_graph_np  # noqa: E402
from magnet_tpu.utils import make_coord_np as jax_make_coord_np  # noqa: E402
from magnet_tpu_torch.ops import graph as port_graph  # noqa: E402
from magnet_tpu_torch.ops.graph import (  # noqa: E402
    GraphCache, csr_from_edges, radius_graph, radius_graph_batch)
from magnet_tpu_torch.utils import make_coord_np  # noqa: E402


def _eval_coords(L=128, N=256):
    """The eval shape's LR ∪ HR node set."""
    return np.concatenate([make_coord_np([L]), make_coord_np([N])], axis=0)


def test_make_coord_matches_jax():
    for shape in ([7], [128], [5, 3]):
        np.testing.assert_array_equal(make_coord_np(shape),
                                      jax_make_coord_np(shape))


@pytest.mark.parametrize("case", ["random", "eval_shape", "eval_shape_capped",
                                  "random_2d_noloop"])
def test_radius_graph_matches_jax(case):
    rng = np.random.default_rng(0)
    loop, r = True, 0.08
    if case == "random":
        pos = rng.uniform(-1, 1, (300, 1)).astype(np.float32)
    elif case == "eval_shape":
        pos = _eval_coords()
    elif case == "eval_shape_capped":
        pos, r = _eval_coords(), 0.15  # ~60 in range: the 32-cap binds
    else:
        pos, loop, r = rng.uniform(-1, 1, (200, 2)).astype(np.float32), False, 0.3
    s_ref, r_ref = radius_graph_np(pos, r, loop=loop)
    s, rc = radius_graph(torch.from_numpy(pos), r, loop=loop)
    np.testing.assert_array_equal(s.numpy(), s_ref)
    np.testing.assert_array_equal(rc.numpy(), r_ref)
    if case == "eval_shape_capped":
        assert np.bincount(r_ref).max() == 32


def _grid_2d(width):
    x = (np.arange(width) / width).astype(np.float32)
    return np.stack(np.meshgrid(x, x, indexing="ij"), -1).reshape(-1, 2)


@pytest.mark.parametrize("block_pairs", [1 << 22, 1000])
def test_radius_graph_on_a_capped_2d_grid_matches_jax(monkeypatch,
                                                      block_pairs):
    """MPNN-2D's graph: a regular grid whose radius 4·‖dx − dy‖ finds ~100
    candidates per receiver, cut to the 32 lowest-indexed; built in one row
    block and in many (7 receivers at a time)."""
    monkeypatch.setattr(port_graph, "_BLOCK_PAIRS", block_pairs)
    width = 12
    pos = _grid_2d(width)
    r = 4 * float(np.linalg.norm((pos[1] - pos[0]) - (pos[width] - pos[0]))) + 1e-4
    s_ref, r_ref = radius_graph_np(pos, r, loop=False)
    assert np.bincount(r_ref).max() == 32  # the cap bites
    assert np.bincount(r_ref).min() < 32   # and not everywhere
    s, rc = radius_graph(torch.from_numpy(pos), r, loop=False)
    np.testing.assert_array_equal(s.numpy(), s_ref)
    np.testing.assert_array_equal(rc.numpy(), r_ref)
    # a batch of identical grids reuses the first sample's edges
    batch = np.stack([pos, pos, pos * 2.0])
    g = radius_graph_batch(torch.from_numpy(batch), r, loop=False)
    n = width * width
    lo, hi = g.rowptr[n].item(), g.rowptr[2 * n].item()
    np.testing.assert_array_equal(g.senders[lo:hi].numpy() - n, s_ref)
    np.testing.assert_array_equal(g.receivers[lo:hi].numpy() - n, r_ref)
    s2, r2 = radius_graph_np(batch[2], r, loop=False)
    np.testing.assert_array_equal(g.senders[hi:].numpy() - 2 * n, s2)
    np.testing.assert_array_equal(g.receivers[hi:].numpy() - 2 * n, r2)


def test_radius_graph_scales_to_a_128_squared_mesh():
    """16,384 nodes per sample: built in row blocks, never as a dense N x N
    array; a sample of receivers is held to a brute-force row each."""
    width = 128
    pos = _grid_2d(width)
    n = width * width
    r = 4 * float(np.linalg.norm((pos[1] - pos[0]) - (pos[width] - pos[0]))) + 1e-4
    g = radius_graph_batch(torch.from_numpy(np.stack([pos, pos])), r,
                           loop=False)
    assert g.n_node == 2 * n and int(g.degree.max()) == 32
    rowptr, send = g.rowptr.numpy(), g.senders.numpy()
    # the second sample repeats the first, shifted by n
    np.testing.assert_array_equal(rowptr[n:] - rowptr[n], rowptr[:n + 1])
    np.testing.assert_array_equal(send[rowptr[n]:] - n, send[:rowptr[n]])
    p64 = pos.astype(np.float64)
    for i in np.random.default_rng(0).choice(n, 40, replace=False):
        near = np.nonzero(((p64 - p64[i]) ** 2).sum(-1) <= r * r)[0]
        near = near[near != i][:32]
        np.testing.assert_array_equal(send[rowptr[i]:rowptr[i + 1]], near)


def test_graph_cache_returns_the_same_graph_for_the_same_coordinates():
    cache = GraphCache(max_entries=2)
    pos = np.stack([_grid_2d(6)] * 2)
    a = cache.radius_graph_batch(pos, 0.5, loop=False)
    assert cache.radius_graph_batch(pos.copy(), 0.5, loop=False) is a
    assert cache.hits == 1
    want = radius_graph_batch(torch.from_numpy(pos), 0.5, loop=False)
    np.testing.assert_array_equal(a.senders.numpy(), want.senders.numpy())
    np.testing.assert_array_equal(a.rowptr.numpy(), want.rowptr.numpy())
    # another radius, loop flag or mesh is another graph; the oldest goes
    b = cache.radius_graph_batch(pos, 0.3, loop=False)
    c = cache.radius_graph_batch(pos, 0.5, loop=True)
    assert b is not a and c is not a and b.n_edge < a.n_edge < c.n_edge
    assert cache.radius_graph_batch(pos, 0.5, loop=False) is not a
    assert cache.hits == 1


def test_radius_graph_batch_csr_invariants():
    rng = np.random.default_rng(1)
    B, n, r = 3, 150, 0.05
    pos = np.sort(rng.uniform(-1, 1, (B, n, 1)), axis=1).astype(np.float32)
    pos[1, 7, 0] = 5.0  # isolated; with loop=False its degree is 0
    g = radius_graph_batch(torch.from_numpy(pos), r, loop=False)
    assert g.n_node == B * n
    for t in (g.senders, g.receivers, g.rowptr):
        assert t.dtype == torch.int32
    rowptr = g.rowptr.numpy()
    assert rowptr[0] == 0 and rowptr[-1] == g.n_edge
    assert (np.diff(rowptr) >= 0).all()
    np.testing.assert_array_equal(np.diff(rowptr), g.degree.numpy())
    assert g.degree[n + 7] == 0
    recv = g.receivers.numpy()
    send = g.senders.numpy()
    # receiver-grouped, senders ascending inside a receiver
    np.testing.assert_array_equal(recv, np.repeat(np.arange(B * n), np.diff(rowptr)))
    same = recv[1:] == recv[:-1]
    assert (send[1:][same] > send[:-1][same]).all()
    # each sample's block equals its own graph shifted by b*n
    for b in range(B):
        s_ref, r_ref = radius_graph_np(pos[b], r, loop=False)
        lo, hi = rowptr[b * n], rowptr[(b + 1) * n]
        np.testing.assert_array_equal(send[lo:hi] - b * n, s_ref)
        np.testing.assert_array_equal(recv[lo:hi] - b * n, r_ref)


@pytest.mark.parametrize("senders, receivers, match", [
    ([0, 1, 2], [1, 0, 2], "grouped by receiver"),
    ([0, 1, 4], [0, 1, 2], "outside"),
    ([0, 1, 2], [0, 1, 4], "outside"),
    ([-1, 1, 2], [0, 1, 2], "outside"),
    ([0, 1], [0, 1, 2], "1-D shapes"),
])
def test_csr_from_edges_rejects_invalid_graphs(senders, receivers, match):
    """The kernel trusts its CSR, so a graph that would make it read out of
    bounds is refused when it is built."""
    with pytest.raises(ValueError, match=match):
        csr_from_edges(torch.tensor(senders), torch.tensor(receivers), 4)
