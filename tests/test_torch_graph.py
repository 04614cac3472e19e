"""Port host graph vs magnet_tpu.ops.graph.radius_graph_np: identical edge
sets (exact integer comparison), and the batched CSR invariants."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from magnet_tpu.ops.graph import radius_graph_np  # noqa: E402
from magnet_tpu.utils import make_coord_np as jax_make_coord_np  # noqa: E402
from magnet_tpu_torch.ops.graph import (  # noqa: E402
    csr_from_edges, radius_graph, radius_graph_batch)
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
