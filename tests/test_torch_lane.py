"""The port's kernel lane against the JAX package's decision on the same
coordinates.

The JAX side is ``build_radius_graph_batch`` (its host tile layout, with
the caches cleared first so that no bucket of an earlier batch sticks)
and the gates that read it: ``InteractionNetwork._fused2_mode`` for the
GraphNet (None: the XLA sender gather and ``fused_edge_tail_agg``, the
port's ``pregathered``; any mode: the in-kernel-gather functions, the
port's ``fold``) and the ``use_v2r`` test of ``MPNNLayer.__call__`` for
MPNN (the port's ``gather``, else ``pregathered``).  The comparison is
exact: a lane is a name.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from magnet_tpu.models import common as jax_common  # noqa: E402
from magnet_tpu.nn.graphnet import InteractionNetwork as JaxInteraction  # noqa: E402
from magnet_tpu.ops.pallas_kernels import DPXJ_TABLE_BYTES  # noqa: E402
from magnet_tpu.utils import make_coord_np as jax_make_coord_np  # noqa: E402
from magnet_tpu_torch.ops.graph import (  # noqa: E402
    GraphCache,
    TileLayout,
    csr_from_edges,
    graphnet_lane,
    lane_of,
)


def _jax_graph(coords, r, loop):
    jax_common._GRAPH_CACHE.clear()
    jax_common._E_TILE_CACHE.clear()
    g = jax_common.build_radius_graph_batch(coords, r, loop=loop)
    return jax.tree.map(lambda a: a[0], g)      # one sample's view


def _jax_graphnet_lane(coords, r, hidden):
    gs = _jax_graph(coords, r, loop=True)
    t = gs.blk_recv_local.shape[0]
    step = JaxInteraction(node_out=32, edge_out=32, mlp_layers=4,
                          mlp_hidden=hidden)
    mode = step._fused2_mode(gs, t * 128, hidden)
    return "pregathered" if mode is None else "fold"


def _jax_mpnn_lane(coords, r, hidden):
    gs = _jax_graph(coords, r, loop=False)
    n_pad = gs.blk_recv_local.shape[0] * 128
    use_v2r = (gs.blk_snd2_tids is not None and gs.blk_chunk_ct is not None
               and n_pad * hidden * 4 <= DPXJ_TABLE_BYTES)
    return "gather" if use_v2r else "pregathered"


def _cnn_coords(support, queries, batch, seed):
    """MAgNet[CNN]'s node set: the LR support grid ∪ the HR queries, the
    queries drawn without replacement from the HR grid (``queries`` None:
    all of it)."""
    rng = np.random.default_rng(seed)
    lr = jax_make_coord_np(support)
    full = jax_make_coord_np([2 * s for s in support])
    pick = [np.arange(len(full)) if queries is None
            else np.sort(rng.choice(len(full), queries, replace=False))
            for _ in range(batch)]
    return np.stack([np.concatenate([lr, full[p]]) for p in pick])


def _gnn_coords(queries, batch, seed):
    """MAgNet[GNN] 1D's node sets on a 256-node mesh normalised to
    [-1, 1]: the stride-2 support alone (``queries`` 0), or with
    ``queries`` of the odd complement (None: all of it)."""
    rng = np.random.default_rng(seed)
    mesh = np.linspace(-1, 1, 256, dtype=np.float32)[:, None]
    lr, odd = mesh[::2], mesh[1::2]
    pick = [np.arange(len(odd)) if queries is None
            else np.sort(rng.choice(len(odd), queries, replace=False))
            for _ in range(batch)]
    return np.stack([np.concatenate([lr, odd[p]]) for p in pick])


def _mpnn_2d_coords(width):
    x = (np.arange(width) / width).astype(np.float32)
    grid = np.stack(np.meshgrid(x, x, indexing="ij"), -1).reshape(-1, 2)
    r = 4 * float(np.linalg.norm((grid[1] - grid[0])
                                 - (grid[width] - grid[0]))) + 1e-4
    return grid[None], r


# (name, family, coordinates, radius, hidden, the lane the issue records)
CASES = {
    "magnet_cnn_2d_train": lambda: ("graphnet", _cnn_coords([32, 32], 32, 32, 0),
                                    0.1, 64, "pregathered"),
    "magnet_cnn_2d_eval": lambda: ("graphnet", _cnn_coords([32, 32], None, 1, 0),
                                   0.1, 64, "fold"),
    "magnet_cnn_1d_train": lambda: ("graphnet", _cnn_coords([128], 32, 32, 1),
                                    0.08, 64, "fold"),
    "magnet_cnn_1d_eval": lambda: ("graphnet", _cnn_coords([128], None, 1, 1),
                                   0.08, 64, "fold"),
    "magnet_gnn_lr": lambda: ("graphnet", _gnn_coords(0, 16, 2), 0.08, 128,
                              "fold"),
    "magnet_gnn_train": lambda: ("graphnet", _gnn_coords(32, 32, 2), 0.08,
                                 128, "fold"),
    "magnet_gnn_eval": lambda: ("graphnet", _gnn_coords(None, 16, 2), 0.08,
                                128, "fold"),
    "mpnn_2d_64": lambda: ("mpnn", *_mpnn_2d_coords(64), 128, "gather"),
    "mpnn_2d_128": lambda: ("mpnn", *_mpnn_2d_coords(128), 128, "pregathered"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lane_matches_jax(case):
    family, coords, r, hidden, expected = CASES[case]()
    coords = np.ascontiguousarray(coords, np.float32)
    loop = family == "graphnet"
    want = (_jax_graphnet_lane if loop else _jax_mpnn_lane)(coords, r, hidden)
    graph = GraphCache(lane_rule=(family, hidden)).radius_graph_batch(
        coords, r, loop=loop)
    assert graph.lane == want == expected
    # the same lane comes from the layout alone
    bare = csr_from_edges(graph.senders, graph.receivers, graph.n_node,
                          layout=graph.layout)
    assert bare.lane is None and lane_of(bare, family, hidden) == want


def test_lane_needs_a_layout_or_a_cached_lane():
    graph = csr_from_edges(torch.tensor([0, 1]), torch.tensor([0, 1]), 2)
    assert graph.layout is None and graph.lane is None
    with pytest.raises(ValueError, match="layout"):
        lane_of(graph, "graphnet", 64)


def test_graphnet_lane_gates_on_the_table_size():
    """Without the sender-transpose layout the in-kernel lanes are gated on
    the f32 node table's size (5/6/8 MiB for 'vmem', 9 MiB for 'hbm')."""
    small = TileLayout(n_pad=4096, snd2=True, snd_transpose=False)
    huge = TileLayout(n_pad=65536, snd2=True, snd_transpose=False)
    assert graphnet_lane(small, 64) == "fold"          # 1 MiB: 'vmem'
    assert graphnet_lane(huge, 32) == "fold"           # 8 MiB: 'hbm'
    assert graphnet_lane(huge, 64) == "pregathered"    # 16 MiB: none
    assert graphnet_lane(TileLayout(65536, True, True), 64) == "fold"
    assert graphnet_lane(TileLayout(256, False, True), 64) == "pregathered"
