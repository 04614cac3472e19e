"""The overlap split's partition buffers (``graph_halo="overlap"`` and
``"ring"``) against the JAX package's ``build_partition_buffers(...,
halo="overlap")`` and ``partition_graph_halo_overlap``, bit for bit: three
seeded random radius graphs, G = 2, 3, 4; ``ring`` builds the same buffers.
Tolerance: equal.  (A file of its own, with fewer tests than
``tests/test_parallel.py``: pytest-xdist queues files by test count, so
that long file starts first.)
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from magnet_tpu.parallel import graph_partition as jgp  # noqa: E402
from magnet_tpu_torch.parallel import graph_partition as tgp  # noqa: E402
from test_torch_parallel_buffers import _raw  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_overlap_buffers_equal_jax(seed, shards):
    raw = _raw(seed)
    n = 48
    s, t = raw[0]
    want = jgp.partition_graph_halo_overlap(s, t, n, shards)
    got = tgp.partition_graph_halo_overlap(s, t, n, shards)
    for f in want.__dataclass_fields__:
        w, g = getattr(want, f), getattr(got, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    want = jgp.build_partition_buffers(raw, n, shards, halo="overlap")
    for mode in ("overlap", "ring"):
        got = tgp.build_partition_buffers(raw, n, shards, halo=mode)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            assert np.asarray(got[k]).dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
