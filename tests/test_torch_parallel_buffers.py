"""The port's partition buffers against the JAX package's, bit for bit
(``partition_graph``, ``partition_graph_halo``, ``build_partition_buffers``
with halo False and True, three seeded random radius graphs, G = 2, 3, 4),
the ``graph_halo`` modes (``fused`` builds the halo buffers; ``overlap``
and ``ring`` are not ported and raise), the trainer's config keys and
``run.py``'s world-size check.  Tolerance: equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from magnet_tpu.ops.graph import radius_graph_np  # noqa: E402
from magnet_tpu.parallel import graph_partition as jgp  # noqa: E402
from magnet_tpu_torch.config import compose  # noqa: E402
from magnet_tpu_torch.parallel import graph_partition as tgp  # noqa: E402


def _raw(seed, bsz=3, n=48):
    """``bsz`` seeded random 2D radius graphs of ``n`` nodes each, with
    self loops (the models' graphs have them)."""
    rng = np.random.default_rng(seed)
    return [radius_graph_np(rng.uniform(-1, 1, (n, 2)), 0.35, loop=True)
            for _ in range(bsz)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_partition_buffers_equal_jax(seed, shards):
    raw = _raw(seed)
    n = 48
    s, t = raw[0]
    for fn in ("partition_graph", "partition_graph_halo"):
        want = getattr(jgp, fn)(s, t, n, shards)
        got = getattr(tgp, fn)(s, t, n, shards)
        for f in want.__dataclass_fields__:
            w, g = getattr(want, f), getattr(got, f)
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f"{fn}.{f}")
    for halo in (False, True):
        want = jgp.build_partition_buffers(raw, n, shards, halo=halo)
        got = tgp.build_partition_buffers(raw, n, shards, halo=halo)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            assert np.asarray(got[k]).dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_fused_builds_the_halo_buffers_and_overlap_raises():
    raw = _raw(5)
    fused = tgp.build_partition_buffers(raw, 48, 4, halo="fused")
    halo = tgp.build_partition_buffers(raw, 48, 4, halo=True)
    assert sorted(fused) == sorted(halo)
    for k in halo:
        np.testing.assert_array_equal(fused[k], halo[k])
    for mode in ("overlap", "ring"):
        with pytest.raises(NotImplementedError, match="A.6"):
            tgp.build_partition_buffers(raw, 48, 4, halo=mode)
    with pytest.raises(ValueError):
        tgp.build_partition_buffers(raw, 48, 4, halo="blocked")


def test_config_keys_and_the_world_size_check():
    tr = compose(["trainer.devices=-1", "trainer.graph_shards=2",
                  "trainer.graph_halo=fused"])["trainer"]
    assert (tr["devices"], tr["graph_shards"], tr["graph_halo"]) == (-1, 2,
                                                                    "fused")
    assert compose(["trainer.graph_halo=true"])["trainer"]["graph_halo"] is True
    assert compose([])["trainer"]["graph_halo"] is False
    with pytest.raises(ValueError):
        compose(["trainer.skip_nonfinite=fused"])
    from magnet_tpu_torch.run import main

    # one process is not a world of devices x graph_shards = 2
    with pytest.raises(ValueError, match="nproc_per_node=2"):
        main(["device=cpu", "trainer.graph_shards=2"])
