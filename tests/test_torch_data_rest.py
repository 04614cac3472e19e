"""The rest of the port's data layer against magnet_tpu: the loader's
prefetch thread (the same batches in the same order as the synchronous
loader and as the JAX loader's thread; a worker's exception raised in the
consumer; a consumer that stops early stops the thread), the datamodule's
``num_workers``; ``solve_burgers_1d`` and ``solve_combined_1d_irregular``
bit for bit; the writers ``generate_1d_file``, ``generate_ce_suite`` and
``generate_2d_file``, whose HDF5 files hold the same datasets (names,
shapes, dtypes, values, bit for bit) as the JAX writers' for the same
arguments, read back by the port's ``source=h5``; and the port's module
entry point against ``scripts/gen_synthetic_data.sh``'s calls.

Every comparison is exact: both packages run the same numpy code on the
same generator.
"""
import os
import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from magnet_tpu.data import synthetic as jax_synthetic  # noqa: E402
from magnet_tpu.data.datamodule import build_loaders as jax_build_loaders  # noqa: E402
from magnet_tpu.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from magnet_tpu_torch.config import DATAMODULE_GRAPH_2D, DATAMODULE_IMPLICIT  # noqa: E402
from magnet_tpu_torch.data import synthetic  # noqa: E402
from magnet_tpu_torch.data.datamodule import build_loaders  # noqa: E402
from magnet_tpu_torch.data.loader import DataLoader  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Items:
    """A dataset of ``n`` items {"i", "seed"}; item ``fail`` raises."""

    def __init__(self, n, fail=None, delay=0.0):
        self.n, self.fail, self.delay, self.seed = n, fail, delay, 0

    def __len__(self):
        return self.n

    def set_epoch(self, seed):
        self.seed = seed

    def __getitem__(self, i):
        if i == self.fail:
            raise KeyError(f"item {i}")
        time.sleep(self.delay)
        return {"i": np.int64(i), "seed": np.int64(self.seed)}


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_prefetch_yields_the_synchronous_batches_in_order(shuffle, drop_last):
    """Prefetching 1 or 2 batches ahead yields what the synchronous loader
    and the JAX loader's prefetch thread yield, epoch after epoch."""
    sync = DataLoader(_Items(11), 3, shuffle=shuffle, seed=5,
                      drop_last=drop_last)
    want_l = JaxDataLoader(_Items(11), 3, shuffle=shuffle, seed=5,
                           prefetch=2, drop_last=drop_last)
    for prefetch in (1, 2):
        got_l = DataLoader(_Items(11), 3, shuffle=shuffle, seed=5,
                           drop_last=drop_last, prefetch=prefetch)
        for epoch in (0, 4):
            for loader in (sync, got_l, want_l):
                loader.set_epoch(epoch)
            got, base, want = list(got_l), list(sync), list(want_l)
            assert len(got) == len(base) == len(want) == len(got_l)
            for g, b, w in zip(got, base, want):
                for k in ("i", "seed"):
                    np.testing.assert_array_equal(g[k], b[k])
                    np.testing.assert_array_equal(g[k], w[k])


def test_prefetch_raises_the_workers_exception():
    """An exception in the worker thread is raised in the consumer, after
    the batches read before it."""
    loader = DataLoader(_Items(9, fail=7), 2, shuffle=False, prefetch=2)
    got = []
    with pytest.raises(KeyError, match="item 7"):
        for batch in loader:
            got.append(batch["i"].tolist())
    assert got == [[0, 1], [2, 3], [4, 5]]


def test_a_consumer_that_stops_early_stops_the_thread():
    """Leaving the loop closes the generator, which ends its worker."""
    loader = DataLoader(_Items(40, delay=0.001), 2, shuffle=False,
                        prefetch=2)
    before = threading.active_count()
    it = iter(loader)
    assert next(it)["i"].tolist() == [0, 1]
    it.close()
    assert threading.active_count() == before


def test_num_workers_switches_the_prefetch_thread_on(tmp_path):
    """``num_workers`` > 0 gives every split a prefetch of 2, as the JAX
    datamodule; 0 none; the 2D datamodules' defaults are the YAML's 3."""
    path = synthetic.generate_1d_file(str(tmp_path / "ks.h5"), n_train=2,
                                      n_valid=2, n_test=2, nt=24, nx=32,
                                      eq="Heat")
    cfg = dict(DATAMODULE_IMPLICIT, train_path=path, val_path=path,
               test_path=path, nt_train=24, nx_train=32, nt_val=24,
               nx_val=32, nt_test=24, nx_test=32, samples=8, batch_size=2)
    assert DATAMODULE_IMPLICIT["num_workers"] == 0
    assert DATAMODULE_GRAPH_2D["num_workers"] == 3
    for workers, prefetch in ((0, 0), (3, 2)):
        loaders = build_loaders(dict(cfg, num_workers=workers), seed=1)
        assert {v.prefetch for v in loaders.values()} == {prefetch}
    a = build_loaders(dict(cfg, num_workers=0), seed=1)["train"]
    b = build_loaders(dict(cfg, num_workers=3), seed=1)["train"]
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_solve_burgers_1d_and_the_irregular_combined_equation_are_jaxs():
    kw = dict(nx_fine=64, nt_out=20, nx_out=32, t_end=1.0, nu=0.05)
    want = jax_synthetic.solve_burgers_1d(np.random.default_rng(3), **kw)
    got = synthetic.solve_burgers_1d(np.random.default_rng(3), **kw)
    assert got[0].shape == (20, 32)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    kw = dict(eq="E2", n_nodes=12, nx_fine=32, nt_out=10, t_end=1.0)
    want = jax_synthetic.solve_combined_1d_irregular(
        np.random.default_rng(4), **kw)
    got = synthetic.solve_combined_1d_irregular(np.random.default_rng(4), **kw)
    assert got[0].shape == (10, 12) and got[1].shape == (12,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _h5_tree(path) -> dict:
    with h5py.File(path, "r") as f:
        return {f"{g}/{k}": f[g][k][()] for g in f for k in f[g]}


def _assert_same_file(got_path, want_path):
    got, want = _h5_tree(got_path), _h5_tree(want_path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


WRITER_CASES = {
    "1d_burgers": ("generate_1d_file", dict(n_train=2, n_valid=1, n_test=1,
                                            nt=20, nx=32, seed=3)),
    "1d_heat": ("generate_1d_file", dict(n_train=1, n_valid=2, n_test=1,
                                         nt=16, nx=32, seed=21, eq="Heat")),
    "1d_ks": ("generate_1d_file", dict(n_train=1, n_valid=1, n_test=1,
                                       nt=8, nx=32, seed=1, eq="KS")),
    "1d_e3": ("generate_1d_file", dict(n_train=1, n_valid=1, n_test=1,
                                       nt=10, nx=8, seed=0, eq="E3",
                                       n_steps=200)),
    "2d_regular": ("generate_2d_file", dict(n_train=1, n_valid=1, n_test=1,
                                            nt=10, res=16, seed=2)),
    "2d_uniform": ("generate_2d_file", dict(
        n_train=1, n_valid=1, n_test=1, nt=10, res=16, seed=4,
        irregular=True, n_nodes=40)),
    "2d_concentrated": ("generate_2d_file", dict(
        n_train=1, n_valid=1, n_test=1, nt=10, res=16, seed=5,
        irregular=True, n_nodes=40, concentrated=True, nu=0.05)),
    "2d_default_nodes": ("generate_2d_file", dict(
        n_train=1, n_valid=1, n_test=1, nt=10, res=8, seed=6,
        irregular=True)),
}


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_writers_write_the_jax_writers_files(tmp_path, case):
    """Each writer's file against the JAX writer's for the same arguments:
    the 1D schema (plain Burgers, Heat, KS, the combined equation) and the
    2D one (regular; irregular, uniform and concentrated, and with the
    default node count)."""
    name, kw = WRITER_CASES[case]
    got = getattr(synthetic, name)(str(tmp_path / "port" / "f.h5"), **kw)
    want = getattr(jax_synthetic, name)(str(tmp_path / "jax" / "f.h5"), **kw)
    assert got == str(tmp_path / "port" / "f.h5")
    _assert_same_file(got, want)


def test_ce_suite_writes_the_jax_suite(tmp_path):
    """``generate_ce_suite``'s regular train and test files and its
    irregular ones: the same paths under the root and the same files."""
    kw = dict(eq="E1", n_train=2, n_valid=1, n_test=1, nt=8,
              resolutions=(16, 8), train_resolution=16,
              irregular_nodes=(10, 12), nx_fine=32, seed=10, n_steps=160)
    got = synthetic.generate_ce_suite(str(tmp_path / "port"), **kw)
    want = jax_synthetic.generate_ce_suite(str(tmp_path / "jax"), **kw)
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    assert len(got) == 5
    for g, w in zip(got, want):
        _assert_same_file(g, w)


def test_source_h5_reads_what_the_port_wrote(tmp_path):
    """The port's loaders with ``source=h5`` on files the port wrote (the 1D
    graph datamodule on the combined equation, the 2D one on Burgers) give
    the batches the JAX loaders give on the same files."""
    p1 = synthetic.generate_1d_file(str(tmp_path / "ce.h5"), n_train=4,
                                    n_valid=2, n_test=2, nt=30, nx=16,
                                    eq="E3", n_steps=240)
    p2 = synthetic.generate_2d_file(str(tmp_path / "b.h5"), n_train=2,
                                    n_valid=2, n_test=2, nt=10, res=8)
    for kind, path, key, res, nt in (("h5_graph_1d", p1, "nx", 16, 30),
                                     ("h5_graph_2d", p2, "res", 8, 10)):
        cfg = {"kind": kind, "batch_size": 2, "source": "h5"}
        for split in ("train", "val", "test"):
            cfg.update({f"{split}_path": path, f"{key}_{split}": res,
                        f"nt_{split}": nt})
        got = build_loaders(cfg, seed=0)
        want = jax_build_loaders({**cfg, "num_workers": 0}, seed=0)
        for split in ("train", "val", "test"):
            got[split].set_epoch(1)
            want[split].set_epoch(1)
            pairs = list(zip(got[split], want[split]))
            assert len(pairs) == len(want[split]) > 0
            for g, w in pairs:
                assert sorted(g) == sorted(w)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_module_entry_point_makes_the_scripts_calls(monkeypatch, tmp_path):
    """``python -m magnet_tpu_torch.data.synthetic ROOT`` (its
    ``generate_suite``) calls the writers with the arguments, in the order,
    of ``scripts/gen_synthetic_data.sh``'s Python block, paths under ROOT
    for the script's ``data/``, and makes the same copies."""
    def recorder(calls, name):
        def record(path, **kw):
            calls.append((name, os.path.relpath(path), kw))
            return [path] if name == "generate_ce_suite" else path
        return record

    def copies(calls):
        return lambda a, b: calls.append(("copy", os.path.relpath(a),
                                          os.path.relpath(b)))

    names = ("generate_1d_file", "generate_2d_file", "generate_ce_suite")
    script = open(os.path.join(REPO, "scripts", "gen_synthetic_data.sh")).read()
    block = re.search(r"<<'PY'\n(.*)\nPY", script, re.S).group(1)
    want, got = [], []
    monkeypatch.chdir(tmp_path)
    for name in names:
        monkeypatch.setattr(jax_synthetic, name, recorder(want, name))
        monkeypatch.setattr(synthetic, name, recorder(got, name))
    monkeypatch.setattr("shutil.copy", copies(want))
    monkeypatch.setenv("GEN_CE_SUITE", "1")
    exec(compile(block, "gen_synthetic_data.sh", "exec"), {})
    monkeypatch.setattr(synthetic.shutil, "copy", copies(got))
    synthetic.generate_suite("data")
    assert [c for c in got if c[0] != "copy"] == \
        [c for c in want if c[0] != "copy"]
    assert [c for c in got if c[0] == "copy"] == \
        [c for c in want if c[0] == "copy"]
    assert len(got) == len(want) == 3 + 6 + 8 + 3 + 3
