"""The port's input pipeline (``flinkml_tpu_torch.data`` and the CSV and
LibSVM readers of ``flinkml_tpu_torch.io``) against the JAX package's, on
the CPU.

The same seeded numpy inputs go through the same chain built in each
package (the two share one API). Every comparison here is exact: the
pipeline moves rows and draws its shuffle from a numpy ``Generator``
(PCG64) in both packages, so batches, their order, cursors and parses
agree bit for bit.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import flinkml_tpu.data as jdata
import flinkml_tpu_torch as fml
import flinkml_tpu_torch.data as tdata
from flinkml_tpu.io import csv as j_csv
from flinkml_tpu.io import libsvm as j_libsvm
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch.io import _native
from flinkml_tpu_torch.io import csv as t_csv
from flinkml_tpu_torch.io import libsvm as t_libsvm
from flinkml_tpu_torch.iteration import (
    CheckpointManager,
    IterationConfig,
    TerminateOnMaxIter,
    iterate,
)
from flinkml_tpu_torch.table import PaddedDeviceColumn, Table
from tests._torch_port_common import on_cpu  # noqa: F401

PKGS = {"port": (tdata, Table), "jax": (jdata, JaxTable)}


def _columns(n=53, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return {"features": rng.normal(size=(n, d)),
            "y": np.arange(float(n))}


def _keep_even(t):
    return np.asarray(t.column("y")) % 2 == 0


def _scale(t):
    return t.with_column("features", np.asarray(t.column("features")) * 2.0)


#: Chains as (ops, batch size): each op is a (method, args) pair applied in
#: order to ``Dataset.from_arrays``.
CHAINS = {
    "plain": ([], 5),
    "map": ([("map", (_scale,))], 5),
    "filter": ([("filter", (_keep_even,))], 4),
    "rebatch": ([("rebatch", (7,))], 5),
    "rebatch_drop": ([("rebatch", (7, True))], 3),
    "window": ([("window", (8,))], 5),
    "window_stride": ([("window", (8, 3))], 5),
    "shuffle": ([("shuffle", (4, 3))], 5),
    "shuffle_big_buffer": ([("shuffle", (64, 1))], 5),
    "map_filter_rebatch_shuffle": ([("map", (_scale,)), ("filter", (_keep_even,)),
                                    ("rebatch", (6,)), ("shuffle", (3, 7))], 4),
}


def _dataset(pkg: str, chain: str, shard=None, cols=None):
    mod, table_cls = PKGS[pkg]
    ops, bs = CHAINS[chain]
    ds = mod.Dataset.from_arrays(table_cls(cols or _columns()), bs,
                                 shard=shard)
    for method, args in ops:
        ds = getattr(ds, method)(*args)
    return ds


def _host(batches):
    return [{name: np.asarray(b.column(name)) for name in b.column_names}
            for b in batches]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for name in g:
            assert g[name].dtype == w[name].dtype
            np.testing.assert_array_equal(g[name], w[name])


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_chain_batches_match_jax(chain, on_cpu):
    """The same batches in the same order as the JAX chain, and two
    iterations of one Dataset give the same sequence."""
    port = _host(_dataset("port", chain))
    _assert_same(port, _host(_dataset("jax", chain)))
    _assert_same(_host(_dataset("port", chain)), port)


@pytest.mark.parametrize("shard", [(0, 3), (1, 3), (2, 3)])
def test_sharded_array_source_matches_jax(shard, on_cpu):
    _assert_same(_host(_dataset("port", "plain", shard=shard)),
                 _host(_dataset("jax", "plain", shard=shard)))


@pytest.mark.parametrize("chain", ["plain", "map", "filter", "rebatch",
                                   "window_stride", "shuffle",
                                   "map_filter_rebatch_shuffle"])
def test_resume_at_every_position_matches_jax(chain, on_cpu):
    """``iterate_from(k)`` and ``iterate(cursor at k)`` give the
    uninterrupted sequence from batch k, at every k; each cursor equals
    the JAX iterator's cursor at the same position (source position,
    shuffle RNG state, in-flight count)."""
    full = _host(_dataset("port", chain))
    for k in range(len(full) + 1):
        port_it = _dataset("port", chain).iterate()
        jax_it = _dataset("jax", chain).iterate()
        for _ in range(k):
            next(port_it)
            next(jax_it)
        cursor = port_it.cursor()
        assert cursor.to_json_dict() == jax_it.cursor().to_json_dict()
        port_it.close()
        jax_it.close()
        _assert_same(_host(_dataset("port", chain).iterate(cursor)), full[k:])
        _assert_same(_host(_dataset("port", chain).iterate_from(k)), full[k:])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cursor_json_crosses_packages(writer, on_cpu):
    """A cursor written mid-shuffle-buffer by one package restores in the
    other (through its JSON and through ``to_state``)."""
    reader = "jax" if writer == "port" else "port"
    it = _dataset(writer, "shuffle").iterate()
    for _ in range(6):
        next(it)
    cursor = it.cursor()
    it.close()
    assert cursor.in_flight > 0  # the shuffle buffer holds read batches
    payload = json.loads(json.dumps(cursor.to_json_dict()))
    mod = PKGS[reader][0]
    restored = mod.Cursor.from_json_dict(payload)
    assert restored.to_json_dict() == cursor.to_json_dict()
    state = mod.Cursor.from_state(cursor.to_state())
    assert state == restored
    full = _host(_dataset(reader, "shuffle"))
    _assert_same(_host(_dataset(reader, "shuffle").iterate(restored)),
                 full[6:])
    np.testing.assert_array_equal(
        tdata.Cursor.from_json_dict(payload).to_state()["cursor"],
        jdata.Cursor.from_json_dict(payload).to_state()["cursor"])


def test_peek_matches_jax_and_consumes_nothing(on_cpu):
    ds = _dataset("port", "shuffle").prefetch(2)
    first = ds.peek()
    assert not first.is_device_resident("features")  # peek skips prefetch
    _assert_same(_host([first]), _host([_dataset("jax", "shuffle").peek()]))
    _assert_same(_host([next(iter(ds))]), _host([first]))
    assert tdata.Dataset.from_arrays(Table({"y": np.zeros(0)}), 4).peek() \
        is None


def test_synthetic_source_matches_jax(on_cpu):
    def make(table_cls):
        def batch(i, rng):
            return table_cls({"x": rng.normal(size=(4, 2)),
                              "i": np.full(4, float(i))})
        return batch

    for shard in (None, (1, 3)):
        port = tdata.Dataset.synthetic(make(Table), 11, seed=5, shard=shard)
        jax = jdata.Dataset.synthetic(make(JaxTable), 11, seed=5, shard=shard)
        _assert_same(_host(port), _host(jax))
        _assert_same(_host(port.iterate_from(2)), _host(jax)[2:])


# -- shard-count mismatches ------------------------------------------------------


def _synthetic(pkg, shard, shuffled=False):
    mod, table_cls = PKGS[pkg]

    def batch(i, rng):
        return table_cls({"i": np.full(3, float(i))})

    ds = mod.Dataset.synthetic(batch, 12, seed=1, shard=shard)
    return ds.shuffle(2, seed=0) if shuffled else ds


def _mismatch_cases(pkg):
    mod = PKGS[pkg][0]
    cols = _columns()
    array4 = mod.Dataset.from_arrays(PKGS[pkg][1](cols), 3, shard=(1, 4))
    array2 = mod.Dataset.from_arrays(PKGS[pkg][1](cols), 3, shard=(1, 2))
    feed = mod.ElasticFeed(lambda s: _synthetic(pkg, s), 2)
    return {
        # A contiguous-block source cannot re-split a 4-way cursor.
        "array_4_to_2": (array2, mod.Cursor(emitted=2, num_shards=4,
                                            shard_index=1)),
        # A global-order (ElasticFeed) cursor into a per-shard Dataset.
        "global_into_dataset": (array4, mod.Cursor(emitted=2, num_shards=4)),
        # A per-shard cursor into an ElasticFeed.
        "shard_into_feed": (feed, mod.Cursor(emitted=2, num_shards=2,
                                             shard_index=0)),
        # A shuffle per shard entangles the order with the shard count.
        "shuffled_synthetic_3_to_2": (
            _synthetic(pkg, (0, 2), shuffled=True),
            mod.Cursor(emitted=2, num_shards=3, shard_index=0)),
    }


@pytest.mark.parametrize("case", ["array_4_to_2", "global_into_dataset",
                                  "shard_into_feed",
                                  "shuffled_synthetic_3_to_2"])
def test_cursor_shard_mismatch_raises_as_jax(case, on_cpu):
    for pkg in ("port", "jax"):
        feed, cursor = _mismatch_cases(pkg)[case]
        with pytest.raises(PKGS[pkg][0].CursorShardMismatchError):
            feed.iterate(cursor)
    assert issubclass(tdata.CursorShardMismatchError, ValueError)


def test_synthetic_reshard_resume_matches_jax(on_cpu):
    """A round-robin source re-splits a cursor written at another shard
    count: the new shard skips its share of the global watermark."""
    for old_world, watermark in ((4, 7), (3, 5)):
        cursor = dict(emitted=watermark // old_world, num_shards=old_world,
                      shard_index=0, global_watermark=watermark)
        for shard in ((0, 2), (1, 2)):
            port = _synthetic("port", shard).iterate(tdata.Cursor(**cursor))
            jax = _synthetic("jax", shard).iterate(jdata.Cursor(**cursor))
            _assert_same(_host(port), _host(jax))
            assert port.cursor().to_json_dict() == jax.cursor().to_json_dict()


# -- CSV and LibSVM --------------------------------------------------------------


def _write_csv(path, rows, seed):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(rows, 4)).round(6)
    data[rng.random(size=data.shape) < 0.1] = np.nan
    lines = ["a,b,c,d"] + [
        ",".join("" if np.isnan(v) else repr(float(v)) for v in row)
        for row in data]
    path.write_text("\n".join(lines) + "\n")
    return data


def _write_libsvm(path, rows, d, seed, nnz=5):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(rows):
        idx = np.sort(rng.choice(d, size=nnz, replace=False)) + 1
        vals = rng.normal(size=nnz).round(5)
        label = int(rng.integers(0, 2)) * 2 - 1
        lines.append(f"{label} " + " ".join(
            f"{i}:{v!r}" for i, v in zip(idx, vals)))
    path.write_text("\n".join(lines) + "\n")


def test_csv_native_equals_python_and_jax(tmp_path):
    path = tmp_path / "part.csv"
    _write_csv(path, 300, seed=3)
    before = _native.PARSES["csv", "native"]
    names, native = t_csv.read_csv(str(path))
    assert _native.PARSES["csv", "native"] == before + 1
    _, python = t_csv.read_csv(str(path), use_native=False)
    _, jax = j_csv.read_csv(str(path))
    assert names == ["a", "b", "c", "d"]
    for other in (python, jax):
        np.testing.assert_array_equal(native, other)
    table = t_csv.read_csv_table(str(path))
    np.testing.assert_array_equal(table.column("c"), native[:, 2])


def test_libsvm_native_equals_python_and_jax(tmp_path):
    path = tmp_path / "part.libsvm"
    _write_libsvm(path, 200, 30, seed=4)
    before = _native.PARSES["libsvm", "native"]
    native = t_libsvm.read_libsvm(str(path))
    assert _native.PARSES["libsvm", "native"] == before + 1
    python = t_libsvm.read_libsvm(str(path), use_native=False)
    jax = j_libsvm.read_libsvm(str(path))
    for other in (python, jax):
        for a, b in zip(native[:4], other[:4]):
            np.testing.assert_array_equal(a, b)
        assert native[4] == other[4]
    x, y = t_libsvm.read_libsvm_dense(str(path), n_features=32)
    jx, jy = j_libsvm.read_libsvm_dense(str(path), n_features=32)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    rows = t_libsvm.read_libsvm_table(str(path)).column("features")
    jrows = j_libsvm.read_libsvm_table(str(path)).column("features")
    for r, jr in zip(rows, jrows):
        np.testing.assert_array_equal(r.indices, jr.indices)
        np.testing.assert_array_equal(r.values, jr.values)


@pytest.mark.parametrize("fmt", ["csv", "libsvm"])
def test_file_sources_match_jax(fmt, tmp_path, on_cpu):
    """A sorted glob of files, batch by batch, resumed at every position
    (the per-file batch counts cached after a first parse)."""
    for i, rows in enumerate((23, 7, 31)):
        path = tmp_path / f"part{i}.{fmt}"
        if fmt == "csv":
            _write_csv(path, rows, seed=i)
        else:
            _write_libsvm(path, rows, 12, seed=i)
    pattern = str(tmp_path / f"part*.{fmt}")

    def ds(mod):
        if fmt == "csv":
            return mod.Dataset.from_csv(pattern, 5)
        return mod.Dataset.from_libsvm(pattern, 5, n_features=12)

    full = _host(ds(tdata))
    _assert_same(full, _host(ds(jdata)))
    for k in range(len(full) + 1):
        _assert_same(_host(ds(tdata).iterate_from(k)), full[k:])
    it = ds(tdata).iterate()
    jit_ = ds(jdata).iterate()
    for _ in range(7):
        next(it)
        next(jit_)
    assert it.cursor().to_json_dict() == jit_.cursor().to_json_dict()
    with pytest.raises(FileNotFoundError):
        tdata.CSVSource(str(tmp_path / "missing*.csv"), 4)


# -- the prefetch tail and the runtime -------------------------------------------


def test_prefetch_batches_equal_host_batches(on_cpu):
    """A prefetched chain delivers the same rows, as bucket-height padded
    columns, and reports its gauges and counters."""
    from flinkml_tpu_torch.utils.metrics import default_registry

    group = "data.prefetch.test_torch_data"
    ds = _dataset("port", "shuffle").prefetch(2, metrics_group=group)
    it = ds.iterate()
    got = list(it)
    for placed, want in zip(got, _host(_dataset("port", "shuffle"))):
        raw = placed._raw_column("features")
        assert isinstance(raw, PaddedDeviceColumn)
        assert raw.buf.shape[0] == 8 and raw.rows == placed.num_rows
        np.testing.assert_array_equal(placed.column("features"),
                                      want["features"])
    snap = default_registry().snapshot()[group]
    assert snap["counters"]["batches_prefetched"] == len(got)
    assert snap["counters"]["rows_prefetched"] == 53
    assert 0.0 <= snap["gauges"]["stall_fraction"] <= 1.0
    assert 0.0 <= it._prefetcher.stall_fraction <= 1.0
    with pytest.raises(ValueError, match="LAST"):
        ds.map(_scale)
    with pytest.raises(ValueError, match="already"):
        ds.prefetch()


def test_prefetcher_raises_the_source_error_and_stops(on_cpu):
    def bad(i, rng):
        if i == 3:
            raise RuntimeError("source failed at 3")
        return Table({"x": np.ones(2)})

    it = tdata.Dataset.synthetic(bad, 6).prefetch(2).iterate()
    assert len([next(it) for _ in range(3)]) == 3
    with pytest.raises(RuntimeError, match="source failed at 3"):
        next(it)
    it.close()
    it._prefetcher._thread.join(timeout=5)
    assert not it._prefetcher._thread.is_alive()


def test_iterate_checkpoints_the_cursor_and_resumes(tmp_path, on_cpu):
    """``iterate`` over a Dataset writes its cursor into every snapshot's
    extra — the same JSON as the JAX runtime's on the same run — and a
    resumed run reopens the feed from it: the same states as the
    uninterrupted run."""
    from flinkml_tpu.iteration import (
        CheckpointManager as JaxCheckpointManager,
    )
    from flinkml_tpu.iteration import IterationConfig as JaxConfig
    from flinkml_tpu.iteration import TerminateOnMaxIter as JaxMaxIter
    from flinkml_tpu.iteration import iterate as jax_iterate

    def step(state, batch, epoch):
        return state + float(np.asarray(batch.column("y")).sum()), None

    def run(pkg, directory, max_iter=None, resume=False):
        mod = PKGS[pkg][0]
        if pkg == "port":
            mgr = CheckpointManager(str(directory), max_to_keep=20)
            cfg = IterationConfig(TerminateOnMaxIter(max_iter or 10**6),
                                  checkpoint_interval=2,
                                  checkpoint_manager=mgr)
            return iterate(step, 0.0, _dataset(pkg, "shuffle"), cfg,
                           resume=resume), mgr
        mgr = JaxCheckpointManager(str(directory), max_to_keep=20,
                                   world_size=1)
        cfg = JaxConfig(JaxMaxIter(max_iter or 10**6),
                        checkpoint_interval=2, checkpoint_manager=mgr)
        del mod
        return jax_iterate(step, 0.0, _dataset(pkg, "shuffle"), cfg,
                           resume=resume), mgr

    whole, mgr = run("port", tmp_path / "whole")
    _, jmgr = run("jax", tmp_path / "jax")
    assert mgr.all_epochs() == jmgr.all_epochs()
    for epoch in mgr.all_epochs():
        assert mgr.read_extra(epoch) == jmgr.read_extra(epoch)
    assert mgr.read_extra(4)["data_cursor"]["emitted"] == 4
    stopped, _ = run("port", tmp_path / "stop", max_iter=5)
    assert stopped.epochs == 5
    resumed, _ = run("port", tmp_path / "stop", resume=True)
    assert resumed.state == whole.state
    assert resumed.epochs == whole.epochs - 5


def test_dataset_feeds_the_streamed_fit(on_cpu):
    """``LogisticRegression().fit(dataset)``: the same model as the list of
    the Dataset's batches, and as the JAX package's streamed fit of them."""
    from flinkml_tpu.models.logistic_regression import (
        LogisticRegression as JaxLR,
    )
    from flinkml_tpu.parallel import DeviceMesh
    import jax

    rng = np.random.default_rng(2)
    x = rng.normal(size=(96, 4)).astype(np.float32)
    cols = {"features": x, "label": (x[:, 0] > 0).astype(np.float64)}

    def est(cls, **kw):
        return cls(**kw).set_max_iter(4).set_tol(0.0).set_learning_rate(0.3)

    ds = tdata.Dataset.from_arrays(Table(cols), 16).shuffle(3, seed=4)
    got = est(fml.LogisticRegression).fit(ds).coefficient
    listed = est(fml.LogisticRegression).fit(list(ds)).coefficient
    np.testing.assert_array_equal(got, listed)
    prefetched = est(fml.LogisticRegression).fit(ds.prefetch(2)).coefficient
    np.testing.assert_array_equal(prefetched, got)
    jds = jdata.Dataset.from_arrays(JaxTable(cols), 16).shuffle(3, seed=4)
    want = est(JaxLR, mesh=DeviceMesh(devices=jax.devices()[:1])).fit(
        jds).coefficient
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
