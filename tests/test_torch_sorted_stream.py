"""The sorted-column stream in the port against the JAX package, on the
CPU: the pack-time sort tables (``ops.sparse.ell_sort_tables``,
``pack_sorted_sparse_column``), ``SortedSparseColumn``, the prefetcher's
``pad_place_table``, and ``train_linear_model_sorted_stream`` fed by a
prefetched ``Dataset``.

The JAX package's own ``pad_place_table`` needs ``jax.experimental.
enable_x64``, which jax 0.9.0 does not have, so its reference tables are
built with ``flinkml_tpu.ops.sparse.pack_sorted_sparse_column`` and
``PaddedDeviceColumn(jnp.asarray(y), n)`` directly.

Declared tolerances: the sort tables and the packed blocks are exact (they
fix the sorted ``segment_sum``'s addition order); the trained coefficient
1e-6 relative to the largest in float32 and 1e-12 in float64 (the JAX
step's sums and products run in another order); the sorted stream against
the port's CSR stream on the same batches 1e-6.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

import flinkml_tpu_torch as fml
import flinkml_tpu_torch.data as tdata
from flinkml_tpu.linalg import SparseVector as JaxSparseVector
from flinkml_tpu.models import _linear_sgd as j_sgd
from flinkml_tpu.ops import sparse as j_sparse
from flinkml_tpu.table import PaddedDeviceColumn as JaxPadded
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch.data.ops import HashOp
from flinkml_tpu_torch.data.prefetch import pad_place_table
from flinkml_tpu_torch.linalg import SparseVector
from flinkml_tpu_torch.models import _linear_sgd as t_sgd
from flinkml_tpu_torch.ops import sparse as t_sparse
from flinkml_tpu_torch.table import PaddedDeviceColumn, SortedSparseColumn, Table
from tests._torch_port_common import on_cpu  # noqa: F401

DIM = 40
F32_REL = 1e-6
F64_REL = 1e-12


def _rows(n, seed=0, dim=DIM, max_nnz=9, vector=SparseVector):
    """Seeded SparseVector rows (some empty), the same in both packages."""
    rng = np.random.default_rng(seed)
    out = np.empty(n, dtype=object)
    for r in range(n):
        k = int(rng.integers(0, max_nnz + 1))
        idx = np.sort(rng.choice(dim, size=k, replace=False))
        out[r] = vector(dim, idx, rng.normal(size=k))
    return out


def _port_col(col: SortedSparseColumn):
    return {name: t.numpy() for name, t in zip(
        ("values", "indices", "indptr", "perm", "segment_ids"),
        col.tensors())}


def _jax_col(col):
    return {"values": np.asarray(col.buf), "indices": np.asarray(col.indices),
            "indptr": np.asarray(col.indptr), "perm": np.asarray(col.perm),
            "segment_ids": np.asarray(col.segment_ids)}


@pytest.mark.parametrize("n,bucket", [(1, None), (13, None), (13, 64),
                                      (100, None)])
def test_pack_sorted_column_equals_jax(n, bucket, on_cpu):
    port = t_sparse.pack_sorted_sparse_column(_rows(n), bucket=bucket)
    jax = j_sparse.pack_sorted_sparse_column(
        _rows(n, vector=JaxSparseVector), bucket=bucket)
    got, want = _port_col(port), _jax_col(jax)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert (port.dim, port.rows, port.buf.shape) == \
        (jax.dim, jax.rows, tuple(jax.buf.shape))
    assert port.indices_are_sorted
    assert np.all(np.diff(got["segment_ids"]) >= 0)


def test_ell_sort_tables_equal_jax():
    rng = np.random.default_rng(5)
    for shape in ((1, 1), (8, 4), (64, 16), (1000, 64)):
        block = rng.integers(0, 50, size=shape).astype(np.int32)
        block[:, -1] = 0  # padding cells sort to the front, stably
        got = t_sparse.ell_sort_tables(block)
        want = j_sparse.ell_sort_tables(block)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_sorted_column_checks_and_to_host(on_cpu):
    rows = _rows(11, seed=2)
    col = t_sparse.pack_sorted_sparse_column(rows)
    assert col.to_host() is not None
    assert all(a is b for a, b in zip(col.to_host(), rows))
    # A column built without host rows rebuilds them from its blocks, as
    # the JAX column does.
    bare = SortedSparseColumn(*col.tensors(), col.dim, col.rows)
    jcol = j_sparse.pack_sorted_sparse_column(
        _rows(11, seed=2, vector=JaxSparseVector))
    jbare = type(jcol)(jcol.buf, jcol.indices, jcol.indptr, jcol.perm,
                       jcol.segment_ids, jcol.dim, jcol.rows)
    for got, want, orig in zip(bare.to_host(), jbare.to_host(), rows):
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.values, want.values)
        np.testing.assert_array_equal(got.indices, orig.indices)
    values, indices, indptr, perm, seg = col.tensors()
    with pytest.raises(ValueError, match="indices shape"):
        SortedSparseColumn(values, indices[:, :1], indptr, perm, seg, DIM, 11)
    with pytest.raises(ValueError, match="indptr shape"):
        SortedSparseColumn(values, indices, indptr[:-1], perm, seg, DIM, 11)
    with pytest.raises(ValueError, match="flat"):
        SortedSparseColumn(values, indices, indptr, perm[:-1], seg, DIM, 11)
    with pytest.raises(ValueError, match="out of range"):
        t_sparse.pack_sorted_sparse_column(
            [SparseVector._from_sorted(4, np.array([7]), np.array([1.0]))])


def test_pad_place_table_is_numpy_padding(on_cpu):
    """Dense columns become bucket-height padded columns with their dtype
    kept and zeros below the rows; SparseVector rows become a sorted
    column; other object columns stay on the host."""
    rng = np.random.default_rng(1)
    n = 13
    ragged = np.empty(n, dtype=object)
    for i in range(n):
        ragged[i] = list(range(i % 3))
    cols = {"f32": rng.normal(size=(n, 3)).astype(np.float32),
            "f64": rng.normal(size=n),
            "i32": np.arange(n, dtype=np.int32),
            "i64": np.arange(n, dtype=np.int64) * 7,
            "flag": rng.random(n) > 0.5,
            "sparse": _rows(n, seed=4),
            "ragged": ragged}
    placed = pad_place_table(Table(cols))
    assert placed.num_rows == n
    for name in ("f32", "f64", "i32", "i64", "flag"):
        raw = placed._raw_column(name)
        assert isinstance(raw, PaddedDeviceColumn) and raw.rows == n
        want = np.concatenate([cols[name], np.zeros(
            (16 - n,) + cols[name].shape[1:], cols[name].dtype)])
        got = raw.buf.numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(placed.column(name), cols[name])
    sparse = placed._raw_column("sparse")
    assert isinstance(sparse, SortedSparseColumn)
    assert sparse.buf.shape[0] == 16 and sparse.rows == n
    assert placed._raw_column("ragged") is cols["ragged"]


# -- the trainer ----------------------------------------------------------------


def _batches(n_batches=4, rows=24, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=DIM)
    out = []
    for b in range(n_batches):
        vecs = _rows(rows, seed=100 * seed + b)
        dots = np.array([float(v.values @ true[v.indices]) for v in vecs])
        y = (dots > 0).astype(np.float64)
        w = rng.uniform(0.5, 2.0, size=rows) if weighted else None
        out.append((vecs, y, w))
    return out


def _tables(batches, pkg, dtype):
    """Device tables with a sorted feature column, built in ``pkg``."""
    tables = []
    for vecs, y, w in batches:
        n = len(vecs)
        bucket = 32
        if pkg == "port":
            cols = {"features": t_sparse.pack_sorted_sparse_column(
                vecs, bucket=bucket, dtype=dtype)}
            pad = np.zeros(bucket - n)
            cols["label"] = PaddedDeviceColumn(
                fml.iteration.datacache.device_put(np.concatenate([y, pad])),
                n)
            if w is not None:
                cols["weight"] = PaddedDeviceColumn(
                    fml.iteration.datacache.device_put(
                        np.concatenate([w, pad])), n)
            tables.append(Table(cols))
        else:
            jvecs = [JaxSparseVector(v.size(), v.indices, v.values)
                     for v in vecs]
            cols = {"features": j_sparse.pack_sorted_sparse_column(
                jvecs, bucket=bucket, dtype=dtype)}
            pad = np.zeros(bucket - n)
            cols["label"] = JaxPadded(jnp.asarray(np.concatenate([y, pad])), n)
            if w is not None:
                cols["weight"] = JaxPadded(
                    jnp.asarray(np.concatenate([w, pad])), n)
            tables.append(JaxTable(cols))
    return tables


def _hyper(loss, dtype):
    return dict(loss=loss, max_iter=6, learning_rate=0.3, reg=0.02,
                elastic_net=0.3, tol=0.0, dtype=dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("loss", ["logistic", "hinge", "squared"])
def test_sorted_stream_matches_jax(loss, dtype, on_cpu):
    for weighted in (False, True):
        batches = _batches(weighted=weighted)
        wcol = "weight" if weighted else None
        got = t_sgd.train_linear_model_sorted_stream(
            _tables(batches, "port", dtype), "features", "label", wcol,
            **_hyper(loss, dtype))
        want = np.asarray(j_sgd.train_linear_model_sorted_stream(
            _tables(batches, "jax", dtype), "features", "label", wcol,
            **_hyper(loss, dtype)))
        assert got.dtype == want.dtype == dtype
        rel = F32_REL if dtype == np.float32 else F64_REL
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("name", ["LogisticRegression", "LinearSVC",
                                  "LinearRegression"])
def test_prefetched_dataset_fit_takes_the_sorted_stream(name, monkeypatch,
                                                        on_cpu):
    """``fit(Dataset....prefetch())`` over SparseVector rows routes each
    streamed linear estimator to the sorted stream, with no change of its
    own, and equals its CSR stream (the same Dataset without its prefetch)
    within 1e-6."""
    batches = _batches(n_batches=5, rows=30, seed=3)
    vecs = np.concatenate([b[0] for b in batches])
    y = np.concatenate([b[1] for b in batches])
    ds = tdata.Dataset.from_arrays(Table({"features": vecs, "label": y}), 30)

    calls = []
    original = t_sgd.train_linear_model_sorted_stream

    def spy(*args, **kwargs):
        calls.append(args)
        return original(*args, **kwargs)

    monkeypatch.setattr(t_sgd, "train_linear_model_sorted_stream", spy)

    def est():
        return (getattr(fml, name)().set_max_iter(5).set_tol(0.0)
                .set_learning_rate(0.4).set_reg(0.01))

    sorted_coef = est().fit(ds.prefetch(2)).coefficient
    assert len(calls) == 1
    csr_coef = est().fit(ds).coefficient
    assert len(calls) == 1
    np.testing.assert_allclose(sorted_coef, csr_coef, rtol=0,
                               atol=1e-6 * np.abs(csr_coef).max())
    if name != "LinearRegression":
        with pytest.raises(ValueError, match="labels"):
            est().fit(tdata.Dataset.from_arrays(
                Table({"features": vecs, "label": y * 3}), 30).prefetch(2))


# -- refusals --------------------------------------------------------------------


def test_refusals(tmp_path, on_cpu):
    """Checkpointing on the sorted stream (``ValueError``, as the JAX
    package), ``HashOp`` and ``hash_column`` (item 9); ``mesh=`` shards
    are ported with the multi-process streams (item 7c): one process, a
    mesh reads the single shard, as the JAX package's (P ranks in
    ``tests/test_torch_stream_mp.py``)."""
    batches = _batches(n_batches=2)
    for kw in (dict(checkpoint_manager=object()), dict(resume=True),
               dict(checkpoint_interval=2)):
        for sgd, pkg in ((t_sgd, "port"), (j_sgd, "jax")):
            with pytest.raises(ValueError, match="checkpoint/resume"):
                sgd.train_linear_model_sorted_stream(
                    _tables(batches, pkg, np.float32), "features", "label",
                    **_hyper("logistic", np.float32), **kw)
    with pytest.raises(ValueError, match="not a SortedSparseColumn"):
        t_sgd.train_linear_model_sorted_stream(
            [Table({"features": np.ones((3, 2)), "label": np.ones(3)})],
            "features", "label", **_hyper("logistic", np.float32))
    with pytest.raises(NotImplementedError, match="item 9"):
        HashOp(None)
    ds = tdata.Dataset.from_arrays(Table({"k": np.arange(4)}), 2)
    with pytest.raises(NotImplementedError, match="item 9"):
        ds.hash_column("k", seed=0, num_buckets=8)
    from flinkml_tpu.data import source as jax_source
    from flinkml_tpu.parallel import DeviceMesh as JaxMesh
    from flinkml_tpu_torch.parallel import DeviceMesh

    assert tdata.resolve_shard(None, mesh=DeviceMesh()) == \
        jax_source.resolve_shard(None, mesh=JaxMesh()) == (0, 1)
    meshed = list(tdata.Dataset.from_arrays(Table({"k": np.arange(4)}), 2,
                                            mesh=DeviceMesh()))
    assert [t.column("k").tolist() for t in meshed] == [[0, 1], [2, 3]]
    with pytest.raises(TypeError, match="DeviceMesh"):
        tdata.resolve_shard(None, mesh=object())
