"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips (from a fixture, at run time)
without one. The file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu_torch import pipeline_fusion
from flinkml_tpu_torch.kernels import chain as kchain
from flinkml_tpu_torch.kernels import segsum as ksegsum
from flinkml_tpu_torch.kernels import spmv as kspmv
from flinkml_tpu_torch.kernels import topk as ktopk
from flinkml_tpu_torch.models import _linear_sgd
from flinkml_tpu_torch.models import kmeans as _kmeans
from tests._segsum_ids import sorted_id_patterns

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, or a skip (decided here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _ell(rows, width, dim, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(rows, width)).astype(np.int32)
    val = rng.normal(size=(rows, width))
    pad = rng.random(size=(rows, width)) < 0.2
    idx[pad], val[pad] = 0, 0.0
    return idx, val, rng.normal(size=dim)


def _five_stage(rows, d=6, seed=0):
    """The five-stage chain with statistics from float64 numpy, and its
    input (one constant feature exercises the zero guards)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)) * 2.0 + 1.0
    x[:, -1] = 2.5
    t = fml.Table({"features": x})
    stages, prev = [], "features"
    for i, cls in enumerate((fml.StandardScaler, fml.MinMaxScaler,
                             fml.MaxAbsScaler, fml.RobustScaler), start=1):
        with fml.use_device("cpu"):
            m = cls().set(cls.INPUT_COL, prev).set(cls.OUTPUT_COL, f"s{i}")
            m = m.fit(t)
            (t,) = m.transform(t)
        stages.append(m)
        prev = f"s{i}"
    lr = fml.LogisticRegressionModel().set(
        fml.LogisticRegressionModel.FEATURES_COL, prev)
    lr.set_model_data(fml.Table({"coefficient": rng.normal(size=(1, d))}))
    return fml.PipelineModel(stages + [lr]), x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmv_kernel_matches_plain(cuda_device, dtype):
    idx, val, w = _ell(1000, 39, 100_000, seed=1)
    idx = torch.from_numpy(idx).to(cuda_device)
    val = torch.from_numpy(val).to(cuda_device, dtype)
    w = torch.from_numpy(w).to(cuda_device, dtype)
    before = kspmv.LAUNCHES.count
    got = kspmv.spmv(idx, val, w)
    torch.cuda.synchronize()
    assert kspmv.LAUNCHES.count == before + 1
    torch.testing.assert_close(got, kspmv.spmv_plain(idx, val, w),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(fml.KernelUnsupportedError):
        kspmv.spmv(idx, val.half(), w.half())
    with pytest.raises(fml.KernelUnsupportedError):
        kspmv.spmv(idx.long(), val, w)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_chain_kernel_matches_plain(cuda_device, dtype, tol):
    model, x = _five_stage(1000, seed=2)
    kernels = [s.transform_kernel() for s in model.stages]
    xp = torch.zeros((1024, x.shape[1]), dtype=dtype, device=cuda_device)
    xp[:1000] = torch.from_numpy(x).to(cuda_device, dtype)
    consts = [k.constants for k in kernels]
    for outs in (["s4", "prediction", "rawPrediction"], ["s1"], ["s3"]):
        got = kchain.ChainProgram(kernels, ["features"], outs)(
            [xp], consts, 1000)
        want = kchain.chain_plain(kernels, ["features"], outs, [xp], consts,
                                  1000)
        torch.cuda.synchronize()
        for c in outs:
            if c != "prediction":
                torch.testing.assert_close(got[c][:1000], want[c][:1000],
                                           rtol=tol, atol=tol)


def test_pipeline_fused_matches_per_stage(cuda_device):
    model, x = _five_stage(3000, seed=3)
    table = fml.Table({"features": x})
    pipeline_fusion.reset_cache()
    with fml.use_device(cuda_device):
        fml.reset_launch_counts()
        (fused,) = model.transform(table)
        got = {c: fused.column(c) for c in ("s2", "s4", "rawPrediction")}
        assert fml.launch_counts()["fused_chain"] == 2   # eager + lazy s2
        pipeline_fusion.set_enabled(False)
        try:
            (per_stage,) = model.transform(table)
        finally:
            pipeline_fusion.set_enabled(True)
    for c, tol in (("s2", 1e-12), ("s4", 1e-12), ("rawPrediction", 1e-10)):
        np.testing.assert_allclose(got[c], per_stage.column(c), rtol=tol,
                                   atol=tol)


def test_sparse_lr_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(4)
    rows = np.empty(500, dtype=object)
    for r in range(500):
        k = int(rng.integers(1, 40))
        rows[r] = fml.SparseVector(5000, rng.choice(5000, k, replace=False),
                                   rng.normal(size=k))
    model = fml.LogisticRegressionModel()
    model.set_model_data(fml.Table({"coefficient": rng.normal(size=(1, 5000))}))
    table = fml.Table({"features": rows})
    fml.reset_launch_counts()
    with fml.use_device(cuda_device):
        (gpu,) = model.transform(table)
    assert fml.launch_counts()["spmv"] >= 1
    with fml.use_device("cpu"):
        (cpu,) = model.transform(table)
    np.testing.assert_allclose(gpu.column("rawPrediction"),
                               cpu.column("rawPrediction"), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("sorted_ids", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("k", [None, 16])
def test_segment_sum_kernel_matches_plain(cuda_device, sorted_ids, dtype, tol,
                                          k):
    """Both paths against ``index_add_`` (atomics reorder the adds: within
    ``tol``); the sorted path also bit for bit against the in-order sum."""
    rng = np.random.default_rng(5)
    cells, nseg = 50_000, 3_000
    ids = rng.integers(0, nseg, size=cells).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    values = rng.normal(size=(cells,) if k is None else (cells, k))
    tv = torch.from_numpy(values).to(cuda_device, dtype)
    ti = torch.from_numpy(ids).to(cuda_device)
    before = ksegsum.LAUNCHES.count
    got = ksegsum.segment_sum(tv, ti, nseg, indices_are_sorted=sorted_ids)
    torch.cuda.synchronize()
    assert ksegsum.LAUNCHES.count == before + 1
    torch.testing.assert_close(got, ksegsum.segment_sum_plain(tv, ti, nseg),
                               rtol=tol, atol=tol)
    if sorted_ids:
        want = np.zeros((nseg,) + values.shape[1:], tv.cpu().numpy().dtype)
        np.add.at(want, ids, tv.cpu().numpy())
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    with pytest.raises(fml.KernelUnsupportedError):
        ksegsum.segment_sum(tv.half(), ti, nseg)
    with pytest.raises(fml.KernelUnsupportedError):
        ksegsum.segment_sum(tv, ti.long(), nseg)
    empty = ksegsum.segment_sum(tv[:0], ti[:0], nseg)
    assert ksegsum.LAUNCHES.count == before + 1 and not empty.any()


def _segsum_operands(device, ids, k, dtype, offsets, seed):
    """ids and values on the card as views ``offsets = (ids, values)``
    elements (rows) into their buffers, so the 16-byte phase logic runs."""
    rng = np.random.default_rng(seed)
    id_off, val_off = offsets
    cells = ids.size
    id_buf = np.zeros(cells + id_off, np.int32)
    id_buf[id_off:] = ids
    shape = (cells + val_off,) if k is None else (cells + val_off, k)
    val_buf = rng.normal(size=shape)
    ti = torch.from_numpy(id_buf).to(device)[id_off:]
    tv = torch.from_numpy(val_buf).to(device, dtype)[val_off:]
    return tv, ti


def _poison(shape, dtype, device):
    """A freed block of the output's size full of NaN: an element the
    kernel does not write reads NaN."""
    torch.full(shape, float("nan"), dtype=dtype, device=device)
    torch.cuda.synchronize()


@pytest.mark.parametrize("pattern", sorted(sorted_id_patterns()))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [None, 16])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 3), (1, 3)])
def test_segment_sum_sorted_bitwise_every_element_written(
        cuda_device, pattern, dtype, k, offsets):
    """The sorted path equals the in-order sum bit for bit, gaps included,
    on an output block poisoned with NaN (no memset: every element is
    written once), on views off the 16-byte phase."""
    ids, nseg = sorted_id_patterns()[pattern]
    tv, ti = _segsum_operands(cuda_device, ids, k, dtype, offsets, seed=1)
    _poison((nseg,) + tuple(tv.shape[1:]), dtype, cuda_device)
    before = ksegsum.LAUNCHES.count
    got = ksegsum.segment_sum(tv, ti, nseg, indices_are_sorted=True)
    torch.cuda.synchronize()
    assert ksegsum.LAUNCHES.count == before + 1
    want = np.zeros((nseg,) + tuple(tv.shape[1:]), tv.cpu().numpy().dtype)
    np.add.at(want, ids, tv.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    again = ksegsum.segment_sum(tv, ti, nseg, indices_are_sorted=True)
    assert torch.equal(got, again)


def _unsorted_reference(ids, vals, nseg, tol, u):
    """The float64 in-order sum of ``vals`` (host, float64) per segment, and
    the bound a float32/float64 sum of them in any order stays within:
    ``tol * (1 + |sum|)``, or for a long segment ``8 u sqrt(n) sqrt(sum
    v^2)`` — about 20 standard deviations of the rounding error of n
    additions in a random order of mean-zero terms, and far below one
    |v| of the segment."""
    shape = (nseg,) + vals.shape[1:]
    ref, sq = np.zeros(shape), np.zeros(shape)
    np.add.at(ref, ids, vals)
    np.add.at(sq, ids, vals * vals)
    n = np.bincount(ids, minlength=nseg).reshape((-1,) + (1,) * (vals.ndim - 1))
    bound = np.maximum(tol * (1 + np.abs(ref)), 8 * u * np.sqrt(n * sq))
    return ref, bound


@pytest.mark.parametrize("pattern", sorted(sorted_id_patterns()))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("k", [None, 16])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 3), (1, 3)])
def test_segment_sum_unsorted_patterns_match_plain(cuda_device, pattern, dtype,
                                                   tol, k, offsets):
    """The unsorted path (the ids shuffled) and ``index_add_`` each against
    the float64 sum of the same values, within ``_unsorted_reference``'s
    bound, on the same id patterns and views; the same result with one
    cell of the longest segment dropped (the cell of median |v|) falls
    outside the bound."""
    ids, nseg = sorted_id_patterns()[pattern]
    ids = np.random.default_rng(2).permutation(ids)
    tv, ti = _segsum_operands(cuda_device, ids, k, dtype, offsets, seed=3)
    got = ksegsum.segment_sum(tv, ti, nseg)
    want = ksegsum.segment_sum_plain(tv, ti, nseg)
    torch.cuda.synchronize()
    vals = tv.cpu().numpy().astype(np.float64)
    ref, bound = _unsorted_reference(ids, vals, nseg, tol,
                                     float(torch.finfo(dtype).eps) / 2)
    for name, res in (("kernel", got), ("index_add_", want)):
        err = np.abs(res.cpu().numpy().astype(np.float64) - ref)
        assert (err <= bound).all(), (name, float((err - bound).max()))
    # A dropped reduction must show: remove the median-|v| cell of the
    # longest segment from the kernel's result.
    seg = int(np.bincount(ids).argmax())
    cells = np.flatnonzero(ids == seg)
    first = np.abs(vals[cells] if k is None else vals[cells, 0])
    cell = cells[np.argsort(first)[cells.size // 2]]
    dropped = got.cpu().numpy().astype(np.float64)
    where = seg if k is None else (seg, 0)
    dropped[where] -= vals[cell] if k is None else vals[cell, 0]
    assert abs(dropped[where] - ref[where]) > bound[where]


@pytest.mark.parametrize("d", [1, 7, 32, 33, 123, 1000])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("aligned", [True, False])
def test_chain_kernel_routes_match_plain(cuda_device, d, dtype, tol, aligned):
    """Both routes against the plain chain at widths on and off the
    vector route, on 1,001 rows (not a multiple of any warp's rows); a
    view one element into its buffer takes the scalar route."""
    rows = 1001
    model, x = _five_stage(rows, d=d, seed=d)
    kernels = [s.transform_kernel() for s in model.stages]
    buf = torch.zeros(rows * d + 1, dtype=dtype, device=cuda_device)
    start = 0 if aligned else 1
    xp = buf[start:start + rows * d].view(rows, d)
    xp.copy_(torch.from_numpy(x).to(cuda_device, dtype))
    vector = d * xp.element_size() % 16 == 0 and d * xp.element_size() <= 512
    assert kchain.route(d, xp.element_size(), xp.data_ptr()) == (
        "vector" if aligned and vector else "scalar")
    consts = [k.constants for k in kernels]
    outs = ["s4", "prediction", "rawPrediction"]
    got = kchain.ChainProgram(kernels, ["features"], outs)([xp], consts, rows)
    want = kchain.chain_plain(kernels, ["features"], outs, [xp], consts, rows)
    torch.cuda.synchronize()
    for c in ("s4", "rawPrediction"):
        torch.testing.assert_close(got[c], want[c], rtol=tol, atol=tol)
    dot = want["s4"].double() @ torch.from_numpy(
        consts[-1]["coefficient"].reshape(-1)).to(cuda_device, torch.float64)
    decisive = dot.abs() > 1e-4
    assert torch.equal(got["prediction"][decisive],
                       want["prediction"][decisive])


def test_segment_sum_atomic_path_refused_when_deterministic(cuda_device):
    tv = torch.ones(10, device=cuda_device)
    ti = torch.zeros(10, dtype=torch.int32, device=cuda_device)
    torch.use_deterministic_algorithms(True)
    try:
        with pytest.raises(fml.KernelUnsupportedError, match="sorted"):
            ksegsum.segment_sum(tv, ti, 3)
        out = ksegsum.segment_sum(tv, ti, 3, indices_are_sorted=True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert out.tolist() == [10.0, 0.0, 0.0]


def test_dense_fit_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3000, 12)).astype(np.float32)
    y = (x @ rng.normal(size=12) > 0).astype(np.float32)
    table = fml.Table({"features": x, "label": y})
    est = (fml.LogisticRegression().set_seed(1).set_global_batch_size(512)
           .set_tol(0.0).set_learning_rate(0.5))
    with fml.use_device(cuda_device):
        gpu = est.fit(table).coefficient
    with fml.use_device("cpu"):
        cpu = est.fit(table).coefficient
    np.testing.assert_allclose(gpu, cpu, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["unsorted", "sorted"])
def test_sparse_fit_on_card_matches_cpu(cuda_device, layout):
    rng = np.random.default_rng(7)
    n, dim = 2000, 5000
    nnz = rng.integers(1, 40, size=n)
    indptr = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    indices = rng.integers(0, dim, size=indptr[-1]).astype(np.int32)
    values = rng.normal(size=indptr[-1]).astype(np.float32)
    y = rng.integers(0, 2, size=n).astype(np.float32)
    w = np.ones(n, dtype=np.float32)
    args = (indptr, indices, values, dim, y, w, "logistic", 10, 0.5, 700,
            0.001, 0.0, 0.0, 3)
    fml.reset_launch_counts()
    with fml.use_device(cuda_device):
        gpu = _linear_sgd.train_linear_model_sparse_csr(*args, layout=layout)
    counts = fml.launch_counts()
    assert counts["segment_sum"] >= 10 and counts["spmv"] >= 10
    with fml.use_device("cpu"):
        cpu = _linear_sgd.train_linear_model_sparse_csr(*args, layout=layout)
    np.testing.assert_allclose(gpu, cpu, rtol=1e-5, atol=1e-6)


def _topk_rows(shape, seed=0):
    """Integer values (duplicates), +0/-0, an all--inf run, NaN of both
    signs, a constant run, ascending and descending runs: nine such rows,
    flattened and cut to ``shape``."""
    n = -(-int(np.prod(shape)) // 9)
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=(9, n)).astype(np.float64)
    x[0, ::2], x[0, 1::2] = 0.0, -0.0
    x[1] = -np.inf
    x[2, ::5] = np.nan
    x[2, 1::7] = -np.nan
    x[3] = 1.5
    x[4] = np.arange(n)
    x[5] = -np.arange(n)
    return x.reshape(-1)[:int(np.prod(shape))].reshape(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 5, 64, 128, 129, 1000, 20_000, "n"])
@pytest.mark.parametrize("shape", [(9, 300), (300,), (3, 70_000),
                                   (200_000,), (300, 60_000),
                                   (300, 60_001)])
def test_topk_kernel_matches_plain_bitwise(cuda_device, dtype, k, shape):
    """Every route: short rows (fused), few long rows split into segments
    and k past one shared-memory sort (radix, in bands), many long rows
    with small k (scan: 16-byte loads, and single loads where rows are not
    16-byte aligned); k capped at n."""
    n = shape[-1]
    k = n if k == "n" else min(k, n)
    host = _topk_rows(shape, seed=k)
    rows = 1 if len(shape) == 1 else shape[0]
    item = torch.empty(0, dtype=dtype).element_size()
    route = ktopk.route(rows, n, k, item)
    if n <= 300:
        assert route == "fused"
    elif rows < ktopk.TARGET_BLOCKS:
        assert route == "radix" and ktopk.segments(rows, n) > 1
    x = torch.from_numpy(host).to(cuda_device, dtype)
    before = ktopk.LAUNCHES.count
    got_v, got_i = ktopk.top_k(x, k)
    torch.cuda.synchronize()
    assert ktopk.LAUNCHES.count == before + 1
    want_v, want_i = ktopk.top_k_plain(x, k)
    view = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v.view(view), want_v.view(view))


def test_topk_kernel_refusals(cuda_device):
    x = torch.zeros(4, 300, device=cuda_device)
    for bad, k in ((x.int(), 5), (x.half(), 5), (x, 0),
                   (x[:, :3], 4), (x[None], 5)):
        with pytest.raises(fml.KernelUnsupportedError):
            ktopk.top_k(bad, k)


def test_knn_on_card_matches_cpu(cuda_device, monkeypatch):
    rng = np.random.default_rng(8)
    x = rng.integers(0, 4, size=(3000, 16)).astype(np.float32)
    y = rng.integers(0, 5, size=3000).astype(np.float64)
    q = fml.Table({"features": rng.integers(0, 4, size=(900, 16))
                   .astype(np.float32)})
    model = fml.Knn().set_k(7).fit(fml.Table({"features": x, "label": y}))
    monkeypatch.setattr(fml.KnnModel, "CHUNK", 256)
    fml.reset_launch_counts()
    with fml.use_device(cuda_device):
        (gpu,) = model.transform(q)
    assert fml.launch_counts()["topk"] == 4
    with fml.use_device("cpu"):
        (cpu,) = model.transform(q)
    np.testing.assert_array_equal(gpu.column("prediction"),
                                  cpu.column("prediction"))


def test_knn_k_200_on_card_matches_cpu(cuda_device, monkeypatch):
    """k past the old kernel's 128 kept pairs, against 60,000 train rows
    (a row of distances does not fit shared memory, and the scan route
    takes k <= 12: the radix route), in chunks of 300 rows and in one of
    900."""
    rng = np.random.default_rng(10)
    x = rng.integers(0, 4, size=(60_000, 16)).astype(np.float32)
    y = rng.integers(0, 5, size=60_000).astype(np.float64)
    q = fml.Table({"features": rng.integers(0, 4, size=(900, 16))
                   .astype(np.float32)})
    model = fml.Knn().set_k(200).fit(fml.Table({"features": x, "label": y}))
    assert ktopk.route(300, 60_000, 200, 4) == "radix"
    with fml.use_device("cpu"):
        (cpu,) = model.transform(q)
    for chunk in (300, 4096):
        monkeypatch.setattr(fml.KnnModel, "CHUNK", chunk)
        fml.reset_launch_counts()
        with fml.use_device(cuda_device):
            (gpu,) = model.transform(q)
        assert fml.launch_counts()["topk"] == -(-900 // chunk)
        np.testing.assert_array_equal(gpu.column("prediction"),
                                      cpu.column("prediction"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("width", [1, 7, 39, 40, 1000, 3000])
@pytest.mark.parametrize("start", [0, 1, 3])
def test_spmv_kernel_widths_views_and_repeatable(cuda_device, dtype, width,
                                                 start):
    """At every width the packer picks (and one wider than a tile), on a
    bucket view starting at row ``start`` (cells off the 16-byte phase):
    within 1e-5 of plain, and two launches give the same bits."""
    idx, val, w = _ell(700, width, 50_000, seed=width)
    idx = torch.from_numpy(idx).to(cuda_device)[start:]
    val = torch.from_numpy(val).to(cuda_device, dtype)[start:]
    w = torch.from_numpy(w).to(cuda_device, dtype)
    assert (kspmv.vector_phase(idx, val) == 0) == (start * width % 4 == 0)
    got = kspmv.spmv(idx, val, w)
    again = kspmv.spmv(idx, val, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, kspmv.spmv_plain(idx, val, w),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)


def test_kmeans_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(9)
    centers = rng.normal(size=(6, 8)) * 10.0
    x = np.concatenate([rng.normal(size=(500, 8)) + c for c in centers])
    table = fml.Table({"features": x})
    est = fml.KMeans().set_k(6).set_max_iter(15).set_seed(3)
    with fml.use_device(cuda_device):
        gpu = est.fit(table)
        (pg,) = gpu.transform(table)
        bis = fml.BisectingKMeans().set_k(4).set_seed(1).fit(table)
    with fml.use_device("cpu"):
        cpu = est.fit(table)
        (pc,) = cpu.transform(table)
        bis_cpu = fml.BisectingKMeans().set_k(4).set_seed(1).fit(table)
    np.testing.assert_allclose(gpu.centroids, cpu.centroids, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_array_equal(pg.column("prediction"),
                                  pc.column("prediction"))
    np.testing.assert_allclose(bis.centroids, bis_cpu.centroids, rtol=1e-10,
                               atol=1e-10)
    assert _kmeans.KMeansModel().transform_kernel() is None


# -- fused_chain: the prologue and the class heads -----------------------------------

def _onehot_assembler(rows, cards, dense_w, seed, drop_last=True):
    """OneHotEncoder(keep) over ``len(cards)`` int64 columns, then a
    VectorAssembler over the one-hot outputs and a float64 ``[rows,
    dense_w]`` column; serving codes include out-of-range ones."""
    rng = np.random.default_rng(seed)
    cats = {f"c{i}": rng.integers(0, k, size=rows) for i, k in
            enumerate(cards)}
    names = sorted(cats)
    with fml.use_device("cpu"):
        enc = (fml.OneHotEncoder().set_input_cols(names)
               .set_output_cols([f"o{c}" for c in names])
               .set_drop_last(drop_last).set_handle_invalid("keep")
               .fit(fml.Table(cats)))
    for c in names:
        cats[c][::97] = -1
        cats[c][5::89] = 1000
    va = (fml.VectorAssembler().set_input_cols(
        [f"o{names[0]}", "dense"] + [f"o{c}" for c in names[1:]])
        .set_handle_invalid("keep").set_output_col("features"))
    cats["dense"] = rng.normal(size=(rows, dense_w))
    return [enc, va], cats


def _class_head(kind, d, k, seed):
    rng = np.random.default_rng(seed)
    if kind == "kmeans":
        m = fml.KMeansModel().set_model_data(
            fml.Table({"centroids": rng.normal(size=(1, k, d))}))
    else:
        m = fml.LogisticRegressionModel()
        m.set_model_data(fml.Table({"coefficient": rng.normal(size=(1, k, d))}))
    return m


def _new_op_chain(op, d, rows, seed):
    """``(stages, host columns)`` of one new chain op: a class head after a
    MinMaxScaler or alone, or the one-hot + assemble prologue before a
    StandardScaler and the binomial head."""
    rng = np.random.default_rng(seed)
    if op == "prologue":
        cards = (4, 3) if d == 10 else (9, 16, 7, 15, 6, 5, 2, 42)
        stages, cols = _onehot_assembler(rows, cards, d - sum(cards), seed)
        with fml.use_device("cpu"):
            (t,) = fml.PipelineModel(stages).transform(fml.Table(dict(cols)))
            sc = (fml.StandardScaler().set_input_col("features")
                  .set_output_col("scaled").fit(t))
        lr = fml.LogisticRegressionModel().set_features_col("scaled")
        lr.set_model_data(fml.Table({"coefficient": rng.normal(size=(1, d))}))
        return stages + [sc, lr], cols
    kind, scaled = op.split("_")
    cols = {"features": rng.normal(size=(rows, d)) * 3.0}
    head = _class_head(kind, d, 10 if kind == "multinomial" else 7, seed)
    if scaled == "alone":
        return [head], cols
    with fml.use_device("cpu"):
        mm = (fml.MinMaxScaler().set_input_col("features")
              .set_output_col("mm").fit(fml.Table(cols)))
    head.set_features_col("mm")
    return [mm, head], cols


def _run_both(kernels, cols, device, rows, dtype, aligned=True):
    """The chain's eager program on the card and the plain chain on the
    same card tensors; ``aligned=False`` puts every float column one
    element into its buffer (the scalar route)."""
    ext = pipeline_fusion.external_inputs(kernels)
    outs = pipeline_fusion._output_cols(kernels)
    producer = {c: j for j, k in enumerate(kernels) for c in k.output_cols}
    terminal = [c for c in outs if not any(
        c in kernels[j].input_cols for j in range(producer[c] + 1,
                                                  len(kernels)))]
    eager = list(pipeline_fusion._closure_outputs(kernels, terminal))
    bucket = pipeline_fusion.row_bucket(rows)
    vals = []
    for c in ext:
        v = np.asarray(cols[c])
        t = torch.from_numpy(v)
        if t.dtype.is_floating_point:
            t = t.to(dtype)
        if not aligned and t.dtype.is_floating_point:
            buf = torch.zeros(bucket * max(1, t[0].numel()) + 1,
                              dtype=t.dtype, device=device)
            tp = buf[1:].view((bucket,) + tuple(t.shape[1:]))
            tp.zero_()
        else:
            tp = torch.zeros((bucket,) + tuple(t.shape[1:]), dtype=t.dtype,
                             device=device)
        tp[:rows] = t.to(device)
        vals.append(tp)
    consts = [k.constants for k in kernels]
    program = kchain.ChainProgram(kernels, ext, eager)
    before = kchain.LAUNCHES.count
    got = program(vals, consts, rows)
    want = kchain.chain_plain(kernels, ext, eager, vals, consts, rows)
    torch.cuda.synchronize()
    assert kchain.LAUNCHES.count == before + 1
    # The head's input, for the prediction check.
    want = dict(want, **{c: v for c, v in zip(ext, vals) if c not in want})
    return program, vals, got, want


def _assert_chain_close(got, want, rows, tol):
    for c, g in got.items():
        g, w = g[:rows], want[c][:rows]
        assert g.dtype == w.dtype, c
        if c == "prediction":
            continue
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def _assert_predictions(got, want, rows, kernels, rel=1e-9):
    """Equal predictions wherever the head's two best scores differ by more
    than ``rel`` relative (a near tie may break either way in another
    summation order)."""
    head = kernels[-1]
    name = head.fingerprint[0]
    if name not in ("KMeansModel", "LogisticRegressionModel"):
        return
    x = want[head.input_cols[0]][:rows].double()
    if name == "KMeansModel":
        c = torch.as_tensor(head.constants["centroids"]).to(x.device)
        score = -((x[:, None, :] - c[None]) ** 2).sum(-1)
    elif head.fingerprint[4]:
        score = x @ torch.as_tensor(head.constants["coefficient"]).to(
            x.device).T
    else:
        return
    top2 = torch.topk(score, 2, dim=1).values
    gap = (top2[:, 0] - top2[:, 1]) > rel * (1 + top2[:, 0].abs())
    assert gap.float().mean() > 0.9
    assert torch.equal(got["prediction"][:rows][gap],
                       want["prediction"][:rows][gap])


@pytest.mark.parametrize("op", ["multinomial_scaled", "multinomial_alone",
                                "kmeans_scaled", "kmeans_alone", "prologue"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("aligned", [True, False])
def test_chain_new_ops_match_plain(cuda_device, op, dtype, tol, aligned):
    """Each new chain op on both routes against the plain chain: a vector
    route width (d = 16 float64 / 32 float32; the prologue's row of 10)
    with aligned inputs, and the same inputs one element into their
    buffers on the scalar route. Every output, one-hot and assembled
    columns included, on 1,001 rows."""
    rows = 1001
    d = 10 if op == "prologue" else (16 if dtype == torch.float64 else 32)
    stages, cols = _new_op_chain(op, d, rows, seed=len(op))
    kernels = [s.transform_kernel() for s in stages]
    program, vals, got, want = _run_both(kernels, cols, cuda_device, rows,
                                         dtype, aligned)
    assert program.layout(vals).route == ("vector" if aligned else "scalar")
    _assert_chain_close(got, want, rows, 1e-10 if op == "prologue" else tol)
    _assert_predictions(got, want, rows, kernels,
                        1e-9 if dtype == torch.float64 else 1e-5)
    # The lazy reads: every intermediate alone, by a truncated program.
    for c in pipeline_fusion._output_cols(kernels):
        if c in got:
            continue
        ext = pipeline_fusion.external_inputs(kernels)
        lazy = kchain.ChainProgram(kernels, ext, [c])(
            vals, [k.constants for k in kernels], rows)
        plain = kchain.chain_plain(kernels, ext, [c], vals,
                                   [k.constants for k in kernels], rows)
        torch.cuda.synchronize()
        torch.testing.assert_close(lazy[c][:rows], plain[c][:rows],
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("op,d,dtype", [
    ("multinomial_scaled", 784, torch.float64),
    ("multinomial_scaled", 784, torch.float32),
    ("kmeans_scaled", 128, torch.float64),
    ("kmeans_scaled", 128, torch.float32),
    ("prologue", 108, torch.float64),   # one-hot outputs are float64
])
def test_chain_new_ops_full_width(cuda_device, op, d, dtype):
    """The paths' widths: MNIST's 784 (scalar route), KMeans' 128 (vector
    in float32, scalar in float64) and the census row of 108."""
    rows = 3000
    stages, cols = _new_op_chain(op, d, rows, seed=d)
    kernels = [s.transform_kernel() for s in stages]
    _, _, got, want = _run_both(kernels, cols, cuda_device, rows, dtype)
    f64 = dtype == torch.float64
    _assert_chain_close(got, want, rows, 1e-10 if f64 else 1e-5)
    _assert_predictions(got, want, rows, kernels, 1e-9 if f64 else 1e-5)


@pytest.mark.parametrize("kind,d,k,dtype", [
    ("kmeans", 784, 64, torch.float32),      # the whole table fits
    ("kmeans", 784, 64, torch.float64),      # centroids from device memory
    ("multinomial", 784, 64, torch.float64),
    ("kmeans", 20_000, 5, torch.float32),    # two warps a block
])
def test_chain_class_heads_beyond_shared_memory(cuda_device, kind, d, k,
                                                dtype):
    """StandardScaler -> a class head whose matrix does not fit in shared
    memory beside the rows (or whose rows alone take most of it): one
    launch, equal to the plain chain, and the fused pipeline on the card
    runs it too."""
    rows = 2000
    rng = np.random.default_rng(d + k)
    cols = {"features": rng.normal(size=(rows, d)) * 3.0}
    with fml.use_device("cpu"):
        sc = (fml.StandardScaler().set_input_col("features")
              .set_output_col("s").fit(fml.Table(cols)))
    head = _class_head(kind, d, k, seed=k).set_features_col("s")
    kernels = [sc.transform_kernel(), head.transform_kernel()]
    _, _, got, want = _run_both(kernels, cols, cuda_device, rows, dtype)
    f64 = dtype == torch.float64
    _assert_chain_close(got, want, rows, 1e-10 if f64 else 1e-5)
    _assert_predictions(got, want, rows, kernels, 1e-9 if f64 else 1e-5)
    if d != 784:
        return
    host = {"features": cols["features"].astype(
        np.float64 if f64 else np.float32)}
    pipeline_fusion.reset_cache()
    with fml.use_device(cuda_device):
        fml.reset_launch_counts()
        (out,) = fml.PipelineModel([sc, head]).transform(fml.Table(host))
        pred = out.column("prediction")
        assert fml.launch_counts()["fused_chain"] == 1
    # The same kernel on the same rows: the same bits.
    assert np.array_equal(pred, got["prediction"][:rows].cpu().numpy())


def test_chain_refuses_a_row_no_warp_can_stage(cuda_device):
    """A KMeans head over 30,000 float64 columns: one warp's staged row
    is more than a block's shared memory, a typed refusal naming it."""
    d = 30_000
    head = _class_head("kmeans", d, 2, seed=1)
    program = kchain.ChainProgram([head.transform_kernel()], ["features"],
                                  ["prediction"])
    x = torch.zeros((8, d), dtype=torch.float64, device=cuda_device)
    with pytest.raises(fml.KernelUnsupportedError, match="shared memory"):
        program([x], [head.transform_kernel().constants], 8)


def _nine_stages_port():
    """The nine kernel-capable stages of the port, each fitted (or given
    model data) on the CPU; ``{name: (stage, host columns)}``."""
    rng = np.random.default_rng(31)
    cols = {"features": rng.normal(size=(777, 8)) * 2.0 + 1.0,
            "label": (rng.random(777) > 0.5).astype(np.float64),
            "c1": rng.integers(0, 5, size=777).astype(np.float64),
            "c2": rng.integers(0, 3, size=777)}
    t = fml.Table(cols)
    out = {}
    with fml.use_device("cpu"):
        for cls in (fml.StandardScaler, fml.MinMaxScaler, fml.MaxAbsScaler,
                    fml.RobustScaler):
            out[cls.__name__] = cls().set_input_col("features") \
                .set_output_col("out").fit(t)
        out["VectorAssembler"] = fml.VectorAssembler().set_input_cols(
            ["features", "label"]).set_handle_invalid("keep") \
            .set_output_col("out")
        out["OneHotEncoder"] = fml.OneHotEncoder().set_input_cols(
            ["c1", "c2"]).set_output_cols(["o1", "o2"]) \
            .set_handle_invalid("keep").fit(t)
    out["LogisticRegression"] = _class_head("lr", 8, 1, 1)
    out["LogisticRegression"].set_model_data(
        fml.Table({"coefficient": rng.normal(size=(1, 8))}))
    out["LogisticRegressionMultinomial"] = _class_head("multinomial", 8, 3, 2)
    out["KMeans"] = _class_head("kmeans", 8, 5, 3)
    cols["c1"][:3] = [7.0, 4.0, -2.0]
    return out, cols


@pytest.mark.parametrize("name", [
    "StandardScaler", "MinMaxScaler", "MaxAbsScaler", "RobustScaler",
    "VectorAssembler", "OneHotEncoder", "LogisticRegression",
    "LogisticRegressionMultinomial", "KMeans"])
def test_nine_single_stage_kernels_match_plain(cuda_device, name):
    """Each of the nine stages alone is one fused_chain launch on the card,
    equal to the plain chain (float64)."""
    stages, cols = _nine_stages_port()
    kernels = [stages[name].transform_kernel()]
    _, _, got, want = _run_both(kernels, cols, cuda_device, 777,
                                torch.float64)
    _assert_chain_close(got, want, 777, 1e-10)
    _assert_predictions(got, want, 777, kernels)


def test_census_pipeline_on_card_matches_cpu(cuda_device):
    """The fused census pipeline (one-hot, assemble, scale, LR) on the card
    against the port's CPU run, every column, the lazy ones too."""
    stages, cols = _new_op_chain("prologue", 108, 2000, seed=4)
    model = fml.PipelineModel(stages)
    names = ("oc0", "oc3", "features", "scaled", "prediction",
             "rawPrediction")
    pipeline_fusion.reset_cache()
    with fml.use_device(cuda_device):
        fml.reset_launch_counts()
        (gpu,) = model.transform(fml.Table(dict(cols)))
        got = {c: gpu.column(c) for c in names}
        assert fml.launch_counts()["fused_chain"] == 4   # eager + 3 lazy
    with fml.use_device("cpu"):
        (cpu,) = model.transform(fml.Table(dict(cols)))
    for c in names:
        np.testing.assert_allclose(got[c], cpu.column(c), rtol=1e-10,
                                   atol=1e-10, err_msg=c)


def test_multinomial_fit_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(4000, 20))
    y = np.argmax(x @ rng.normal(size=(20, 5)), axis=1).astype(np.float64)
    table = fml.Table({"features": x, "label": y})
    est = (fml.LogisticRegression().set_seed(2).set_global_batch_size(512)
           .set_tol(0.0).set_learning_rate(0.5).set_max_iter(15))
    with fml.use_device(cuda_device):
        gpu = est.fit(table)
        (tg,) = gpu.transform(table)
    with fml.use_device("cpu"):
        cpu = est.fit(table)
        (tc,) = cpu.transform(table)
    assert gpu.coefficient.shape == (5, 20)
    np.testing.assert_allclose(gpu.coefficient, cpu.coefficient, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(tg.column("rawPrediction"),
                               tc.column("rawPrediction"), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("case", ["5,2", "0,0,7,1,1", "shuffled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [None, 16])
def test_segment_sum_sorted_on_descending_ids(cuda_device, case, dtype, k):
    """``indices_are_sorted=True`` on ids that do not ascend still returns
    ``index_add_``'s sum into zeros (integer-valued values: exact in any
    order), on an output block poisoned with NaN; the next launch on
    ascending ids is the run-flush's in-order sum again."""
    rng = np.random.default_rng(12)
    if case == "shuffled":
        ids = rng.permutation(1_000_000).astype(np.int32) % 200_003
        nseg = 200_003
    else:
        ids = np.array([int(v) for v in case.split(",")], np.int32)
        nseg = int(ids.max()) + 3
    if k is not None and case == "shuffled":
        ids, nseg = ids[:100_000], nseg
    shape = (ids.size,) if k is None else (ids.size, k)
    vals = torch.from_numpy(rng.integers(-8, 9, size=shape).astype(
        np.float64)).to(cuda_device, dtype)
    ti = torch.from_numpy(ids).to(cuda_device)
    _poison((nseg,) + tuple(vals.shape[1:]), dtype, cuda_device)
    got = ksegsum.segment_sum(vals, ti, nseg, indices_are_sorted=True)
    want = ksegsum.segment_sum_plain(vals, ti, nseg)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    order = torch.argsort(ti.long(), stable=True)
    again = ksegsum.segment_sum(vals[order], ti[order], nseg,
                                indices_are_sorted=True)
    in_order = np.zeros(tuple(want.shape), vals.cpu().numpy().dtype)
    np.add.at(in_order, ids[order.cpu().numpy()],
              vals[order].cpu().numpy())
    np.testing.assert_array_equal(again.cpu().numpy(), in_order)


# -- precision tiers and bfloat16 operands -------------------------------------

TIERS = ("mixed", "mixed_inference", "int8_inference")


def _tier_chain(case, rows, seed):
    """``(stages, host columns)`` of the tier chains at widths whose
    constants the int8 tier quantizes: the five-stage scaler → LR chain
    (d = 32), the census one-hot prologue → StandardScaler → LR (d = 108),
    MinMaxScaler → multinomial (d = 64, k = 10) and StandardScaler →
    KMeans (d = 32, k = 8)."""
    rng = np.random.default_rng(seed)
    if case == "five":
        model, x = _five_stage(rows, d=32, seed=seed)
        return model.stages, {"features": x}
    if case == "prologue":
        return _new_op_chain("prologue", 108, rows, seed)
    if case == "multinomial":
        return _new_op_chain("multinomial_scaled", 64, rows, seed)
    x = rng.normal(size=(rows, 32)) * 2.0
    with fml.use_device("cpu"):
        sc = (fml.StandardScaler().set_input_col("features")
              .set_output_col("s").fit(fml.Table({"features": x})))
    km = fml.KMeansModel().set_features_col("s").set_model_data(
        fml.Table({"centroids": rng.normal(size=(1, 8, 32))}))
    return [sc, km], {"features": x}


def _tier_both(kernels, cols, device, rows, policy, aligned=True):
    """:func:`_run_both` under ``policy``: the kernel (int8 constants as
    the executor hands them) and the plain chain on the same card
    tensors."""
    pol = fml.precision.resolve_policy(policy)
    ext = pipeline_fusion.external_inputs(kernels)
    outs = pipeline_fusion._output_cols(kernels)
    producer = {c: j for j, k in enumerate(kernels) for c in k.output_cols}
    terminal = [c for c in outs if not any(
        c in kernels[j].input_cols for j in range(producer[c] + 1,
                                                  len(kernels)))]
    eager = list(pipeline_fusion._closure_outputs(kernels, terminal))
    bucket = pipeline_fusion.row_bucket(rows)
    vals = []
    for c in ext:
        t = torch.from_numpy(np.asarray(cols[c]))
        if t.dtype.is_floating_point and not aligned:
            buf = torch.zeros(bucket * max(1, t[0].numel()) + 1,
                              dtype=t.dtype, device=device)
            tp = buf[1:].view((bucket,) + tuple(t.shape[1:]))
        else:
            tp = torch.zeros((bucket,) + tuple(t.shape[1:]), dtype=t.dtype,
                             device=device)
        tp[:rows] = t.to(device)
        vals.append(tp)
    consts = pipeline_fusion._tier_consts(kernels, pol)
    program = kchain.ChainProgram(kernels, ext, eager, pol)
    before = kchain.LAUNCHES.count
    got = program(vals, consts, rows)
    want = kchain.chain_plain(kernels, ext, eager, vals, consts, rows, pol)
    torch.cuda.synchronize()
    assert kchain.LAUNCHES.count == before + 1
    return got, want


#: KMeans assignments whose two best distances (as the plain chain rounds
#: them) lie within this many ulps of each other may break either way.
KMEANS_TIER_ULPS = 2


def _kmeans_near(x, centroids, n_ulps=KMEANS_TIER_ULPS):
    """Rows whose plain distances (``squared_distances`` at ``x``'s dtype)
    to their two best centroids lie within ``n_ulps`` ulps of the second
    one."""
    from flinkml_tpu_torch.ops import blas

    d2 = blas.squared_distances(x, centroids.to(x.dtype))
    top2 = torch.topk(d2.double(), 2, dim=1, largest=False).values
    fi = torch.finfo(d2.dtype)
    ulp = fi.eps * torch.exp2(torch.floor(torch.log2(
        top2[:, 1].clamp_min(fi.tiny))))
    return (top2[:, 1] - top2[:, 0]) <= n_ulps * ulp


def _tier_close(got, want, rows, kernels, policy):
    """Each output's dtype equal; values within the tier's tolerance (the
    kernel and the plain chain round the same ops; sums differ in order):
    bfloat16 rows 1 ulp, bfloat16 rawPrediction 2^-7, float32 1e-5,
    float64 1e-10; LR predictions equal away from a 2^-5 margin of their
    decision (counted: at most 5% of the rows lie within it); KMeans
    assignments equal wherever the plain chain's two best distances are
    more than ``KMEANS_TIER_ULPS`` ulps apart, and on 95% of all rows."""
    near = 0
    for c, g in got.items():
        g, w = g[:rows], want[c][:rows]
        assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
        if c == "prediction":
            continue
        if g.dtype == torch.bfloat16:
            tol = dict(rtol=2 ** -7, atol=2 ** -7) if c == "rawPrediction" \
                else dict(rtol=2 ** -8, atol=0.0)
        elif g.dtype == torch.float32:
            tol = dict(rtol=1e-5, atol=1e-5)
        else:
            tol = dict(rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(g.double(), w.double(), **tol)
    if "prediction" in got:
        g, w = got["prediction"][:rows], want["prediction"][:rows]
        if "rawPrediction" in want:
            raw = want["rawPrediction"][:rows].double()
            top2 = torch.topk(raw, 2, dim=1).values
            margin = (top2[:, 0] - top2[:, 1]) > 2 ** -5
            near = int((~margin).sum())
            assert near <= 0.05 * rows
        else:
            pol = fml.precision.resolve_policy(policy)
            cen = pipeline_fusion._tier_consts(kernels, pol)[-1]["centroids"]
            margin = ~_kmeans_near(want[kernels[-1].input_cols[0]][:rows],
                                   kchain.boundary_const(pol, cen, g.device))
            near = int((~margin).sum())
            assert (g == w).double().mean() >= 0.95
        assert torch.equal(g[margin], w[margin])
    return near


@pytest.mark.parametrize("policy", TIERS)
@pytest.mark.parametrize("case", ["five", "prologue", "multinomial",
                                  "kmeans"])
@pytest.mark.parametrize("aligned", [True, False])
def test_chain_tiers_match_plain(cuda_device, case, policy, aligned):
    """Every tier chain on both routes: the CUDA kernel against the plain
    chain at the same policy on the card (strict ``mixed`` refuses the
    KMeans head before anything is built)."""
    stages, cols = _tier_chain(case, 3000, seed=31)
    kernels = [s.transform_kernel() for s in stages]
    if case == "kmeans" and policy == "mixed":
        with pytest.raises(fml.PrecisionValidationError):
            pipeline_fusion.check_precision(
                kernels, [k.constants for k in kernels],
                fml.precision.MIXED)
        return
    got, want = _tier_both(kernels, cols, cuda_device, 3000, policy,
                           aligned)
    _tier_close(got, want, 3000, kernels, policy)


@pytest.mark.parametrize("policy", TIERS)
def test_tier_pipelines_on_card(cuda_device, policy):
    """Through the executor: the five-stage pipeline under each tier on the
    card equals the same pipeline on the CPU within the tier's tolerance,
    one kernel launch for the eager program."""
    stages, cols = _tier_chain("five", 2000, seed=32)
    model = fml.PipelineModel(stages)
    table = fml.Table(cols)
    pipeline_fusion.reset_cache()
    with pipeline_fusion.precision_scope(policy):
        with fml.use_device(cuda_device):
            fml.reset_launch_counts()
            (gpu,) = model.transform(table)
            raw = gpu.column("rawPrediction")
            assert fml.launch_counts()["fused_chain"] == 1
        with fml.use_device("cpu"):
            (cpu,) = model.transform(table)
    tol = 2 ** -7 if policy == "mixed_inference" else 1e-5
    np.testing.assert_allclose(raw, cpu.column("rawPrediction"), rtol=tol,
                               atol=tol)


def test_chain_refuses_float16(cuda_device):
    """float16 stays refused: a policy whose compute is float16, and a
    float16 input column."""
    stages, cols = _tier_chain("five", 100, seed=33)
    kernels = [s.transform_kernel() for s in stages]
    x = torch.from_numpy(cols["features"]).to(cuda_device)
    pol = fml.precision.PrecisionPolicy("half", "float16", "float32",
                                        "float32")
    with pytest.raises(fml.KernelUnsupportedError, match="float16"):
        kchain.ChainProgram(kernels, ["features"], ["s4"], pol)(
            [x], [k.constants for k in kernels], 100)
    with pytest.raises(fml.KernelUnsupportedError):
        kchain.ChainProgram(kernels, ["features"], ["s4"])(
            [x.half()], [k.constants for k in kernels], 100)


def test_spmv_bf16_matches_plain(cuda_device):
    idx, val, w = _ell(4000, 39, 100_000, seed=5)
    idx = torch.from_numpy(idx).to(cuda_device)
    val = torch.from_numpy(val).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy(w).to(cuda_device, torch.bfloat16)
    for start in (0, 1, 3):
        before = kspmv.LAUNCHES.count
        got = kspmv.spmv(idx[start:], val[start:], w)
        torch.cuda.synchronize()
        assert kspmv.LAUNCHES.count == before + 1 and got.dtype == torch.bfloat16
        want = kspmv.spmv_plain(idx[start:], val[start:], w)
        # float32 sums in another order, each rounded once to bf16.
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-2)


@pytest.mark.parametrize("k", [None, 2, 6])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 5)])
def test_segment_sum_bf16_matches_plain(cuda_device, k, offsets):
    """bfloat16 values: the sorted run-flush bit for bit with the plain
    version's in-order adds (on the CPU), every element written; the
    unsorted atomics within bf16 rounding of it."""
    rng = np.random.default_rng(8)
    cells, nseg = 20_000, 1500
    ids = np.sort(rng.integers(0, nseg, size=cells)).astype(np.int32)
    shape = (cells,) if k is None else (cells, k)
    vals = torch.from_numpy(rng.normal(size=shape)).to(torch.bfloat16)
    oi, ov = offsets
    ti = torch.zeros(cells + oi, dtype=torch.int32, device=cuda_device)[oi:]
    tv = torch.zeros((cells + ov,) + shape[1:], dtype=torch.bfloat16,
                     device=cuda_device)[ov:]
    ti.copy_(torch.from_numpy(ids))
    tv.copy_(vals)
    want = ksegsum.segment_sum_plain(vals, torch.from_numpy(ids), nseg)
    _poison((nseg,) + shape[1:], torch.bfloat16, cuda_device)
    got = ksegsum.segment_sum(tv, ti, nseg, indices_are_sorted=True)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
    loose = ksegsum.segment_sum(tv, ti, nseg)
    torch.cuda.synchronize()
    assert loose.dtype == torch.bfloat16
    # The recursive-summation bound at bf16's unit roundoff (2^-9), per
    # segment of c cells, plus half an ulp of the result.
    ids_t = torch.from_numpy(ids).long()
    exact = torch.zeros((nseg,) + shape[1:], dtype=torch.float64) \
        .index_add_(0, ids_t, vals.double())
    mag = torch.zeros((nseg,) + shape[1:], dtype=torch.float64) \
        .index_add_(0, ids_t, vals.double().abs())
    count = torch.bincount(ids_t, minlength=nseg).double().reshape(
        (nseg,) + (1,) * (len(shape) - 1))
    bound = torch.clamp(count * 2.0 ** -9, max=1.0) * mag \
        + loose.cpu().double().abs() * 2.0 ** -8
    assert bool(((loose.cpu().double() - exact).abs() <= bound).all())


@pytest.mark.parametrize("k", [1, 5, 128, 1000, 20_000])
@pytest.mark.parametrize("shape", [(9, 300), (3, 70_000), (300, 60_000)])
def test_topk_bf16_matches_plain_bitwise(cuda_device, k, shape):
    """bfloat16 rows on every route: values (bits) and indices equal the
    plain version's."""
    n = shape[-1]
    k = min(k, n)
    host = torch.from_numpy(_topk_rows(shape, seed=k)).to(torch.bfloat16)
    x = host.to(cuda_device)
    before = ktopk.LAUNCHES.count
    got_v, got_i = ktopk.top_k(x, k)
    torch.cuda.synchronize()
    assert ktopk.LAUNCHES.count == before + 1
    want_v, want_i = ktopk.top_k_plain(host, k)
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_v.cpu().view(torch.int16), want_v.view(torch.int16))


# -- int8 tables beyond shared memory; streamed and checkpointed fits ----------


def _int8_wide_chain(kind, rows, seed):
    """StandardScaler → KMeans at 784 x k = 128 (a float32 row), or the
    one-hot prologue → StandardScaler → a multinomial head at 784 x k = 48
    (the one-hot part makes the row float64 under the tier): int8 tables
    too large for shared memory."""
    rng = np.random.default_rng(seed)
    if kind == "kmeans":
        cols = {"features": rng.normal(size=(rows, 784)) * 3.0}
        with fml.use_device("cpu"):
            sc = (fml.StandardScaler().set_input_col("features")
                  .set_output_col("s").fit(fml.Table(cols)))
        head = _class_head("kmeans", 784, 128, seed).set_features_col("s")
        return [sc, head], {"features": cols["features"].astype(np.float32)}
    stages, cols = _onehot_assembler(rows, (4,), 780, seed)
    with fml.use_device("cpu"):
        (t,) = fml.PipelineModel(stages).transform(fml.Table(dict(cols)))
        sc = (fml.StandardScaler().set_input_col("features")
              .set_output_col("s").fit(t))
    head = _class_head("multinomial", 784, 48, seed).set_features_col("s")
    return stages + [sc, head], cols


@pytest.mark.parametrize("kind", ["kmeans", "multinomial"])
def test_chain_int8_tables_beyond_shared_memory(cuda_device, kind):
    """Under ``int8_inference`` a table too large for shared memory runs
    on the float table with its head read from device memory: one launch,
    equal to the plain chain at the tier."""
    stages, cols = _int8_wide_chain(kind, 3000, seed=41)
    kernels = [s.transform_kernel() for s in stages]
    got, want = _tier_both(kernels, cols, cuda_device, 3000,
                           "int8_inference")
    _tier_close(got, want, 3000, kernels, "int8_inference")


def test_sparse_stream_step_kernels_match_plain(cuda_device):
    """One streamed sparse step (uniform ELL of width 64 over 39 nnz a row,
    the padding cells on segment 0): the ``spmv`` and ``segment_sum``
    kernels against the plain versions on the same inputs, within 1e-5."""
    rng = np.random.default_rng(3)
    n, dim, nnz = 4096, 100_000, 39
    indptr = np.arange(n + 1, dtype=np.int64) * nnz
    indices = rng.integers(0, dim, size=n * nnz).astype(np.int32)
    values = rng.normal(size=n * nnz).astype(np.float32)
    bi, bv = _linear_sgd._pack_uniform_ell(indptr, indices, values,
                                           np.float32)
    assert bi.shape == (n, 64)
    y = (rng.random(n) > 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    coef = (rng.normal(size=dim) * 0.1).astype(np.float32)
    step = _linear_sgd._sparse_stream_stepper("logistic", dim)

    def run(device):
        hy = [torch.tensor(v, dtype=torch.float32, device=device)
              for v in (0.5, 0.01, 0.001)]
        args = [torch.from_numpy(a).to(device) for a in (coef, bi, bv, y, w)]
        return step(*args, *hy)

    fml.reset_launch_counts()
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert fml.launch_counts()["spmv"] == 1
    assert fml.launch_counts()["segment_sum"] == 1
    want = run(torch.device("cpu"))
    for g, p in zip(got, want):
        torch.testing.assert_close(g.cpu(), p, rtol=1e-5, atol=1e-5)


def test_prefetching_feed_equals_synchronous_upload(cuda_device):
    """The feed's copies run on its own stream from pinned memory while the
    consumer's stream computes; every batch equals a synchronous upload
    of the same host arrays, also when the consumer holds each batch
    through more work than the feed's depth."""
    from flinkml_tpu_torch.iteration.datacache import PrefetchingDeviceFeed

    rng = np.random.default_rng(6)
    batches = [{"x": rng.normal(size=(65_536, 64)).astype(np.float32),
                "i": rng.integers(0, 1000, size=(65_536, 8)).astype(np.int32)}
               for _ in range(12)]
    sink = torch.zeros((), device=cuda_device)
    held = []
    with fml.use_device(cuda_device):
        feed = PrefetchingDeviceFeed(iter(batches), depth=2)
        for host, dev in zip(batches, feed):
            assert dev["x"].device.type == "cuda"
            # Keep the consumer's stream busy so an unordered copy would
            # race with it.
            for _ in range(4):
                sink = sink + (dev["x"] @ dev["x"].T[:, :64]).sum()
            held.append(dev)
        feed.close()
    torch.cuda.synchronize()
    assert torch.isfinite(sink)
    for host, dev in zip(batches, held):
        assert torch.equal(dev["x"].cpu(), torch.from_numpy(host["x"]))
        assert torch.equal(dev["i"].cpu(), torch.from_numpy(host["i"]))


def test_sparse_streamed_resume_within_tolerance(cuda_device, tmp_path):
    """A sparse streamed fit on the card stopped at epoch 2 and resumed to
    5 equals the uninterrupted fit within 1e-5 (the unsorted
    ``segment_sum`` adds in a run-dependent order, so not bit for bit)."""
    from flinkml_tpu_torch.iteration import CheckpointManager, cache_stream

    rng = np.random.default_rng(9)
    dim, nnz = 50_000, 39

    def batch(n):
        indptr = np.arange(n + 1, dtype=np.int64) * nnz
        return {"indptr": indptr[None],
                "indices": rng.integers(0, dim, size=(1, n * nnz)).astype(
                    np.int32),
                "values": rng.normal(size=(1, n * nnz)).astype(np.float32),
                "y": (rng.random((1, n)) > 0.5).astype(np.float32),
                "dim": np.array([[dim]], np.int64)}

    cache = cache_stream(iter([batch(n) for n in (4096, 3000, 4096, 777)]))
    kw = dict(features_col="x", label_col="y", weight_col=None,
              loss="logistic", learning_rate=0.5, reg=0.001, elastic_net=0.0,
              tol=0.0)
    with fml.use_device(cuda_device):
        fml.reset_launch_counts()
        golden = _linear_sgd.streamed_linear_fit(cache, max_iter=5, **kw)
        assert fml.launch_counts()["spmv"] == 20
        assert fml.launch_counts()["segment_sum"] == 20
        mgr = CheckpointManager(str(tmp_path))
        _linear_sgd.streamed_linear_fit(cache, max_iter=2,
                                        checkpoint_manager=mgr, **kw)
        resumed = _linear_sgd.streamed_linear_fit(
            cache, max_iter=5, checkpoint_manager=mgr, resume=True, **kw)
    with fml.use_device("cpu"):
        plain = _linear_sgd.streamed_linear_fit(cache, max_iter=5, **kw)
    np.testing.assert_allclose(resumed, golden, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(golden, plain, rtol=1e-5, atol=1e-5)


def _criteo_like_rows(n, dim, nnz, seed):
    """SparseVector rows with ``nnz`` distinct random columns each."""
    rng = np.random.default_rng(seed)
    stride = rng.integers(1, dim // nnz, size=(n, 1))
    start = (rng.random((n, 1)) * (dim - stride * (nnz - 1))).astype(np.int64)
    idx = start + stride * np.arange(nnz)
    vals = rng.normal(size=(n, nnz))
    rows = np.empty(n, dtype=object)
    for r in range(n):
        rows[r] = fml.SparseVector._from_sorted(dim, idx[r], vals[r])
    y = (rng.random(n) > 0.5).astype(np.float32)
    return rows, y


def test_device_prefetcher_equals_synchronous_upload(cuda_device):
    """A prefetched Dataset batch on the card equals a synchronous upload
    of the same host rows, all five SortedSparseColumn tensors included,
    while the consumer's stream is kept busy (the feed's copies run on
    its own stream; every tensor is recorded on the consumer's)."""
    from flinkml_tpu_torch.data import Dataset, pad_place_table

    rows, y = _criteo_like_rows(40_000, 100_000, 39, seed=11)
    table = fml.Table({"features": rows, "label": y})
    ds = Dataset.from_arrays(table, 8192).prefetch(2)
    sink = torch.zeros((), device=cuda_device)
    held = []
    with fml.use_device(cuda_device):
        for t in ds:
            col = t._raw_column("features")
            assert all(x.device.type == "cuda" for x in col.tensors())
            for _ in range(4):
                sink = sink + col.buf.float().pow(2).sum()
            held.append(t)
    torch.cuda.synchronize()
    assert torch.isfinite(sink)
    with fml.use_device("cpu"):
        want = [pad_place_table(b) for b in table.batches(8192)]
    for got, ref in zip(held, want):
        gcol = got._raw_column("features")
        rcol = ref._raw_column("features")
        for g, r in zip(gcol.tensors(), rcol.tensors()):
            assert torch.equal(g.cpu(), r)
        assert torch.equal(got._raw_column("label").buf.cpu(),
                           ref._raw_column("label").buf)


def test_sorted_stream_on_card_matches_cpu(cuda_device):
    """``LogisticRegression().fit`` of a prefetched Dataset of SparseVector
    rows on the card takes the sorted stream (both kernels launch) and
    equals the CPU port within 1e-5 of the largest coefficient."""
    from flinkml_tpu_torch.data import Dataset

    rows, y = _criteo_like_rows(20_000, 50_000, 39, seed=12)
    ds = Dataset.from_arrays(fml.Table({"features": rows, "label": y}),
                             4096).shuffle(3, seed=1).prefetch(2)

    def est():
        return (fml.LogisticRegression().set_max_iter(4).set_tol(0.0)
                .set_learning_rate(0.5))

    with fml.use_device("cpu"):
        want = est().fit(ds).coefficient
    before = (kspmv.LAUNCHES.count, ksegsum.LAUNCHES.count)
    with fml.use_device(cuda_device):
        got = est().fit(ds).coefficient
    assert kspmv.LAUNCHES.count - before[0] == 5 * 4
    assert ksegsum.LAUNCHES.count - before[1] == 5 * 4
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_cumsum_fit_on_card_matches_cpu(cuda_device):
    """The ``cumsum`` layout on the card: the ``spmv`` kernel forward, the
    chunked running sums (many chunks) and one ``index_add_`` a bucket.
    Within 1e-5 of the CPU fit, and two runs on the card equal bit for bit
    (padding runs add exactly 0, so no two adds race)."""
    rng = np.random.default_rng(21)
    n, dim = 20_000, 200_000
    nnz = rng.integers(1, 60, size=n)
    indptr = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    indices = rng.integers(0, dim, size=indptr[-1]).astype(np.int32)
    values = rng.normal(size=indptr[-1]).astype(np.float32)
    y = (rng.random(n) > 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    kw = dict(loss="logistic", max_iter=6, learning_rate=0.5,
              global_batch_size=8_000, reg=0.001, elastic_net=0.1, tol=0.0,
              seed=3, layout="cumsum")
    args = (indptr, indices, values, dim, y, w)
    with fml.use_device(cuda_device):
        fml.reset_launch_counts()
        first = _linear_sgd.train_linear_model_sparse_csr(*args, **kw)
        counts = fml.launch_counts()
        second = _linear_sgd.train_linear_model_sparse_csr(*args, **kw)
    with fml.use_device("cpu"):
        plain = _linear_sgd.train_linear_model_sparse_csr(*args, **kw)
    assert counts["spmv"] >= 6 and counts["segment_sum"] == 0
    np.testing.assert_array_equal(first, second)
    np.testing.assert_allclose(first, plain, rtol=1e-5, atol=1e-5)


def test_kmeans_stream_resume_on_card_bit_for_bit(cuda_device, tmp_path):
    """A streamed KMeans on the card (a sealed cache replayed through the
    prefetching feed) stopped at epoch 3 and resumed to 8 equals the
    uninterrupted fit bit for bit (the one-hot product, no atomics); the
    CPU fit agrees within 1e-5."""
    from flinkml_tpu_torch.iteration import CheckpointManager, cache_stream

    rng = np.random.default_rng(22)
    centers = rng.uniform(-10, 10, size=(6, 64))
    batches = [{"x": (centers[rng.integers(0, 6, size=m)]
                      + rng.normal(size=(m, 64))).astype(np.float32)}
               for m in (4096, 3000, 4096, 1001)]
    cache = cache_stream(iter(batches))
    kw = dict(k=6, max_iter=8, seed=4)
    with fml.use_device(cuda_device):
        golden = _kmeans.train_kmeans_stream(cache, **kw)
        mgr = CheckpointManager(str(tmp_path))
        _kmeans.train_kmeans_stream(cache, checkpoint_manager=mgr,
                                    checkpoint_interval=3,
                                    **dict(kw, max_iter=3))
        resumed = _kmeans.train_kmeans_stream(
            cache, checkpoint_manager=mgr, checkpoint_interval=3,
            resume=True, **kw)
    with fml.use_device("cpu"):
        plain = _kmeans.train_kmeans_stream(cache, **kw)
    np.testing.assert_array_equal(resumed, golden)
    np.testing.assert_allclose(golden, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("plan_name", ["replicated", "fsdp", "fsdp_tp"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_plan_fit_on_card_matches_cpu(cuda_device, plan_name, optimizer):
    """``train_linear_plan`` at world 1 on the card (no process group: the
    step runs whole, no collective) equals the CPU fit within 1e-12
    (float64) and 1e-5 (float32); under ``mixed`` (bf16-rounded operands
    multiplied at float32) within 1e-5 of the CPU's mixed fit, and apart
    from the float32 fit but within 2e-2."""
    from flinkml_tpu_torch.sharding import PRESETS, train_linear_plan

    rng = np.random.default_rng(31)
    x = rng.normal(size=(5000, 64))
    y = (x @ rng.normal(size=64) > 0).astype(np.float64)
    kw = dict(optimizer=optimizer, max_iter=10, learning_rate=0.3,
              global_batch_size=1024, reg=0.01, elastic_net=0.2)
    plan = PRESETS[plan_name]
    for dtype, tol in ((np.float64, 1e-12), (np.float32, 1e-5)):
        with fml.use_device(cuda_device):
            got = train_linear_plan(x.astype(dtype), y, None, plan, **kw)
        with fml.use_device("cpu"):
            want = train_linear_plan(x.astype(dtype), y, None, plan, **kw)
        assert got.dtype == want.dtype == dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    with fml.use_device(cuda_device):
        mixed = train_linear_plan(x, y, None, plan, precision="mixed", **kw)
        full = train_linear_plan(x, y, None, plan, dtype=np.float32, **kw)
    with fml.use_device("cpu"):
        want = train_linear_plan(x, y, None, plan, precision="mixed", **kw)
    np.testing.assert_allclose(mixed, want, rtol=0, atol=1e-5)
    assert np.abs(mixed - full).max() > 0
    np.testing.assert_allclose(mixed, full, rtol=0, atol=2e-2)


def test_naive_bayes_counts_on_card(cuda_device):
    """NaiveBayes' counts on the card: one ``segment_sum`` launch of
    float64 ones over the flat (label, feature, category) ids, equal to
    ``np.add.at`` bit for bit; ``theta``, ``pi`` and the predictions equal
    the CPU fit bit for bit."""
    from flinkml_tpu_torch.models import naive_bayes as nb
    from flinkml_tpu_torch.parallel import DeviceMesh

    rng = np.random.default_rng(32)
    n = 50_001
    cards = (9, 16, 7, 15, 6, 5, 2, 42, 73, 16, 99)
    x = np.stack([rng.integers(0, c, size=n) for c in cards], 1).astype(float)
    y = ((x[:, 0] + x[:, 3] + rng.integers(0, 2, size=n)) % 2).astype(float)
    flat = rng.integers(0, 4000, size=n * 11)
    want = np.zeros(4000)
    np.add.at(want, flat, 1.0)
    with fml.use_device(cuda_device):
        before = ksegsum.LAUNCHES.count
        counts = nb.count_triples(DeviceMesh(), flat, 4000)
        assert ksegsum.LAUNCHES.count == before + 1
        model = fml.NaiveBayes().fit(fml.Table({"features": x, "label": y}))
        (got,) = model.transform(fml.Table({"features": x}))
    np.testing.assert_array_equal(counts, want)
    with fml.use_device("cpu"):
        cpu = fml.NaiveBayes().fit(fml.Table({"features": x, "label": y}))
        (ref,) = cpu.transform(fml.Table({"features": x}))
    np.testing.assert_array_equal(model._theta, cpu._theta)
    np.testing.assert_array_equal(model._pi, cpu._pi)
    np.testing.assert_array_equal(got.column("prediction"),
                                  ref.column("prediction"))


@pytest.mark.parametrize("k", [None, 1, 4])
def test_chunked_run_totals_one_chunk_bit_for_bit(cuda_device, k):
    """A window that fits one chunk (20,000 cells: C = 32,768), flat and as
    a ``[cells, k]`` payload: 50 calls on the card give the same bits
    (both scans take the row-wise kernel, never CUB's device-wide scan),
    within 1e-3 of the CPU's running sums (float32 sums of up to 20,000
    standard normals, added in another order)."""
    from flinkml_tpu_torch.ops import sparse as t_sparse

    rng = np.random.default_rng(31)
    cells = 20_000
    shape = (cells,) if k is None else (cells, k)
    contrib = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    ends = torch.from_numpy(np.unique(np.concatenate(
        [rng.integers(0, cells, size=3000), [cells - 1]])))
    assert t_sparse.next_pow2(cells + 1) <= t_sparse.CUMSUM_CHUNK
    dc, de = contrib.to(cuda_device), ends.to(cuda_device)
    first = t_sparse.chunked_run_totals(dc, de)
    for _ in range(49):
        assert torch.equal(t_sparse.chunked_run_totals(dc, de), first)
    torch.testing.assert_close(first.cpu(),
                               t_sparse.chunked_run_totals(contrib, ends),
                               rtol=0, atol=1e-3)


def test_stream_on_two_ranks_on_card(cuda_device, tmp_path):
    """The streamed CSR fit on two gloo ranks with CUDA tensors on the one
    card (``tests/_torch_mesh_worker.py stream_cuda``): both kernels
    launch on each rank, the ranks end with the same bits, within 1e-5 of
    the one-process CPU fit over the combined stream."""
    import os
    import sys

    from flinkml_tpu_torch.parallel.launch import spawn_ranks
    from tests import _stream_mp_common as C
    from tests import _torch_mesh_worker as worker

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    spawn_ranks([sys.executable, os.path.join(repo, "tests",
                                              "_torch_mesh_worker.py"),
                 "stream_cuda", str(tmp_path)], 2, str(tmp_path), 120,
                env=env)
    outs = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    np.testing.assert_array_equal(outs[1]["sp_coef"], outs[0]["sp_coef"])
    for o in outs:
        assert o["local_launches"].min() > 0, o["local_launches"]
    with fml.use_device("cpu"):
        want = worker._estimator(fml.LogisticRegression, None,
                                 C.SPARSE_HP).fit(
            iter(worker.sparse_combined(C, 2))).coefficient
    np.testing.assert_allclose(outs[0]["sp_coef"], want, rtol=0, atol=1e-5)


# -- faults and the numerics sentinel on the card (ROADMAP item 12) -----------


def _verdict_states():
    nan, inf = float("nan"), float("inf")
    return [
        ([np.array([1.0, -2.0])], 0.5, 1e8),
        ([np.array([1.0, nan])], 0.5, 1e8),
        ([np.array([inf, 1.0]), np.ones(3)], 0.5, 1e8),
        ([np.array([2e8])], 0.1, 1e8),
        ([np.array([1e8 + 1.0], np.float32)], 0.1, 1e8),
        ([np.ones(4)], inf, 1e8),
        ([np.array([nan])], 0.0, None),
    ]


def test_sentinel_bits_on_card_equal_cpu(cuda_device):
    """One verdict pass on CUDA tensors gives the CPU's bits, and a CUDA
    loss tensor comes back from the same read."""
    from flinkml_tpu_torch.recovery.sentinel import verdict_bits

    for leaves, loss, max_abs in _verdict_states():
        cpu = [torch.from_numpy(a) for a in leaves]
        card = [t.to(cuda_device) for t in cpu]
        want = verdict_bits(cpu, torch.tensor(loss), max_abs)
        got = verdict_bits(card, torch.tensor(loss, device=cuda_device),
                           max_abs)
        assert got[0] == want[0]
        assert got[1] == want[1] or (np.isnan(got[1]) and np.isnan(want[1]))


def test_poison_faults_keep_device_and_dtype(cuda_device):
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.table import PaddedDeviceColumn

    state = {"z": torch.ones(5, device=cuda_device),
             "b": torch.ones(2, dtype=torch.bfloat16, device=cuda_device),
             "version": 3}
    ctx = {"state": state, "source_index": 1, "phase": "post"}
    faults.NaNGrad(1).apply(ctx)
    for key in ("z", "b"):
        out = ctx["state"][key]
        assert out.device.type == cuda_device.type
        assert out.dtype == state[key].dtype
        assert torch.isnan(out.float()).all()
    assert ctx["state"]["version"] == 3
    batch = fml.Table({
        "x": PaddedDeviceColumn(torch.ones(8, 3, device=cuda_device), 5),
        "y": torch.ones(5, dtype=torch.float64, device=cuda_device)})
    ctx = {"batch": batch, "source_index": 0, "phase": "pre"}
    faults.PoisonBatch(0).apply(ctx)
    x = ctx["batch"]._raw_column("x")
    assert x.buf.device.type == cuda_device.type and x.rows == 5
    assert torch.isnan(x.buf).all()
    y = ctx["batch"]._raw_column("y")
    assert y.device.type == cuda_device.type and y.dtype == torch.float64
    assert torch.isnan(y).all()


def _ftrl_batches(n=10, rows=256, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=dim)
    out = []
    for _ in range(n):
        x = rng.normal(size=(rows, dim))
        out.append(fml.Table({"features": x,
                              "label": (x @ true > 0).astype(np.float64)}))
    return out


def test_healed_ftrl_on_card_equals_golden(cuda_device, tmp_path):
    """A PoisonBatch and a NaNGrad healed on the card: the model equals
    the same stream without the two batches, on the card, bit for bit."""
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.recovery import RecoveryPolicy

    batches = _ftrl_batches()

    def lr():
        return fml.OnlineLogisticRegression().set_alpha(0.5).set_reg(0.01)

    with fml.use_device(cuda_device):
        golden = lr().fit_stream(
            [b for i, b in enumerate(batches) if i not in (3, 6)])
        with faults.armed(faults.FaultPlan(faults.PoisonBatch(3),
                                           faults.NaNGrad(6))):
            healed = lr().fit_stream(
                batches, checkpoint_manager=CheckpointManager(str(tmp_path)),
                checkpoint_interval=2,
                recovery=RecoveryPolicy(backoff_s=0.0))
    assert healed.recovery_summary["quarantined"] == [3, 6]
    np.testing.assert_array_equal(healed.coefficient, golden.coefficient)
    assert healed.model_version == golden.model_version == 8


def test_prefetch_seam_raise_on_card_reaches_consumer(cuda_device):
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.data import Dataset

    rng = np.random.default_rng(0)
    table = fml.Table({"features": rng.normal(size=(40, 3)),
                       "y": np.arange(40.0)})
    with fml.use_device(cuda_device):
        ds = Dataset.from_arrays(table, 4).prefetch(depth=2)
        with faults.armed(faults.FaultPlan(
                faults.RaiseAtRead(at_read=3, site="data.prefetch"))):
            it = ds.iterate()
            first = next(it)
            assert first.is_device_resident("features")
            with pytest.raises(faults.FaultInjected, match="read #3"):
                for _ in it:
                    pass
        prefetcher = it._prefetcher
        prefetcher._thread.join(timeout=10.0)
        assert not prefetcher._thread.is_alive()
        with pytest.raises(faults.FaultInjected):
            next(prefetcher)


# ---------------------------------------------------------------------------
# The serving runtime on the card
# ---------------------------------------------------------------------------

SERVED = ("s4", "prediction", "rawPrediction")


def _serving_engine(source, x, name, **cfg):
    from flinkml_tpu_torch.serving import ServingConfig, ServingEngine

    config = ServingConfig(**{"max_batch_rows": 128, "max_wait_ms": 1.0,
                              **cfg})
    return ServingEngine(source, fml.Table({"features": x[:4]}), config,
                         output_cols=SERVED, name=name)


def _served_alone(model, x, device):
    """Each row's outputs from the model's own fused transform, served
    alone (one batch) on ``device``."""
    with fml.use_device(device):
        (out,) = model.transform(fml.Table({"features": x}))
        return {c: out.column(c) for c in SERVED}


def test_serving_engine_on_card_matches_cpu_per_stage(cuda_device):
    """An engine built with no device request serves on the card: each
    batch is one ``fused_chain`` launch, and the responses equal the CPU
    per-stage chain within the fused route's tolerance."""
    model, x = _five_stage(2000, seed=5)
    with fml.use_device("cpu"):
        pipeline_fusion.set_enabled(False)
        try:
            (ref,) = model.transform(fml.Table({"features": x}))
        finally:
            pipeline_fusion.set_enabled(True)
    eng = _serving_engine(model, x, "card_parity").start()
    try:
        assert eng.device.type == "cuda"
        fml.reset_launch_counts()
        got = {c: [] for c in SERVED}
        for lo in range(0, 2000, 50):
            resp = eng.predict({"features": x[lo:lo + 50]})
            for c in SERVED:
                got[c].append(resp.column(c))
        batches = eng.stats()["counters"]["batches"]
        assert fml.launch_counts()["fused_chain"] == batches == 40
    finally:
        eng.stop()
    got = {c: np.concatenate(v) for c, v in got.items()}
    np.testing.assert_allclose(got["s4"], ref.column("s4"), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got["rawPrediction"],
                               ref.column("rawPrediction"), rtol=1e-10,
                               atol=1e-10)
    margin = np.asarray(ref.column("rawPrediction"))[:, 1] - 0.5
    decisive = np.abs(margin) > 2.0 ** -5
    np.testing.assert_array_equal(got["prediction"][decisive],
                                  np.asarray(ref.column("prediction"))[decisive])


def test_two_engines_on_their_streams_alternate_versions_bit_for_bit(
        cuda_device):
    """Two engines, each on its own CUDA stream, serve v1 and v2 of one
    model shape (one fused program, two packed tables) in turn from
    several client threads for a few hundred batches, swapping versions
    half way: every response is bit for bit its version's served alone."""
    import threading

    from flinkml_tpu_torch.serving import ModelRegistry

    v1, x = _five_stage(1024, seed=6)
    v2, _ = _five_stage(1024, seed=7)
    ref = {1: _served_alone(v1, x, cuda_device),
           2: _served_alone(v2, x, cuda_device)}
    assert not np.array_equal(ref[1]["rawPrediction"], ref[2]["rawPrediction"])
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        regs = [ModelRegistry(f"{root}/a"), ModelRegistry(f"{root}/b")]
        for reg, first, second in ((regs[0], v1, v2), (regs[1], v2, v1)):
            reg.publish(first)
            reg.publish(second)
            reg.rollback(1)
        engines = [_serving_engine(regs[i], x, f"stream{i}").start()
                   for i in range(2)]
        assert engines[0]._stream is not engines[1]._stream
        version_of = [{1: 1, 2: 2}, {1: 2, 2: 1}]  # registry v -> model
        errors, served = [], [0]

        def client(tid):
            rng = np.random.default_rng(tid)
            try:
                for i in range(100):
                    e = (tid + i) % 2
                    rows = int(rng.integers(1, 65))
                    lo = int(rng.integers(0, 1024 - rows))
                    resp = engines[e].predict({"features": x[lo:lo + rows]})
                    want = ref[version_of[e][resp.version]]
                    for c in SERVED:
                        np.testing.assert_array_equal(
                            resp.column(c), want[c][lo:lo + rows])
                    served[0] += 1
            except BaseException as err:  # noqa: BLE001
                errors.append(err)

        try:
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(6)]
            for t in threads:
                t.start()
            while served[0] < 300 and any(t.is_alive() for t in threads):
                threading.Event().wait(0.01)
            for eng in engines:
                eng.swap_to(2)
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors[:3]
            assert served[0] == 600
            assert sum(e.stats()["counters"]["batches"] for e in engines) \
                >= 200
        finally:
            for eng in engines:
                eng.stop()


def test_hot_swap_under_eight_clients_on_card(cuda_device):
    """A registry publish mid-traffic on the card, 8 client threads: no
    error, every response carries one version and equals that version's
    outputs bit for bit."""
    import tempfile
    import threading

    from flinkml_tpu_torch.serving import ModelRegistry

    v1, x = _five_stage(1024, seed=8)
    v2, _ = _five_stage(1024, seed=9)
    ref = {1: _served_alone(v1, x, cuda_device),
           2: _served_alone(v2, x, cuda_device)}
    with tempfile.TemporaryDirectory() as root:
        reg = ModelRegistry(root)
        reg.publish(v1)
        eng = _serving_engine(reg, x, "card_swap").start().follow_registry()
        errors, versions = [], []
        stop = threading.Event()

        def client(tid):
            rng = np.random.default_rng(tid)
            try:
                while not stop.is_set():
                    rows = int(rng.integers(1, 33))
                    lo = int(rng.integers(0, 1024 - rows))
                    resp = eng.predict({"features": x[lo:lo + rows]})
                    versions.append(resp.version)
                    for c in SERVED:
                        np.testing.assert_array_equal(
                            resp.column(c), ref[resp.version][c][lo:lo + rows])
            except BaseException as err:  # noqa: BLE001
                errors.append(err)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        try:
            for t in threads:
                t.start()
            threading.Event().wait(0.5)
            reg.publish(v2)
            threading.Event().wait(0.5)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
            eng.stop()
        assert not errors, errors[:3]
        assert set(versions) == {1, 2} and versions[-1] == 2
        assert eng.stats()["counters"].get("errors", 0) == 0


def test_cpu_engine_on_card_host_launches_nothing(cuda_device):
    """An engine built under ``use_device("cpu")`` on the card's host
    serves on the CPU from its dispatcher thread and launches no kernel."""
    model, x = _five_stage(256, seed=10)
    with fml.use_device("cpu"):
        eng = _serving_engine(model, x, "cpu_on_card")
    fml.reset_launch_counts()
    eng.start()
    try:
        assert eng.device.type == "cpu" and eng._stream is None
        resp = eng.predict({"features": x[:40]})
        assert resp.column("rawPrediction").shape == (40, 2)
    finally:
        eng.stop()
    assert sum(fml.launch_counts().values()) == 0


def test_engine_builds_nothing_after_warmup_on_card(cuda_device):
    """From the end of ``start()`` to ``stop()``, requests of every size up
    to ``max_batch_rows`` build no new fused program and no kernel."""
    from tests._torch_serving_common import program_counts

    model, x = _five_stage(512, seed=11)
    pipeline_fusion.reset_cache()
    eng = _serving_engine(model, x, "card_warm").start()
    try:
        warmed = program_counts()
        assert warmed[0] > 0 and warmed[1] >= 1
        for rows in (1, 3, 8, 9, 17, 33, 64, 65, 128):
            eng.predict({"features": np.resize(x, (rows, x.shape[1]))})
        assert program_counts() == warmed
    finally:
        eng.stop()


def test_cluster_pool_on_card_matches_in_process_engine(cuda_device):
    """A 2-worker ClusterPool on the card: each worker serves on ``cuda``,
    runs no ``nvcc`` (the pool built the kernels before the spawn),
    launches ``fused_chain`` for its batches, and answers bit for bit as
    the in-process engine does."""
    from flinkml_tpu_torch.cluster import ClusterPool
    from flinkml_tpu_torch.serving import ServingConfig

    model, x = _five_stage(1024, seed=12)
    ref = _serving_engine(model, x, "cluster_ref").start()
    pool = ClusterPool(
        model, fml.Table({"features": x[:4]}),
        config=ServingConfig(max_batch_rows=128, max_wait_ms=1.0),
        n_workers=2, output_cols=SERVED, name="card_cluster",
    )
    try:
        pool.start()
        rng = np.random.default_rng(12)
        lo = 0
        while lo < 1024:
            rows = int(rng.integers(1, 65))
            req = {"features": x[lo:lo + rows]}
            want, got = ref.predict(req), pool.predict(req)
            for c in SERVED:
                np.testing.assert_array_equal(got.column(c), want.column(c))
            lo += rows
        for r in pool.replicas:
            st = r.engine.worker_stats()
            assert st["device"].startswith("cuda")
            assert st["nvcc_runs"] == 0
            assert st["launches"]["fused_chain"] > 0
    finally:
        pool.stop()
        ref.stop()


# -- tensor parallelism, embeddings, hashed features and ALS ---------------------


def _als_table(n=4000, users=300, items=200, seed=0):
    rng = np.random.default_rng(seed)
    return fml.Table({"user": rng.integers(0, users, n),
                      "item": rng.integers(0, items, n),
                      "rating": rng.uniform(1, 5, n).astype(np.float32)})


def _als_fit(layout, device, implicit=False, iters=1):
    from flinkml_tpu_torch.models.als import ALS

    with fml.use_device(device):
        return ALS(layout=layout).set_rank(8).set_max_iter(iters) \
            .set_seed(0).set_implicit_prefs(implicit).fit(_als_table())


def _als_rmse(model):
    t = _als_table()
    (out,) = model.transform(fml.Table({"user": t.column("user"),
                                        "item": t.column("item")}))
    return float(np.sqrt(np.mean((out.column("prediction")
                                  - t.column("rating")) ** 2)))


@pytest.mark.parametrize("implicit", [False, True])
def test_als_segment_layout_on_card(cuda_device, implicit):
    """The segment layout launches the segment_sum kernel three times a
    chunk; one iteration agrees with the CPU fit within the layouts'
    tolerance (its atomics add in a run-dependent order), and three
    iterations within 1e-4 of the CPU fit's training RMSE (past the
    first iteration two summation orders drift apart in the factors of
    these random ratings). The cumsum layout repeats bit for bit."""
    before = ksegsum.LAUNCHES.count
    card = _als_fit("segment", "cuda", implicit)
    # 1 iteration x 2 half-steps x 1 chunk x 3 scatters.
    assert ksegsum.LAUNCHES.count - before == 6
    cpu = _als_fit("segment", "cpu", implicit)
    np.testing.assert_allclose(card.user_factors, cpu.user_factors,
                               rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(card.item_factors, cpu.item_factors,
                               rtol=5e-4, atol=5e-5)
    a = _als_fit("cumsum", "cuda", implicit, iters=3)
    b = _als_fit("cumsum", "cuda", implicit, iters=3)
    np.testing.assert_array_equal(a.user_factors, b.user_factors)
    cpu3 = _als_fit("segment", "cpu", implicit, iters=3)
    card3 = _als_fit("segment", "cuda", implicit, iters=3)
    for model in (a, card3):
        assert abs(_als_rmse(model) - _als_rmse(cpu3)) <= \
            1e-4 * _als_rmse(cpu3)


def test_als_segment_layout_refuses_deterministic_mode(cuda_device):
    torch.use_deterministic_algorithms(True)
    try:
        with pytest.raises(fml.KernelUnsupportedError, match="atomics"):
            _als_fit("segment", "cuda")
    finally:
        torch.use_deterministic_algorithms(False)


def test_als_recommend_topk_on_card(cuda_device):
    model = _als_fit("segment", "cpu")
    before = ktopk.LAUNCHES.count
    with fml.use_device("cuda"):
        ids, scores = model.recommend_for_all_users(10)
    assert ktopk.LAUNCHES.count == before + 1
    with fml.use_device("cpu"):
        cpu_ids, cpu_scores = model.recommend_for_all_users(10)
    u = torch.from_numpy(model.user_factors.astype(np.float32)).cuda()
    v = torch.from_numpy(model.item_factors.astype(np.float32)).cuda()
    want = torch.topk(u @ v.T, 10).values.cpu().numpy()
    np.testing.assert_array_equal(scores, want)
    np.testing.assert_allclose(scores, cpu_scores, rtol=1e-5, atol=1e-5)


def test_embedding_scatter_and_lookup_on_card(cuda_device):
    """An unsharded table on the card: lookups bit for bit with the host
    gather, the scatter within 1e-5 of np.add.at."""
    from flinkml_tpu_torch.embeddings import EmbeddingTable

    rng = np.random.default_rng(0)
    rows = rng.normal(size=(5000, 16)).astype(np.float32)
    ids = rng.integers(0, 5000, 4096).astype(np.int32)
    delta = rng.normal(size=(4096, 16)).astype(np.float32)
    with fml.use_device("cuda"):
        t = EmbeddingTable("t", 5000, 16, rows=rows)
        assert t.rows.is_cuda
        assert t.lookup(ids).cpu().numpy().tobytes() == rows[ids].tobytes()
        t.scatter_add(ids, delta)
    ref = rows.copy()
    np.add.at(ref, ids, delta)
    np.testing.assert_allclose(t.to_host(), ref, rtol=1e-5, atol=1e-5)


def test_a2a_scatter_launches_segment_sum_on_card(cuda_device):
    """The all_to_all scatter's local sum is the segment_sum kernel (one
    shard: no collective), with the masked rows on local row 0."""
    from flinkml_tpu_torch.embeddings import exchange

    rng = np.random.default_rng(1)
    table = torch.zeros((64, 8), device=cuda_device)
    ids = torch.from_numpy(rng.integers(0, 128, 512)).to(cuda_device)
    rows = torch.from_numpy(rng.normal(size=(512, 8)).astype(
        np.float32)).to(cuda_device)
    axes = exchange.ShardAxes(None, (0,), 0)
    before = ksegsum.LAUNCHES.count
    (got,) = exchange.a2a_scatter_add((table,), ((0, ids, rows),),
                                      axes=axes, n_shards=1, shard_rows=64)
    assert ksegsum.LAUNCHES.count == before + 1
    mask = ids < 64
    want = torch.zeros_like(table).index_add_(0, ids[mask], rows[mask])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_hashed_fm_trainer_on_card(cuda_device):
    from flinkml_tpu_torch.features import StreamingHashedFMTrainer
    from tests._torch_recsys_cases import click_batches

    with fml.use_device("cuda"):
        tr = StreamingHashedFMTrainer(num_buckets=64, factor_size=4,
                                      learning_rate=0.1)
        assert tr._v_table.rows.is_cuda
        losses = [tr.fit_batch(ids, y) for ids, y in click_batches()]
    with fml.use_device("cpu"):
        ref = StreamingHashedFMTrainer(num_buckets=64, factor_size=4,
                                       learning_rate=0.1)
        want = [ref.fit_batch(ids, y) for ids, y in click_batches()]
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-6)
    for name, arr in ref.delta_state().items():
        np.testing.assert_allclose(tr.delta_state()[name], arr, rtol=1e-5,
                                   atol=1e-5)


def test_tensor_parallel_one_rank_on_card(cuda_device):
    """One rank: the TP block, the pipeline and ring attention run on the
    card without a collective and equal the same computation unsharded."""
    import torch.nn.functional as F

    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.parallel import ring, tensor
    from tests._torch_recsys_cases import mlp_inputs, qkv

    x, w1, b1, w2, b2 = mlp_inputs()
    with fml.use_device("cuda"):
        out = tensor.tensor_parallel_mlp(x, w1, b1, w2, b2,
                                         DeviceMesh({"model": 1}))
        q, k, v = (torch.from_numpy(a).cuda() for a in qkv())
        att = ring.ring_attention(q, k, v, DeviceMesh(), causal=True)
    assert out.is_cuda and att.is_cuda
    t = [torch.from_numpy(a).cuda() for a in (x, w1, b1, w2, b2)]
    want = F.gelu(t[0] @ t[1] + t[2], approximate="tanh") @ t[3] + t[4]
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(att, ring._full_attention(q, k, v, True))


# -- threefry, Word2Vec, FM and MLP (the recsys family's rest) ---------------


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_threefry_draws_on_card_match_cpu(cuda_device, dtype):
    from flinkml_tpu_torch.ops import threefry

    for span in (7, 1000, 1 << 18, 2**31 - 1):
        card = threefry.randint(threefry.fold_in(
            threefry.PRNGKey(3, cuda_device), torch.arange(40,
                                                           device=cuda_device)),
            (257,), 0, span, dtype=dtype)
        cpu = threefry.randint(threefry.fold_in(
            threefry.PRNGKey(3, "cpu"), torch.arange(40)), (257,), 0, span,
            dtype=dtype)
        assert torch.equal(card.cpu(), cpu)
    key_c, key_h = threefry.PRNGKey(9, cuda_device), threefry.PRNGKey(9, "cpu")
    assert torch.equal(threefry.uniform(key_c, (4096,)).cpu(),
                       threefry.uniform(key_h, (4096,)))
    ulps = (threefry.normal(key_c, (1 << 16,)).cpu().view(torch.int32).long()
            - threefry.normal(key_h, (1 << 16,)).view(torch.int32).long())
    assert int(ulps.abs().max()) <= 3


def _w2v_inputs(device, vocab=1000, dim=32, n=5000, seed=0):
    rng = np.random.default_rng(seed)
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (put(rng.integers(0, vocab, n).astype(np.int32)),
            put(rng.integers(0, vocab, n).astype(np.int32)),
            torch.ones(n, device=device),
            put(rng.integers(0, vocab, 1 << 12).astype(np.int32)),
            put(((rng.random((vocab, dim)) - 0.5) / dim).astype(np.float32)),
            put(np.zeros((vocab, dim), np.float32)))


def test_word2vec_sgns_steps_on_card_match_cpu(cuda_device):
    from flinkml_tpu_torch.models import word2vec as w2v
    from flinkml_tpu_torch.ops import threefry

    trainer = w2v._sgns_trainer(None, 256, 5, "scatter")
    before = ksegsum.LAUNCHES.count
    card = trainer(*_w2v_inputs(cuda_device), 0.5, 5,
                   threefry.PRNGKey(1, cuda_device))
    torch.cuda.synchronize()
    assert ksegsum.LAUNCHES.count == before + 3 * 5
    cpu = trainer(*_w2v_inputs("cpu"), 0.5, 5, threefry.PRNGKey(1, "cpu"))
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def test_word2vec_scatter_refuses_deterministic_mode(cuda_device):
    from flinkml_tpu_torch.models import word2vec as w2v
    from flinkml_tpu_torch.ops import threefry

    trainer = w2v._sgns_trainer(None, 64, 2, "scatter")
    torch.use_deterministic_algorithms(True)
    try:
        with pytest.raises(fml.KernelUnsupportedError):
            trainer(*_w2v_inputs(cuda_device), 0.5, 1,
                    threefry.PRNGKey(1, cuda_device))
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("shape", [(8192, 128, 32768), (40960, 128, 32768)])
def test_word2vec_scatter_shapes_match_plain(cuda_device, shape):
    cells, dim, vocab = shape
    rng = np.random.default_rng(4)
    vals = torch.from_numpy(rng.normal(size=(cells, dim)).astype(
        np.float32)).to(cuda_device)
    ids = torch.from_numpy(rng.integers(0, vocab, cells).astype(
        np.int32)).to(cuda_device)
    torch.testing.assert_close(ksegsum.segment_sum(vals, ids, vocab),
                               ksegsum.segment_sum_plain(vals, ids, vocab),
                               rtol=1e-5, atol=1e-5)


def _topic_tokens(n_docs=400, seed=0):
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "horse", "mouse", "bird"]
    tools = ["hammer", "wrench", "drill", "saw", "pliers"]
    col = np.empty(n_docs, dtype=object)
    for i in range(n_docs):
        col[i] = list(rng.choice(animals if rng.uniform() < 0.5 else tools,
                                 size=8))
    return fml.Table({"tok": col})


def test_word2vec_fit_and_find_synonyms_on_card(cuda_device):
    def fit():
        return fml.Word2Vec().set_input_col("tok").set_vector_size(16) \
            .set_window_size(3).set_min_count(2).set_max_iter(3) \
            .set_learning_rate(2.0).set_batch_size(512).set_seed(0) \
            .fit(_topic_tokens())

    card = fit()
    with fml.use_device("cpu"):
        cpu = fit()
    np.testing.assert_array_equal(card.vocabulary, cpu.vocabulary)
    np.testing.assert_allclose(card.vectors, cpu.vectors, rtol=1e-4,
                               atol=1e-4)
    before = ktopk.LAUNCHES.count
    words, sims = card.find_synonyms("cat", 4)
    assert ktopk.LAUNCHES.count == before + 1
    vecs = torch.from_numpy(card.vectors.astype(np.float32)).to(cuda_device)
    from flinkml_tpu_torch.models.word2vec import cosine_scores

    i = list(card.vocabulary).index("cat")
    lib, _ = torch.topk(cosine_scores(vecs, i), 4)
    np.testing.assert_array_equal(sims, lib.cpu().numpy())
    assert "cat" not in words


def test_word2vec_find_synonyms_topk_shape_matches_plain(cuda_device):
    from flinkml_tpu_torch.models.word2vec import cosine_scores

    vecs = torch.from_numpy(np.random.default_rng(5).normal(
        size=(32768, 128)).astype(np.float32)).to(cuda_device)
    sims = cosine_scores(vecs, 7)
    vals, idx = ktopk.top_k(sims, 10)
    pv, pi = ktopk.top_k_plain(sims, 10)
    assert torch.equal(vals, pv) and torch.equal(idx, pi)


@pytest.mark.parametrize("cls_name", ["FMClassifier", "FMRegressor"])
def test_fm_steps_on_card_match_cpu(cuda_device, cls_name):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2048, 24))
    y = (x @ rng.normal(size=24) > 0).astype(np.float64)
    if cls_name == "FMRegressor":
        y = x[:, 0] + 1.0

    def fit():
        return getattr(fml, cls_name)().set_max_iter(5).set_reg(0.01) \
            .set_global_batch_size(512).set_seed(0).set_tol(0.0) \
            .fit(fml.Table({"features": x, "label": y}))

    card = fit()
    with fml.use_device("cpu"):
        cpu = fit()
    for a, b in ((card._w0, cpu._w0), (card._w, cpu._w), (card._v, cpu._v)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_fm_sharded_fit_at_world_one_on_card(cuda_device):
    from flinkml_tpu_torch.sharding import EMBEDDING

    rng = np.random.default_rng(2)
    x = rng.normal(size=(1024, 24))
    t = fml.Table({"features": x, "label": x[:, 0] + 1.0})

    def fit(**kw):
        return fml.FMRegressor(**kw).set_max_iter(5) \
            .set_global_batch_size(256).set_seed(0).set_tol(0.0).fit(t)

    card = fit(sharding_plan=EMBEDDING)
    with fml.use_device("cpu"):
        cpu = fit(sharding_plan=EMBEDDING)
    np.testing.assert_allclose(card._v, cpu._v, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(card._w0, cpu._w0, rtol=1e-5, atol=1e-5)


def test_fm_sparse_margin_float64_on_card(cuda_device):
    from flinkml_tpu_torch.linalg import SparseVector

    rng = np.random.default_rng(3)
    dim, k = 100_000, 8
    model = fml.FMRegressorModel()
    model._set(0.25, rng.normal(size=dim), rng.normal(size=(dim, k)) * 0.1)
    col = np.empty(3000, dtype=object)
    col[:] = [SparseVector(dim, np.sort(rng.choice(dim, 39, replace=False)),
                           rng.normal(size=39)) for _ in range(3000)]
    before = kspmv.LAUNCHES.count
    got = model._margin(fml.Table({"features": col}))
    assert kspmv.LAUNCHES.count == before + 1
    with fml.use_device("cpu"):
        want = model._margin(fml.Table({"features": col}))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cls_name", ["MLPClassifier", "MLPRegressor"])
def test_mlp_steps_on_card_match_cpu(cuda_device, cls_name):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1000, 6))
    if cls_name == "MLPClassifier":
        layers, y = [6, 32, 3], rng.integers(0, 3, 1000).astype(np.float64)
    else:
        layers, y = [6, 32, 1], x[:, 0] * x[:, 1]

    def fit():
        return getattr(fml, cls_name)().set_layers(layers).set_max_iter(5) \
            .set_learning_rate(0.05).set_global_batch_size(128) \
            .set_tol(0.0).set_seed(0) \
            .fit(fml.Table({"features": x, "label": y}))

    card = fit()
    with fml.use_device("cpu"):
        cpu = fit()
    for a, b in zip(card._weights, cpu._weights):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_mlp_short_fit_on_card_learns_xor(cuda_device):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(1200, 2))
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0)).astype(np.float64)
    t = fml.Table({"features": x, "label": y})
    model = fml.MLPClassifier().set_layers([2, 16, 2]).set_max_iter(600) \
        .set_learning_rate(0.01).set_global_batch_size(256).set_tol(0.0) \
        .set_seed(0).fit(t)
    (out,) = model.transform(t)
    assert (out["prediction"] == y).mean() > 0.97


# -- the device-side catalog (item 10b): forests, GMM, PCA, PIC ----------------

def _forest_table(n=3000, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, d))
    y = (x[:, 0] * x[:, 1] > 0).astype(np.float64)
    return fml.Table({"features": x, "label": y}), x, y


def _near_tie_problems(a, b, boosting):
    import chip_smoke

    return chip_smoke.forest_parting(
        chip_smoke.forest_arrays(a), chip_smoke.forest_arrays(b), boosting,
        leaf_rtol=chip_smoke.V_CARD_LEAF_RTOL)[1]


@pytest.mark.parametrize("layout", ["segment", "cumsum"])
@pytest.mark.parametrize("name", ["GBTClassifier", "RandomForestClassifier"])
def test_gbt_forest_on_card_matches_cpu(cuda_device, name, layout):
    from flinkml_tpu_torch.models import gbt

    t, x, y = _forest_table()

    def fit(device):
        est = getattr(gbt, name)(hist_layout=layout).set_num_trees(8) \
            .set_max_depth(4).set_max_bins(32).set_subsample(0.8).set_seed(1)
        with fml.use_device(device):
            return est.fit(t)

    before = ksegsum.LAUNCHES.count
    card = fit("cuda")
    launches = ksegsum.LAUNCHES.count - before
    assert launches == (8 * 5 if layout == "segment" else 0)
    cpu = fit("cpu")
    assert not _near_tie_problems(cpu, card, name.startswith("GBT"))
    acc = lambda m: (m.transform(fml.Table({"features": x}))[0]
                     .column("prediction") == y).mean()  # noqa: E731
    assert abs(acc(card) - acc(cpu)) < 0.01


def test_gbt_segment_layout_refuses_deterministic_mode(cuda_device):
    from flinkml_tpu_torch.models import gbt

    t, _, _ = _forest_table(n=200)
    torch.use_deterministic_algorithms(True)
    try:
        with fml.use_device("cuda"):
            with pytest.raises(fml.KernelUnsupportedError):
                gbt.GBTClassifier().set_num_trees(1).set_max_depth(2).fit(t)
            # The cumsum layout has no atomics: it runs, and repeats.
            fits = [gbt.GBTClassifier(hist_layout="cumsum").set_num_trees(3)
                    .set_max_depth(3).fit(t) for _ in range(2)]
            assert np.array_equal(fits[0]._leaves, fits[1]._leaves)
    finally:
        torch.use_deterministic_algorithms(False)


def test_forest_draws_on_card_match_cpu(cuda_device):
    from flinkml_tpu_torch.models import gbt
    from flinkml_tpu_torch.ops import threefry

    keys_c = threefry.split(threefry.PRNGKey(5, cuda_device), 6)
    keys_h = threefry.split(threefry.PRNGKey(5, "cpu"), 6)
    for t in range(6):
        for boosting, sub in ((True, 0.7), (False, 1.0), (False, 0.5)):
            mc, fc = gbt.tree_weights(keys_c[t], 1 << 18, sub, boosting, 16,
                                      4, cuda_device)
            mh, fh = gbt.tree_weights(keys_h[t], 1 << 18, sub, boosting, 16,
                                      4, torch.device("cpu"))
            assert torch.equal(mc.cpu(), mh) and torch.equal(fc.cpu(), fh)


def test_gbt_stream_on_card_matches_cpu_and_resumes(cuda_device, tmp_path):
    from flinkml_tpu_torch.iteration.checkpoint import CheckpointManager
    from flinkml_tpu_torch.iteration.datacache import cache_stream
    from flinkml_tpu_torch.models import gbt
    from flinkml_tpu_torch.models._gbt_stream import train_gbt_stream
    from flinkml_tpu_torch.parallel import DeviceMesh

    rng = np.random.default_rng(2)
    batches = []
    for _ in range(4):
        xb = rng.uniform(-1, 1, size=(500, 4)).astype(np.float32)
        batches.append({"x": xb, "y": (xb[:, 0] * xb[:, 1] > 0).astype(
            np.float32), "w": np.ones(500, np.float32)})
    cache = cache_stream(iter(batches))
    args = dict(logistic=True, num_trees=5, depth=3, max_bins=16,
                learning_rate=0.3, reg_lambda=1.0, subsample=0.8, seed=0)

    def forest(r):
        return (r[0], gbt.split_thresholds(r[5], r[0], r[1]), r[2], r[3])

    def run(device, **kw):
        with fml.use_device(device):
            return train_gbt_stream(cache, mesh=DeviceMesh(), **args, **kw)

    import chip_smoke
    tol = chip_smoke.V_CARD_LEAF_RTOL
    card, cpu = run("cuda"), run("cpu")
    assert not chip_smoke.forest_parting(forest(cpu), forest(card), True,
                                         leaf_rtol=tol)[1]

    class Crash(CheckpointManager):
        def save(self, state, epoch, extra=None, **kw):
            p = super().save(state, epoch, extra, **kw)
            if epoch >= 3:
                raise RuntimeError("injected crash")
            return p

    with pytest.raises(RuntimeError, match="injected"):
        run("cuda", checkpoint_manager=Crash(str(tmp_path / "ck")),
            checkpoint_interval=3)
    resumed = run("cuda", checkpoint_manager=CheckpointManager(
        str(tmp_path / "ck")), checkpoint_interval=3, resume=True)
    assert not chip_smoke.forest_parting(forest(card), forest(resumed),
                                         True, leaf_rtol=tol)[1]


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_gmm_em_statistics_on_card_match_cpu(cuda_device, cov):
    from flinkml_tpu_torch.models import gmm

    rng = np.random.default_rng(3)
    x = rng.normal(size=(5000, 8)).astype(np.float32)
    weights = np.full(4, 0.25)
    means = rng.normal(size=(4, 8))
    covs = (rng.uniform(0.5, 2, (4, 8)) if cov == "diag"
            else np.stack([np.eye(8) * s for s in (0.6, 1.0, 1.4, 2.0)]))

    def stats(device):
        xd = torch.from_numpy(x).to(device)
        return gmm.unpack_statistics(gmm.em_statistics(
            xd, torch.ones(len(x), device=device), weights, means, covs,
            cov), 4, 8, cov)

    for a, b in zip(stats(cuda_device), stats("cpu")):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(b).max()))


def test_pca_gram_and_pic_on_card_match_cpu(cuda_device):
    from flinkml_tpu_torch.models import pca, pic

    x = np.random.default_rng(4).normal(size=(20000, 16)).astype(np.float32)
    card = pca.mean_and_gram(None, torch.from_numpy(x).to(cuda_device),
                             torch.ones(len(x), device=cuda_device), x[0])
    cpu = pca.mean_and_gram(None, torch.from_numpy(x), torch.ones(len(x)),
                            x[0])
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(b).max()))
    rng = np.random.default_rng(5)
    src = rng.integers(0, 3000, 20000)
    dst = rng.integers(0, 3000, 20000)
    ids, s, d, wn, v0, _ = pic.pic_inputs(src, dst, np.ones(20000), 2, 0)
    up = lambda a, dev: torch.from_numpy(a).to(dev)  # noqa: E731
    before = ksegsum.LAUNCHES.count
    vc = pic.power_iteration(up(s, cuda_device), up(d, cuda_device),
                             up(wn, cuda_device), up(v0, cuda_device), 15)
    torch.cuda.synchronize()
    assert ksegsum.LAUNCHES.count == before + 15
    vh = pic.power_iteration(up(s, "cpu"), up(d, "cpu"), up(wn, "cpu"),
                             up(v0, "cpu"), 15)
    np.testing.assert_allclose(vc.cpu().numpy(), vh.numpy(), rtol=1e-4,
                               atol=1e-6 * float(vh.abs().max()))


# -- LDA, gamma, OneVsRest and the tuning tools (the catalog's host half) -------


@pytest.mark.parametrize("a", [100.0, 1.0])
def test_gamma_and_normal_float64_on_card_match_cpu(cuda_device, a):
    """The float64 draws on the card: within the ulps declared against JAX
    (``test_torch_threefry.py``), no flipped decision."""
    from flinkml_tpu_torch.ops import threefry

    key_c, key_h = threefry.PRNGKey(5, cuda_device), threefry.PRNGKey(5, "cpu")
    card = threefry.gamma(key_c, a, (20, 500)).cpu()
    cpu = threefry.gamma(key_h, a, (20, 500))
    assert card.dtype == torch.float64
    torch.testing.assert_close(card, cpu, rtol=1e-12, atol=0)
    assert int((card.view(torch.int64) - cpu.view(torch.int64)).abs().max()) \
        <= 10
    ulps = (threefry.normal(key_c, (1 << 16,), torch.float64).cpu()
            .view(torch.int64) - threefry.normal(key_h, (1 << 16,),
                                                 torch.float64)
            .view(torch.int64))
    assert int(ulps.abs().max()) <= 3


def test_lda_vb_pass_and_fit_on_card_match_cpu(cuda_device):
    from flinkml_tpu_torch.models import lda
    from flinkml_tpu_torch.ops import threefry
    from flinkml_tpu_torch.table import Table

    rng = np.random.default_rng(6)
    counts = rng.poisson(0.3, size=(600, 400)).astype(np.float32)
    lam0 = lda._initial_lambda(threefry.PRNGKey(0, "cpu"), 5, 400)

    def packed(device):
        key = threefry.PRNGKey(0, device)
        return lda.vb_pass(
            torch.from_numpy(counts).to(device),
            torch.ones(600, device=device),
            torch.from_numpy(lam0.astype(np.float32)).to(device), 0.2,
            threefry.fold_in(key, 0)).cpu().numpy()

    card, cpu = packed(cuda_device), packed("cpu")
    np.testing.assert_allclose(card, cpu, rtol=1e-4,
                               atol=1e-4 * np.abs(cpu[:-2]).max())
    fits = []
    for device in (cuda_device, "cpu"):
        with fml.use_device(device):
            fits.append(fml.models.LDA().set_k(5).set_max_iter(3)
                        .set_tol(0.0).set_seed(0).fit(Table({
                            "features": torch.from_numpy(counts).to(device)
                        })).topics_matrix)
    np.testing.assert_allclose(fits[0], fits[1], rtol=1e-4,
                               atol=1e-4 * fits[1].max())


def test_one_vs_rest_on_card_launches_fused_chain(cuda_device):
    from flinkml_tpu_torch.table import Table

    rng = np.random.default_rng(7)
    x = np.concatenate([rng.normal(size=(300, 4)) + 4 * np.eye(4)[i % 3]
                        for i in range(3)]).astype(np.float32)
    y = np.repeat([0.0, 1.0, 2.0], 300)
    inner = fml.Pipeline([
        fml.MinMaxScaler().set_input_col("features").set_output_col("mm"),
        fml.LogisticRegression().set_features_col("mm").set_max_iter(20)
        .set_learning_rate(1.0).set_seed(0)])
    table = Table({"features": torch.from_numpy(x).to(cuda_device),
                   "label": y})
    model = fml.models.OneVsRest(inner).fit(table)
    before = kchain.LAUNCHES.count
    (out,) = model.transform(table)
    torch.cuda.synchronize()
    assert kchain.LAUNCHES.count - before >= 3
    assert (out.column("prediction") == y).mean() > 0.9


def test_tuning_on_card_matches_cpu(cuda_device):
    from flinkml_tpu_torch.table import Table

    rng = np.random.default_rng(8)
    x = rng.normal(size=(2000, 6)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] + 0.5 * rng.normal(size=2000) > 0).astype(
        np.float32)
    metrics = []
    for device in (cuda_device, "cpu"):
        with fml.use_device(device):
            lr = fml.LogisticRegression().set_max_iter(10).set_seed(0)
            grid = fml.ParamGridBuilder().add_grid(
                lr, fml.LogisticRegression.REG, [0.0, 1.0]).build()
            cv = fml.CrossValidator(
                lr, grid, fml.models.BinaryClassificationEvaluator())
            metrics.append(cv.set_num_folds(2).set_seed(0).fit(Table(
                {"features": x, "label": y})).avg_metrics)
    np.testing.assert_allclose(metrics[0], metrics[1], rtol=0, atol=1e-5)
