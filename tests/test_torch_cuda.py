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
        kspmv.spmv(idx, val.bfloat16(), w.bfloat16())
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
        ksegsum.segment_sum(tv.bfloat16(), ti, nseg)
    with pytest.raises(fml.KernelUnsupportedError):
        ksegsum.segment_sum(tv, ti.long(), nseg)
    empty = ksegsum.segment_sum(tv[:0], ti[:0], nseg)
    assert ksegsum.LAUNCHES.count == before + 1 and not empty.any()


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
