"""Card tests of the port's analysis passes: ``chip_smoke.py`` path Y at
small sizes.

Every test needs an NVIDIA GPU and skips (from a fixture, at run time)
without one. The file imports neither JAX nor the JAX package (the card's
machine has no JAX): run it there with
``python -m pytest tests/test_torch_analysis_cuda.py -m cuda --noconftest
-q``.

- Y1: a warmed fused chain under a zero-budget guard on the card: no
  finding, no ``nvcc`` run, one ``fused_chain`` launch and one upload a
  transform; an unwarmed chain raises FML402;
- Y2: the sorted-stream step captured from card tensors: one sorted
  ``flinkml.segment_sum``, no FML404 (one for its ``False`` copy); one
  step on the card launches what the capture shows and matches the step
  on CPU copies;
- Y3: the memory walker's peak of a dense and a sparse step within
  0.5x–2.0x of ``max_memory_allocated`` over one step; a capture of a
  kernel wrapper on card tensors leaves the wrapper's path as it was.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, or a skip (decided here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from flinkml_tpu_torch.kernels import _build

    _build.build_all()
    return torch.device("cuda")


def _chain(x, coef):
    from flinkml_tpu_torch import (
        LogisticRegressionModel, MaxAbsScalerModel, MinMaxScalerModel,
        StandardScalerModel, Table,
    )

    stages = [
        StandardScalerModel().set_model_data(
            Table({"mean": x.mean(0)[None], "std": x.std(0)[None]})),
        MinMaxScalerModel().set_model_data(
            Table({"dataMin": x.min(0)[None], "dataMax": x.max(0)[None]})),
        MaxAbsScalerModel().set_model_data(
            Table({"maxAbs": np.abs(x).max(0)[None]})),
    ]
    prev = "features"
    for i, st in enumerate(stages, start=1):
        st.set(st.INPUT_COL, prev).set(st.OUTPUT_COL, f"s{i}")
        prev = f"s{i}"
    lr = LogisticRegressionModel().set(LogisticRegressionModel.FEATURES_COL,
                                       prev)
    lr.set_model_data(Table({"coefficient": coef[None]}))
    return stages + [lr]


def test_guard_on_the_card(cuda_device):
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import pipeline_fusion
    from flinkml_tpu_torch.analysis import GuardViolation, TransferRetraceGuard

    rng = np.random.default_rng(0)
    x = rng.normal(size=(600, 16))
    coef = rng.normal(size=16)
    pm = fml.PipelineModel(_chain(x, coef))
    t = fml.Table({"features": x})
    with fml.use_device(cuda_device):
        pm.transform(t.slice(0, 256))
        fml.reset_launch_counts()
        rows = (129, 150, 200, 256, 257)
        with TransferRetraceGuard(allow_compiles=0,
                                  allow_host_to_device=len(rows),
                                  allow_device_to_host=0) as guard:
            outs = [pm.transform(t.slice(0, r))[0] for r in rows]
        assert guard.findings == [] and guard.nvcc_runs == 0
        assert fml.launch_counts()["fused_chain"] == len(rows)
        cold = fml.PipelineModel(_chain(x, coef)[1:])
        cold.stages[0].set(cold.stages[0].INPUT_COL, "features")
        with pytest.raises(GuardViolation) as err:
            with TransferRetraceGuard(allow_compiles=0):
                cold.transform(t.slice(0, 100))
        assert "FML402" in {f.rule for f in err.value.findings}
        pipeline_fusion.set_enabled(False)
        try:
            (ref,) = pm.transform(t.slice(0, rows[-1]))
        finally:
            pipeline_fusion.set_enabled(True)
    np.testing.assert_allclose(outs[-1].column("rawPrediction"),
                               ref.column("rawPrediction"), rtol=1e-12,
                               atol=1e-12)


def test_sorted_step_capture_and_launches_on_the_card(cuda_device):
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.analysis import check_sorted_scatter_fn
    from flinkml_tpu_torch.analysis._capture import capture, nodes_named
    from flinkml_tpu_torch.models import _linear_sgd as sgd
    from flinkml_tpu_torch.ops.sparse import pack_sorted_sparse_column

    rng = np.random.default_rng(1)
    dim, n, nnz = 5_000, 512, 7
    vecs = []
    for _ in range(n):
        idx = np.sort(rng.choice(dim, nnz, replace=False)).astype(np.int32)
        vecs.append(fml.SparseVector._from_sorted(
            dim, idx, rng.normal(size=nnz).astype(np.float32)))
    with fml.use_device(cuda_device):
        col = pack_sorted_sparse_column(vecs)
    coef = torch.from_numpy(rng.normal(size=dim).astype(np.float32)).cuda()
    yb = torch.from_numpy((rng.random(n) > 0.5).astype(np.float32)).cuda()
    wb = torch.ones(n, device="cuda")
    hy = sgd._stream_hypers(0.5, 1e-4, 0.0, torch.float32, "cuda")
    args = (coef, col.indices, col.buf, col.perm, col.segment_ids, yb, wb,
            *hy)
    step = sgd._sorted_column_stepper("logistic", dim)
    gm = capture(step, *args)
    (seg,) = nodes_named(gm, "segment_sum")
    assert seg.args[3] is True and len(nodes_named(gm, "spmv")) == 1
    assert check_sorted_scatter_fn(step, args, (3, 4)) == []
    fml.reset_launch_counts()
    got = step(*args)
    torch.cuda.synchronize()
    counts = fml.launch_counts()
    assert counts["spmv"] == 1 and counts["segment_sum"] == 1
    with fml.use_device("cpu"):
        want = step(*(a.cpu() for a in args))
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=1e-5, atol=1e-5 * float(
                                   want[0].abs().max()))


def _measured_peak(step, args):
    tensors = [a for a in args if torch.is_tensor(a)]
    for a in args:
        if isinstance(a, tuple):
            tensors.extend(a)
    arg_bytes = sum(t.numel() * t.element_size() for t in tensors)
    step(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(*args)
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base + arg_bytes


def test_memory_estimate_calibrated_on_the_card(cuda_device):
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.analysis import check_memory_fn, estimate_fn_memory
    from flinkml_tpu_torch.models import _linear_sgd as sgd

    rng = np.random.default_rng(2)
    hy = tuple(torch.tensor(v, device="cuda") for v in (0.1, 0.0, 0.0))
    x = torch.from_numpy(rng.normal(size=(65_536, 64)).astype(np.float32))
    y = torch.from_numpy((rng.random(65_536) > 0.5).astype(np.float32))
    dense = (sgd.make_dense_step("logistic", 16_384),
             (torch.zeros(64, device="cuda"), 0, x.cuda(), y.cuda(),
              torch.ones(65_536, device="cuda"), *hy))
    n, dim, nnz = 16_384, 200_000, 39
    indptr = np.arange(n + 1, dtype=np.int64) * nnz
    indices = rng.integers(0, dim, n * nnz).astype(np.int32)
    values = rng.normal(size=n * nnz).astype(np.float32)
    with fml.use_device(cuda_device):
        data_args, local_bss = sgd.prepare_sparse_buckets(
            indptr, indices, values, dim, (rng.random(n) > 0.5).astype(
                np.float32), np.ones(n, np.float32), n, seed=0,
            layout="unsorted")
    sparse = (sgd.make_sparse_step_bucketed("logistic", local_bss, dim,
                                            "unsorted"),
              (torch.zeros(dim, device="cuda"), 0, data_args, *hy))
    for step, args in (dense, sparse):
        est = estimate_fn_memory(step, *args)
        measured = _measured_peak(step, args)
        assert 0.5 <= est.peak_bytes / measured <= 2.0, (est, measured)
        rules = [f.rule for f in check_memory_fn(
            step, *args, hbm_budget_bytes=measured // 2)]
        assert "FML701" in rules


def test_wrapper_path_unchanged_after_a_capture(cuda_device):
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.analysis._capture import capture
    from flinkml_tpu_torch.kernels import _gate
    from flinkml_tpu_torch.kernels.segsum import segment_sum, segment_sum_plain

    rng = np.random.default_rng(3)
    ids = torch.from_numpy(np.sort(rng.integers(0, 64, 4096)).astype(
        np.int32)).cuda()
    vals = torch.from_numpy(rng.normal(size=4096).astype(np.float32)).cuda()
    capture(lambda v, i: segment_sum(v, i, 64, indices_are_sorted=True),
            vals, ids)
    assert not _gate.CAPTURE.on
    fml.reset_launch_counts()
    got = segment_sum(vals, ids, 64, indices_are_sorted=True)
    assert fml.launch_counts()["segment_sum"] == 1
    torch.testing.assert_close(got, segment_sum_plain(vals, ids, 64),
                               rtol=1e-5, atol=1e-5)
