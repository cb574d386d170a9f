"""The ``fused_chain`` launch plan under ``int8_inference`` for tables too
large for shared memory, on the CPU (the kernel itself runs only on the
card: ``tests/test_torch_cuda.py::test_chain_int8_tables_beyond_shared_memory``).

The kernel dequantizes an int8 table into shared memory. A table that
does not fit there beside one warp's rows (StandardScaler → KMeans at 784
x k = 128 on a float32 row, a multinomial head at k = 48 on a float64 row)
gets a placement, not a refusal: the launch takes the float table
(``ChainProgram.float_table``: every int8 pair dequantized once, ``q *
scale`` in float32, the multiply the kernel makes at the load) and reads
its head from device memory, as the same chain does under no policy.
Tolerance: exact (the same float32 products on both sides).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu_torch import pipeline_fusion as pf
from flinkml_tpu_torch import precision
from flinkml_tpu_torch.kernels import chain as kchain

INT8 = "int8_inference"


def _chain(kind, d, k, seed=0, rows=64):
    """``(kernels, host columns)``. ``kmeans``: StandardScaler → KMeans
    over a ``features`` column. ``multinomial``: OneHotEncoder over one
    4-category column → VectorAssembler with a dense column (d wide in
    all) → StandardScaler → a multinomial head; the one-hot part makes the
    row float64 under the tier (the tier rounds float inputs to float32,
    a one-hot part stays float64)."""
    rng = np.random.default_rng(seed)
    if kind == "kmeans":
        cols = {"features": rng.normal(size=(rows, d)) * 3.0}
        stages, scaled_in = [], fml.Table(cols)
        head = fml.KMeansModel().set_model_data(
            fml.Table({"centroids": rng.normal(size=(1, k, d))}))
    else:
        cols = {"c0": rng.integers(0, 4, size=rows),
                "dense": rng.normal(size=(rows, d - 4)) * 3.0}
        with fml.use_device("cpu"):
            enc = (fml.OneHotEncoder().set_input_cols(["c0"])
                   .set_output_cols(["o0"]).set_handle_invalid("keep")
                   .fit(fml.Table({"c0": cols["c0"]})))
        va = (fml.VectorAssembler().set_input_cols(["o0", "dense"])
              .set_handle_invalid("keep").set_output_col("features"))
        stages = [enc, va]
        with fml.use_device("cpu"):
            (scaled_in,) = fml.PipelineModel(stages).transform(
                fml.Table(dict(cols)))
        head = fml.LogisticRegressionModel()
        head.set_model_data(fml.Table({"coefficient":
                                       rng.normal(size=(1, k, d))}))
    with fml.use_device("cpu"):
        sc = (fml.StandardScaler().set_input_col("features")
              .set_output_col("s").fit(scaled_in))
    head.set_features_col("s")
    return [s.transform_kernel() for s in stages + [sc, head]], cols


def _program(kernels, cols, dtype, policy):
    pol = precision.resolve_policy(policy)
    outs = list(kernels[-1].output_cols)
    ext = pf.external_inputs(kernels)
    program = kchain.ChainProgram(kernels, ext, outs, pol)
    vals = []
    for c in ext:
        v = np.asarray(cols[c])
        vals.append(torch.from_numpy(v.astype(dtype) if v.dtype.kind == "f"
                                     else v))
    return program, program.layout(vals), pf._tier_consts(kernels, pol), pol


@pytest.mark.parametrize("kind,d,k,dtype", [
    ("kmeans", 784, 128, np.float32),
    ("multinomial", 784, 48, np.float64),
])
def test_int8_table_beyond_shared_memory_gets_a_placement(kind, d, k, dtype):
    kernels, cols = _chain(kind, d, k)
    program, lay, consts, pol = _program(kernels, cols, dtype, INT8)
    assert lay.dtype == (torch.float32 if kind == "kmeans" else torch.float64)
    blob, ops, info = kchain.pack_int8(program.plan, kernels, consts, lay.d,
                                       pol)
    vector, group, n_smem, threads, smem = program.placement(
        lay, k, info["n_table"], quant=True)
    assert n_smem < info["n_table"]          # the float table's placement
    assert smem <= kchain.MAX_SMEM_BYTES and threads >= 32
    # The same placement the chain has under no policy.
    plain, plain_lay, plain_consts, _ = _program(kernels, cols, dtype, None)
    table, _, kk, _ = plain.table(plain_consts, plain_lay.dtype,
                                  torch.device("cpu"), plain_lay.d)
    assert (vector, group, n_smem, threads, smem) == plain.placement(
        plain_lay, kk, table.numel(), quant=False)

    # The float table: the int8 pairs dequantized once, equal to
    # pack_table's at the tier, the head at float32 (the compute width),
    # the same op word; cached for the model arrays.
    got, got_ops, got_k, quant = program.float_table(
        consts, lay.dtype, torch.device("cpu"), lay.d)
    want, want_ops = kchain.pack_table(program.plan, kernels, consts,
                                       lay.dtype, lay.d, pol)
    assert quant is None and got_k == k and got_ops == want_ops == ops
    assert got.numel() == info["n_table"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    head_key = "centroids" if kind == "kmeans" else "coefficient"
    qc = consts[-1][head_key]
    assert isinstance(qc, precision.QuantizedConst)
    deq = (torch.from_numpy(np.asarray(qc.q)).to(torch.float32)
           * torch.from_numpy(np.asarray(qc.scale)).to(torch.float32))
    n_stages = program.plan.n_run * (2 * lay.d + 2)
    head = got[n_stages:n_stages + k * lay.d].reshape(lay.d, k).T
    torch.testing.assert_close(head, deq.to(got.dtype), rtol=0, atol=0)
    assert program.float_table(consts, lay.dtype, torch.device("cpu"),
                               lay.d)[0] is got


def test_int8_table_that_fits_stays_whole():
    """A table that fits beside the rows is still dequantized into shared
    memory whole (784 x k = 64, float32)."""
    kernels, cols = _chain("kmeans", 784, 64)
    program, lay, consts, pol = _program(kernels, cols, np.float32, INT8)
    _, _, info = kchain.pack_int8(program.plan, kernels, consts, lay.d, pol)
    n_smem = program.placement(lay, 64, info["n_table"], quant=True)[2]
    assert n_smem == info["n_table"]


def test_int8_row_no_warp_can_stage_is_refused():
    """A row one warp cannot stage keeps its refusal under the tier, as
    under no policy (a KMeans head over 60,000 columns: 240 KB a float32
    row, 480 KB a float64 one)."""
    kernels, cols = _chain("kmeans", 60_000, 2, rows=8)
    for policy in (INT8, None):
        program, lay, consts, pol = _program(kernels, cols, np.float64,
                                             policy)
        with pytest.raises(fml.KernelUnsupportedError, match="shared memory"):
            program.placement(lay, 2, 10**6, quant=policy is not None)


def test_int8_tier_plain_chain_at_the_repaired_shapes():
    """The plain chain at the tier on these chains (what the card's
    launch is held against): finite, and the assignments and argmax equal
    to the chain over the float table's dequantized constants."""
    for kind, d, k, dtype in (("kmeans", 784, 128, np.float32),
                              ("multinomial", 784, 48, np.float64)):
        kernels, cols = _chain(kind, d, k, rows=40)
        pol = precision.resolve_policy(INT8)
        consts = pf._tier_consts(kernels, pol)
        ext = pf.external_inputs(kernels)
        vals = [torch.from_numpy(np.asarray(cols[c], dtype) if
                                 np.asarray(cols[c]).dtype.kind == "f"
                                 else np.asarray(cols[c])) for c in ext]
        outs = list(kernels[-1].output_cols)
        got = kchain.chain_plain(kernels, ext, outs, vals, consts, 40, pol)
        deq = tuple({n: kchain.boundary_const(pol, v, "cpu")
                     for n, v in kc.items()} for kc in consts)
        want = kchain.chain_plain(kernels, ext, outs, vals, deq, 40, pol)
        for c in outs:
            assert torch.isfinite(got[c].double()).all()
            torch.testing.assert_close(got[c], want[c], rtol=0, atol=0)
