"""Knob searches: measure every candidate through the port's PRODUCT path.

The port's counterpart of ``flinkml_tpu.autotune.search``. Each
``measure_*`` function runs the JAX function's compact scenario (same
shapes, same hyperparameters) on the port's own trainers and engines on
this thread's compute device (``cuda`` unless the caller asked for the
CPU), with the candidate passed as the layout keyword (the port has no
layout env vars), and returns ``{candidate: measured_value}`` in the
knob's unit (throughput; higher is better). A candidate the port refuses
on this device (``Word2Vec(accum="onehot")`` on CUDA tables) maps to the
reason instead: it is recorded as refused, never measured, never the
winner. :func:`settle` converts measurements
into a committed default under the **decisive-win hysteresis rule**: the
static default keeps its seat unless a challenger beats it by more than
:data:`RATIO_FLOOR` (1.10x), so run-to-run noise never flip-flops a
committed default.

``infer_plan_order`` and ``embedding_exchange`` compare multi-rank
layouts: at a world of one rank they measure nothing, and the static
defaults stay.

Device work is timed to its end: every rate reads its result back to the
host (or synchronizes) inside the timed region, and a knob's candidates
are timed in turns, five rounds, each candidate's median kept
(:func:`_in_turns`). ``quick=True`` shrinks
every scenario to smoke size (tests); committed numbers come from a full
run (``python -m flinkml_tpu_torch.autotune --commit``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from flinkml_tpu_torch.autotune.table import KNOWN_KNOBS, TuningTable, mesh_key
from flinkml_tpu_torch.utils.logging import get_logger

_log = get_logger("autotune")

#: A challenger must beat the incumbent by this ratio to take the
#: default (see module docstring).
RATIO_FLOOR = 1.10

#: The static (pre-autotune) defaults — the incumbents hysteresis
#: protects, and the fallbacks consumers use when a mesh has no entry.
#: The JAX package's ``kernel_backend_*`` entries have no counterpart.
STATIC_DEFAULTS: Dict[str, Any] = {
    "sparse_layout": "unsorted",
    "gbt_histogram": "segment",
    "als_reduction": "segment",
    "w2v_accum": "scatter",
    "infer_plan_order": ["batch_parallel", "fsdp", "fsdp_tp"],
    "serving_max_batch_rows": 1024,
    "serving_window_ms": 2.0,
    "embedding_exchange": "ring",
    "serving_scale_up_backlog": 0.5,
    "int8_min_const_elems": 16,
}

@contextlib.contextmanager
def _env(var: str, value: str):
    prev = os.environ.get(var)
    os.environ[var] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = prev


def settle(knob: str, candidates: Dict[str, float],
           incumbent: Any = None) -> Any:
    """The winner under the hysteresis rule. ``candidates`` maps the
    candidate's string form to its measured value; the returned winner
    keeps the candidate's native type for the numeric knobs.

    ``incumbent`` is the value defending its seat — the CURRENTLY
    COMMITTED table value when one exists (once committed, the challenger
    becomes the incumbent and reverting needs its own decisive win), else
    the static default."""
    default = STATIC_DEFAULTS[knob]
    if incumbent is None:
        incumbent = default
    best = max(candidates, key=candidates.get)
    seat = str(incumbent)
    if seat in candidates and candidates[best] <= \
            candidates[seat] * RATIO_FLOOR:
        best = seat
    if isinstance(default, int) and not isinstance(default, bool):
        return int(best)
    if isinstance(default, float):
        return float(best)
    return best


def order_presets(candidates: Dict[str, float]) -> List[str]:
    """The measured ``infer_plan`` candidate order: start from the static
    ascending-communication-cost order and promote a preset past a cheaper
    one only on a decisive (> :data:`RATIO_FLOOR`) throughput win — ties
    keep the static (cheapest-communication) order."""
    order: List[str] = []
    for name in STATIC_DEFAULTS["infer_plan_order"]:
        pos = len(order)
        while pos > 0 and candidates.get(name, 0.0) > \
                candidates.get(order[pos - 1], 0.0) * RATIO_FLOOR:
            pos -= 1
        order.insert(pos, name)
    return order


#: Rounds of :func:`_in_turns` in a full search.
ROUNDS = 5


def _in_turns(rates: Dict[str, Callable[[], float]],
              quick: bool) -> Dict[str, float]:
    """Each candidate's median over :data:`ROUNDS` rounds (one in a quick
    search) of its self-reporting rate, the candidates timed in turns
    within each round, so that drift of the host or the card moves them
    alike. (The JAX package takes each candidate's best of two, one
    candidate after the other; on the card those launch-bound rates
    spread more than the 1.10 floor between runs, and a winner flipped.)
    Builds and warmups happen before the first round."""
    got: Dict[str, List[float]] = {k: [] for k in rates}
    for _ in range(1 if quick else ROUNDS):
        for k, fn in rates.items():
            got[k].append(fn())
    return {k: float(np.median(v)) for k, v in got.items()}


def _world() -> int:
    import torch

    dist = torch.distributed
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


# -- the four sort-class layout knobs ----------------------------------------


def measure_sparse_layout(quick: bool = False) -> Dict[str, float]:
    """Sparse-LR samples/s per gradient layout through the bucketed
    trainer (``prepare_sparse_buckets`` + ``_sparse_trainer_bucketed``,
    the full batch each step, Criteo-profile data)."""
    import torch

    from flinkml_tpu_torch.models import _linear_sgd

    n, dim, nnz = (8_192, 65_536, 16) if quick else (32_768, 262_144, 24)
    steps = 20 if quick else 100
    rng = np.random.default_rng(0)
    indptr = np.arange(n + 1, dtype=np.int64) * nnz
    indices = rng.integers(0, dim, size=n * nnz).astype(np.int32)
    values = rng.normal(size=n * nnz).astype(np.float32)
    y = (rng.random(n) > 0.5).astype(np.float32)
    w = np.ones(n, dtype=np.float32)

    def timed(layout: str) -> Callable[[], float]:
        data_args, local_bss = _linear_sgd.prepare_sparse_buckets(
            indptr, indices, values, dim, y, w, n, seed=0, layout=layout,
        )
        trainer = _linear_sgd._sparse_trainer_bucketed(
            "logistic", local_bss, int(dim), layout,
        )
        coef0 = data_args[1].new_zeros(dim)
        inf = torch.tensor(float("inf"), device=coef0.device)
        hy = tuple(torch.tensor(v, device=coef0.device)
                   for v in (0.1, 0.0, 0.0, 0.0))
        trainer(coef0, 0, inf, *data_args, *hy, 2)[0].cpu()

        def rate() -> float:
            t0 = time.perf_counter()
            coef, steps_out, _ = trainer(coef0, 0, inf, *data_args, *hy,
                                         steps)
            coef.cpu()
            return sum(local_bss) * int(steps_out) / (
                time.perf_counter() - t0
            )

        return rate

    return _in_turns({layout: timed(layout)
                      for layout in _linear_sgd.SPARSE_LAYOUTS}, quick)


def measure_gbt_histogram(quick: bool = False) -> Dict[str, float]:
    """GBT row-tree builds/s per histogram layout (the whole-forest
    builder, ``build_forest(hist_layout=...)``)."""
    from flinkml_tpu_torch.models.gbt import (
        bin_features, build_forest, quantile_bin_edges, sharded_hist_args,
    )
    from flinkml_tpu_torch.parallel import DeviceMesh

    n, d, bins, depth, trees = (
        (8_192, 8, 16, 3, 4) if quick else (65_536, 16, 32, 4, 10)
    )
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(n, d)).astype(np.float32)
    y = (x[:, 0] * x[:, 1] > 0).astype(np.float32)
    w = np.ones(n, dtype=np.float32)
    edges = quantile_bin_edges(x, bins)
    binned = bin_features(x, edges).astype(np.int32)
    mesh = DeviceMesh()
    args = (mesh.shard_batch(binned), mesh.shard_batch(y),
            mesh.shard_batch(w))

    def timed(layout: str) -> Callable[[], float]:
        tables = sharded_hist_args(binned, mesh, bins, layout)

        def build():
            return build_forest(
                *args, base=0.0, lr=0.2, lam=1.0, subsample=1.0, seed=0,
                n_feat=d, n_bins=bins, depth=depth, num_trees=trees,
                logistic=True, hist_layout=layout, hist_tables=tables,
                mesh=mesh,
            )

        build()  # warmup (the kernels build on first use)

        def rate() -> float:
            t0 = time.perf_counter()
            build()  # returns host arrays: the device work is done
            return n * trees / (time.perf_counter() - t0)

        return rate

    return _in_turns({layout: timed(layout)
                      for layout in ("segment", "cumsum")}, quick)


def measure_als_reduction(quick: bool = False) -> Dict[str, float]:
    """ALS rating visits/s per reduction layout through the product
    ``ALS(layout=...).fit``."""
    from flinkml_tpu_torch.models.als import ALS
    from flinkml_tpu_torch.table import Table

    users_n, items_n, nnz, rank, iters = (
        (1_024, 1_024, 1 << 14, 8, 2) if quick
        else (4_096, 4_096, 1 << 18, 16, 4)
    )
    rng = np.random.default_rng(0)
    table = Table({
        "user": rng.integers(0, users_n, size=nnz).astype(np.int32),
        "item": rng.integers(0, items_n, size=nnz).astype(np.int32),
        "rating": rng.uniform(1, 5, size=nnz).astype(np.float32),
    })

    def timed(layout: str) -> Callable[[], float]:
        ALS(layout=layout).set_rank(rank).set_max_iter(1).set_seed(0) \
            .fit(table)

        def rate() -> float:
            t0 = time.perf_counter()
            ALS(layout=layout).set_rank(rank).set_max_iter(iters) \
                .set_seed(0).fit(table)
            return nnz * 2 * iters / (time.perf_counter() - t0)

        return rate

    return _in_turns({layout: timed(layout)
                      for layout in ("segment", "cumsum")}, quick)


def measure_w2v_accum(quick: bool = False) -> Dict[str, Any]:
    """Word2Vec (center, context) pairs/s per embedding-gradient
    accumulation layout (the replicated-table SGNS trainer). ``onehot``
    runs on CPU tables only: on a card it is refused, not measured."""
    from flinkml_tpu_torch.device import default_device
    from flinkml_tpu_torch.models.word2vec import _sgns_trainer
    from flinkml_tpu_torch.ops import threefry
    from flinkml_tpu_torch.parallel import DeviceMesh

    vocab, dim, n_pairs, bs, n_neg, steps = (
        (2_048, 32, 1 << 14, 1_024, 3, 20) if quick
        else (8_192, 64, 1 << 17, 4_096, 5, 60)
    )
    rng = np.random.default_rng(0)
    centers = rng.integers(0, vocab, size=n_pairs).astype(np.int32)
    contexts = rng.integers(0, vocab, size=n_pairs).astype(np.int32)
    weights = np.ones(n_pairs, np.float32)
    pool = rng.integers(0, vocab, size=1 << 14).astype(np.int32)
    v0 = (rng.random((vocab, dim)) - 0.5).astype(np.float32) / dim
    u0 = np.zeros((vocab, dim), np.float32)
    mesh = DeviceMesh()
    device = default_device()
    local_bs = max(1, bs // mesh.axis_size())
    key = threefry.PRNGKey(0, device)
    args = (mesh.shard_batch(centers), mesh.shard_batch(contexts),
            mesh.shard_batch(weights), mesh.replicate(pool))

    def timed(accum: str) -> Callable[[], float]:
        trainer = _sgns_trainer(mesh, local_bs, n_neg, accum)

        def run(n_steps: int) -> None:
            v, _ = trainer(*args, mesh.replicate(v0), mesh.replicate(u0),
                           0.025, n_steps, key)
            v.cpu()

        run(2)

        def rate() -> float:
            t0 = time.perf_counter()
            run(steps)
            return local_bs * mesh.axis_size() * steps / (
                time.perf_counter() - t0
            )

        return rate

    refused = {} if device.type == "cpu" else {
        "onehot": f"runs on CPU tables only ({device} tables here)"}
    return {**_in_turns({a: timed(a) for a in ("scatter", "onehot")
                         if a not in refused}, quick), **refused}


# -- infer_plan preset order -------------------------------------------------


def measure_infer_plan_order(quick: bool = False) -> Dict[str, float]:
    """Plan-sharded trainer samples/s per preset — what turns
    ``infer_plan``'s guessed ascending-communication-cost order into a
    measured one. Needs a process group of more than one rank: at a world
    of one every preset is the same program, so nothing is measured."""
    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.sharding.apply import train_linear_plan
    from flinkml_tpu_torch.sharding.plan import PRESETS

    if _world() <= 1:
        return {}
    n, dim, iters = (4_096, 128, 8) if quick else (16_384, 512, 24)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = (x @ rng.normal(size=dim).astype(np.float32) > 0).astype(np.float32)

    def timed(name: str) -> Callable[[], float]:
        plan = PRESETS[name]
        mesh = DeviceMesh.for_plan(plan)
        train_linear_plan(x, y, None, plan, mesh, max_iter=2)  # warmup

        def rate() -> float:
            t0 = time.perf_counter()
            train_linear_plan(x, y, None, plan, mesh, max_iter=iters)
            return n * iters / (time.perf_counter() - t0)

        return rate

    return _in_turns({name: timed(name)
                      for name in STATIC_DEFAULTS["infer_plan_order"]},
                     quick)


# -- serving bucket cap + batching window ------------------------------------


def _serving_model():
    """A small fused all-kernel chain (scaler → logistic) + example."""
    from flinkml_tpu_torch.models.logistic_regression import (
        LogisticRegression,
    )
    from flinkml_tpu_torch.models.scalers import StandardScaler
    from flinkml_tpu_torch.pipeline import PipelineModel
    from flinkml_tpu_torch.table import Table

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2_048, 16))
    y = (x @ rng.normal(size=16) > 0).astype(np.float64)
    train = Table({"features": x, "label": y})
    scaler = (StandardScaler().set(StandardScaler.INPUT_COL, "features")
              .set(StandardScaler.OUTPUT_COL, "scaled").fit(train))
    (scaled,) = scaler.transform(train)
    lr = (LogisticRegression()
          .set(LogisticRegression.FEATURES_COL, "scaled")
          .set(LogisticRegression.LABEL_COL, "label")
          .set_max_iter(2).fit(scaled))
    return PipelineModel([scaler, lr]), x


def _closed_loop_rate(model, x, max_batch_rows: int, window_ms: float,
                      duration_s: float, n_clients: int = 4) -> float:
    """Closed-loop serving rows/s at the given knob values."""
    from flinkml_tpu_torch.serving.engine import ServingConfig, ServingEngine
    from flinkml_tpu_torch.serving.errors import ServingOverloadError
    from flinkml_tpu_torch.table import Table

    example = Table({"features": x[:4], "label": np.zeros(4)})
    engine = ServingEngine(
        model, example,
        ServingConfig(max_batch_rows=max_batch_rows, max_wait_ms=window_ms,
                      max_queue_rows=max(8_192, 4 * max_batch_rows)),
        name=f"autotune-{max_batch_rows}-{window_ms}",
    ).start()
    rows_done = [0] * n_clients
    stop = threading.Event()

    def client(tid: int) -> None:
        rng = np.random.default_rng(1 + tid)  # one Generator per thread
        while not stop.is_set():
            rows = int(rng.integers(1, 65))
            try:
                engine.predict({"features": x[:rows],
                                "label": np.zeros(rows)})
            except ServingOverloadError:  # overload: keep offering
                continue
            rows_done[tid] += rows

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=5.0)
    elapsed = time.perf_counter() - t0
    engine.stop(drain=False)
    return sum(rows_done) / elapsed


def measure_serving_max_batch_rows(quick: bool = False) -> Dict[str, float]:
    """Closed-loop serving rows/s per power-of-two dispatch bucket cap
    (fixed 2 ms window — the static default)."""
    model, x = _serving_model()
    duration = 0.6 if quick else 2.0
    caps = (256, 1024) if quick else (256, 512, 1024, 2048)
    return {
        str(cap): _closed_loop_rate(model, x, cap, 2.0, duration)
        for cap in caps
    }


def measure_serving_window_ms(quick: bool = False) -> Dict[str, float]:
    """Closed-loop serving rows/s per batching window (fixed 1024-row
    cap — the static default)."""
    model, x = _serving_model()
    duration = 0.6 if quick else 2.0
    windows = (1.0, 2.0) if quick else (0.5, 1.0, 2.0, 4.0)
    return {
        str(w): _closed_loop_rate(model, x, 1024, w, duration)
        for w in windows
    }


def measure_serving_scale_up_backlog(quick: bool = False
                                     ) -> Dict[str, float]:
    """Time-to-recovery per scale-up backlog threshold: a 1-replica pool
    takes a closed-loop load spike it cannot absorb, a
    :class:`~flinkml_tpu_torch.serving.autoscaler.PoolAutoscaler` with
    the candidate threshold closes the loop, and the measurement is how
    fast the pool's backlog EWMA falls back under the FIXED recovery
    criterion (0.4, the JAX package's). Committed as 1/recovery_s so
    that :func:`settle`'s higher-is-better rule holds for every knob. A
    candidate whose pool never saw its spike scores the worst case and
    logs a warning: load generation, not recovery, decided it."""
    from flinkml_tpu_torch.serving import (
        AutoscaleConfig,
        PoolAutoscaler,
        ReplicaPool,
        ServingConfig,
    )
    from flinkml_tpu_torch.serving.errors import (
        PoolUnavailableError,
        ServingOverloadError,
    )
    from flinkml_tpu_torch.table import Table

    model, x = _serving_model()
    thresholds = (0.25, 0.5) if quick else (0.25, 0.5, 0.75)
    timeout_s = 4.0 if quick else 10.0
    out: Dict[str, float] = {}
    for i, thr in enumerate(thresholds):
        pool = ReplicaPool(
            model, Table({"features": x[:4], "label": np.zeros(4)}),
            config=ServingConfig(max_batch_rows=64, max_queue_rows=256,
                                 max_wait_ms=1.0),
            n_replicas=1, output_cols=("prediction",),
            name=f"autotune-scale-{i}",
        ).start()
        scaler = PoolAutoscaler(pool, AutoscaleConfig(
            min_replicas=1, max_replicas=3, scale_up_backlog=thr,
            up_consecutive=2, down_consecutive=10_000,
            cooldown_s=0.2, interval_s=0.05, backlog_alpha=0.5,
        ))
        stop = threading.Event()

        def client(tid: int) -> None:
            rng = np.random.default_rng(7 + tid)  # one Generator per thread
            while not stop.is_set():
                rows = int(rng.integers(24, 49))
                try:
                    pool.predict({"features": x[:rows],
                                  "label": np.zeros(rows)})
                except (ServingOverloadError, PoolUnavailableError):
                    continue  # overload: keep offering

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(6)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        recovery = timeout_s  # worst case: never recovered in budget
        spiked = False
        while time.perf_counter() - t0 < timeout_s:
            scaler.step()
            ewma = scaler._backlog_ewma or 0.0
            if not spiked:
                spiked = ewma > 0.85  # above every candidate's band
            elif ewma < 0.4:
                recovery = time.perf_counter() - t0
                break
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
        pool.stop(drain=False)
        if not spiked:
            _log.warning(
                "autotune: serving_scale_up_backlog candidate %s never "
                "saw its load spike (EWMA stayed under 0.85) — scoring "
                "worst-case %.1fs; treat this mesh's entry with "
                "suspicion", thr, timeout_s,
            )
        out[str(thr)] = 1.0 / max(recovery, 1e-3)
    return out


def measure_int8_min_const_elems(quick: bool = False) -> Dict[str, float]:
    """Fused-chain transform rows/s under the int8 tier per
    minimum-quantizable-constant-size threshold, driven through the
    ``FLINKML_TPU_INT8_MIN_CONST`` gate (the explicit setting), so the
    search measures the exact product path. 200 transforms a rate, where
    the JAX package times 10: one 2,048-row transform takes well under a
    millisecond on the card, and ten of them measured the host's jitter
    (thresholds that quantize the same constants, and so run the same
    program, read 1.5x apart)."""
    from flinkml_tpu_torch import pipeline_fusion
    from flinkml_tpu_torch.table import Table

    model, x = _serving_model()
    table = Table({"features": x, "label": np.zeros(len(x))})
    reps = 3 if quick else 200
    thresholds = (8, 64) if quick else (4, 16, 64, 256)

    def timed(thr: int) -> Callable[[], float]:
        def rate() -> float:
            with _env("FLINKML_TPU_INT8_MIN_CONST", str(thr)), \
                    pipeline_fusion.precision_scope("int8_inference"):
                t0 = time.perf_counter()
                for _ in range(reps):
                    out_t = model.transform(table)[0]
                    np.asarray(out_t.column("prediction"))
                return len(x) * reps / (time.perf_counter() - t0)

        rate()  # warmup: this threshold's program and tables
        return rate

    return _in_turns({str(thr): timed(thr) for thr in thresholds}, quick)


def measure_embedding_exchange(quick: bool = False) -> Dict[str, float]:
    """Lookup+update rows/s per embedding-exchange candidate on a mid-size
    sharded table: ``ring`` and ``all_to_all`` run the real sharded
    exchange over the EMBEDDING-shaped mesh; ``dense_psum`` runs the
    below-threshold placement's cost (a replicated table with one
    vocab-sized gradient all-reduce per step). Needs a process group of
    more than one rank: a table of one shard exchanges nothing."""
    import torch

    from flinkml_tpu_torch.embeddings import EmbeddingTable
    from flinkml_tpu_torch.parallel import DeviceMesh, collectives
    from flinkml_tpu_torch.sharding import EMBEDDING

    if _world() <= 1:
        return {}
    vocab, dim, batch = ((1 << 13, 16, 1 << 11) if quick
                         else (1 << 17, 32, 1 << 13))
    reps = 3 if quick else 10
    rng = np.random.default_rng(0)
    rows0 = rng.normal(size=(vocab, dim)).astype(np.float32)
    ids = rng.integers(0, vocab, batch).astype(np.int32)
    delta = (rng.normal(size=(batch, dim)) * 1e-3).astype(np.float32)
    mesh = DeviceMesh.for_plan(EMBEDDING)

    def timed(strategy: str) -> Callable[[], float]:
        table = EmbeddingTable("tune", vocab, dim, mesh=mesh,
                               plan=EMBEDDING, rows=rows0)
        table.scatter_add(ids, delta, strategy=strategy)   # warmup
        table.lookup(ids).cpu()

        def rate() -> float:
            t0 = time.perf_counter()
            for _ in range(reps):
                table.scatter_add(ids, delta, strategy=strategy)
                table.lookup(ids).cpu()
            return batch * reps / (time.perf_counter() - t0)

        return rate

    rates = {strategy: timed(strategy) for strategy in ("ring", "all_to_all")}
    dmesh = DeviceMesh()
    rows_dev = dmesh.replicate(rows0)
    ids_l = dmesh.shard_batch(ids).long()
    delta_l = dmesh.shard_batch(delta)
    ids_all = dmesh.replicate(ids).long()

    def dense_step() -> None:
        upd = torch.zeros_like(rows_dev).index_add_(0, ids_l, delta_l)
        rows_dev.add_(collectives.psum(dmesh, upd))
        rows_dev.index_select(0, ids_all).cpu()

    dense_step()  # warmup

    def dense_rate() -> float:
        t0 = time.perf_counter()
        for _ in range(reps):
            dense_step()
        return batch * reps / (time.perf_counter() - t0)

    rates["dense_psum"] = dense_rate
    return _in_turns(rates, quick)


# -- the search harness ------------------------------------------------------

MEASURERS: Dict[str, Callable[[bool], Dict[str, Any]]] = {
    "sparse_layout": measure_sparse_layout,
    "gbt_histogram": measure_gbt_histogram,
    "als_reduction": measure_als_reduction,
    "w2v_accum": measure_w2v_accum,
    "infer_plan_order": measure_infer_plan_order,
    "serving_max_batch_rows": measure_serving_max_batch_rows,
    "serving_window_ms": measure_serving_window_ms,
    "embedding_exchange": measure_embedding_exchange,
    "serving_scale_up_backlog": measure_serving_scale_up_backlog,
    "int8_min_const_elems": measure_int8_min_const_elems,
}


def search_knobs(knobs: Optional[Sequence[str]] = None, *,
                 quick: bool = False,
                 source: str = "flinkml_tpu_torch.autotune"
                 ) -> Dict[str, dict]:
    """Measure ``knobs`` (default: all) and settle each winner — the
    seat-holder being the currently COMMITTED table value for this mesh
    when one exists (see :func:`settle`). Returns
    ``{knob: {"value", "unit", "candidates"[, "refused"]}}`` ready for
    :meth:`TuningTable.set_knob`. A knob that measured nothing on this
    mesh (a multi-rank knob at world 1) is left out, logged."""
    from flinkml_tpu_torch.autotune.table import load_table

    committed_mesh = mesh_key()
    table = load_table()
    results: Dict[str, dict] = {}
    for knob in (knobs or list(MEASURERS)):
        if knob not in MEASURERS:
            raise ValueError(
                f"unknown knob {knob!r}; known: {sorted(MEASURERS)}"
            )
        _log.info("autotune: measuring %s ...", knob)
        t0 = time.perf_counter()
        measured = MEASURERS[knob](quick)
        refused = {k: v for k, v in measured.items() if isinstance(v, str)}
        candidates = {k: v for k, v in measured.items() if k not in refused}
        if not candidates:
            _log.info("autotune: %s measures nothing on mesh %s; the "
                      "static default stays", knob, committed_mesh)
            continue
        if knob == "infer_plan_order":
            value: Any = order_presets(candidates)
        else:
            committed = table.value(committed_mesh, knob)
            if committed is not None and str(committed) not in candidates:
                committed = None  # a refused or unmeasured incumbent
            value = settle(knob, candidates, incumbent=committed)
        _log.info(
            "autotune: %s -> %r in %.1fs (candidates: %s)", knob, value,
            time.perf_counter() - t0,
            {k: round(v, 1) for k, v in candidates.items()},
        )
        results[knob] = {
            "value": value,
            "unit": KNOWN_KNOBS[knob],
            "candidates": {k: round(float(v), 2)
                           for k, v in candidates.items()},
        }
        if refused:
            results[knob]["refused"] = refused
    return results


def apply_results(table: TuningTable, results: Dict[str, dict], *,
                  mesh: Optional[str] = None,
                  source: str = "flinkml_tpu_torch.autotune") -> TuningTable:
    mesh = mesh or mesh_key()
    for knob, rec in results.items():
        table.set_knob(
            mesh, knob, rec["value"], candidates=rec["candidates"],
            unit=rec["unit"], source=source, refused=rec.get("refused"),
        )
    return table
