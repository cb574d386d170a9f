"""Clean-process ClusterPool scenario behind ``tests/test_torch_cluster.py``
(the port's counterpart of ``tests/_cluster_child.py``; imports no JAX).

Usage: ``python tests/_torch_cluster_child.py <workdir>``. The pytest parent
saved the five-stage chain (fitted in the JAX package) under
``<workdir>/model`` and the request rows in ``<workdir>/x.npy``; this
script loads the chain in the port, on the CPU, and:

1. serves it from an in-process reference engine AND a 2-worker
   :class:`~flinkml_tpu_torch.cluster.ClusterPool`: the responses must be
   bit for bit identical across the process boundary (every row of
   ``x.npy`` goes through both; the parent holds them against JAX);
2. stands a lease up INSIDE a worker and reclaims it over the wire;
3. arms a :class:`~flinkml_tpu_torch.faults.WorkerCrash` inside one
   worker over the transport (``arm_faults``) and keeps closed-loop
   traffic flowing: the worker hard-exits mid-traffic and ZERO requests
   are lost (typed ``WorkerDiedError`` → router failover);
4. ``respawn_dead()``: the successor runs no ``nvcc`` and builds the same
   number of fused programs as its predecessor, that count stays flat
   under traffic, and parity holds.

It prints one JSON report line and writes the served outputs to
``<workdir>/served.npz``.
"""

import json
import os
import sys
import threading
import time

SERVED = ("s4", "prediction", "rawPrediction")


def main() -> int:
    workdir = sys.argv[1]
    from _torch_threads import cap_torch_threads

    cap_torch_threads()

    import numpy as np

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.cluster import ClusterPool, reclaim_worker_leases
    from flinkml_tpu_torch.pipeline import PipelineModel
    from flinkml_tpu_torch.serving import ServingConfig, ServingEngine
    from flinkml_tpu_torch.table import Table

    fml.set_default_device("cpu")
    x = np.load(os.path.join(workdir, "x.npy"))
    model = PipelineModel.load(os.path.join(workdir, "model"))
    example = Table({"features": x[:4]})
    cfg = ServingConfig(max_batch_rows=64, max_queue_rows=4096,
                        max_wait_ms=1.0, default_timeout_ms=20_000.0)

    def serve_all(target):
        out = {c: [] for c in SERVED}
        for lo in range(0, x.shape[0], 50):
            resp = target.predict({"features": x[lo:lo + 50]})
            for c in SERVED:
                out[c].append(np.asarray(resp.column(c)))
        return {c: np.concatenate(v) for c, v in out.items()}

    ref = ServingEngine(model, example, cfg, output_cols=SERVED,
                        name="ref").start()
    ref_all = serve_all(ref)

    pool = ClusterPool(model, example, config=cfg, n_workers=2,
                       output_cols=SERVED, name="child").start()
    pool_all = serve_all(pool)
    parity = all(np.array_equal(ref_all[c], pool_all[c]) for c in SERVED)
    before = [r.engine.worker_stats() for r in pool.replicas]

    # -- cross-process lease reclaim: a REAL lease inside a worker.
    client0 = pool.worker_clients()[0]
    acquired = client0.call("lease", {"cmd": "acquire",
                                      "holder": "child-trainer",
                                      "cooperative": True})
    reclaimed = reclaim_worker_leases(
        client0, device_ids=acquired["devices"], timeout_s=10.0
    )
    leases_after = client0.call("lease", {"cmd": "list"})["leases"]

    # -- kill one worker MID-TRAFFIC through the cluster.worker seam.
    victim = pool.replicas[0]
    marker = os.path.join(victim.engine.process.workdir, "crash.marker")
    plan_json = faults.plan_to_json(faults.FaultPlan(
        faults.WorkerCrash(at=1, key="request", exit_code=23,
                           marker=marker)
    ))
    errs, done, mismatched = [], [0], [0]
    stop = threading.Event()

    def client_loop(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            lo = int(rng.integers(0, x.shape[0] - 8))
            try:
                r = pool.predict({"features": x[lo:lo + 8]})
            except Exception as e:  # noqa: BLE001 — report, don't mask
                errs.append(repr(e))
                continue
            if not np.array_equal(np.asarray(r.column("rawPrediction")),
                                  ref_all["rawPrediction"][lo:lo + 8]):
                mismatched[0] += 1
            done[0] += 1

    threads = [threading.Thread(target=client_loop, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    victim.engine.client.call("arm_faults", {"plan_json": plan_json})
    deadline = time.monotonic() + 20.0
    while victim.engine.process.alive and time.monotonic() < deadline:
        time.sleep(0.05)
    crashed_rc = victim.engine.process.returncode
    time.sleep(1.0)  # post-crash traffic rides the survivor
    stop.set()
    for t in threads:
        t.join(30.0)
    health = {r.name: r.health.state.name for r in pool.replicas}

    # -- respawn: no nvcc, the same program count, flat under traffic.
    replaced = pool.respawn_dead()
    warm = replaced[0].engine.worker_stats()
    post_all = serve_all(pool)
    for _ in range(20):
        pool.predict({"features": x[:13]})
    after_traffic = replaced[0].engine.worker_stats()
    post_parity = all(np.array_equal(ref_all[c], post_all[c])
                      for c in SERVED)

    snap = pool.cluster_metrics.snapshot()
    alive_gauge = snap["gauges"].get("workers_alive")
    np.savez(os.path.join(workdir, "served.npz"),
             **{f"pool_{c}": pool_all[c] for c in SERVED},
             **{f"ref_{c}": ref_all[c] for c in SERVED})
    pool.stop()
    ref.stop()

    print(json.dumps({
        "parity_bitwise": bool(parity),
        "lease_acquired": acquired,
        "lease_reclaimed": [
            {"released": r["released"], "holder": r.get("holder")}
            for r in reclaimed
        ],
        "leases_after": len(leases_after),
        "crashed_rc": crashed_rc,
        "requests_ok": done[0],
        "requests_lost": len(errs),
        "requests_mismatched": mismatched[0],
        "errors_sample": errs[:3],
        "health_after_crash": health,
        "respawned": [r.name for r in replaced],
        "predecessor_programs": [s["compiled_programs"] for s in before],
        "predecessor_devices": [s["device"] for s in before],
        "respawn_programs": warm["compiled_programs"],
        "respawn_programs_after_traffic":
            after_traffic["compiled_programs"],
        "respawn_nvcc_runs": warm["nvcc_runs"],
        "post_respawn_parity": bool(post_parity),
        "workers_alive_gauge": alive_gauge,
        "transport_p99_ms": snap["gauges"].get("p99_ms"),
        "spawn_ms_samples": len(snap["histories"].get("spawn_ms", [])),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
