"""CPU serving trace of flinkml_tpu_torch: one engine against N in-process
replicas, and this host's timer wake-up lateness.

    PYTHONPATH=. python tools/torch_cpu_replica_trace.py replicas [--profile]
    PYTHONPATH=. python tools/torch_cpu_replica_trace.py wake [--seconds S]

``replicas`` serves the five-stage chain of ``tests/test_torch_autoscaler.py``
(300 x 6 rows, 32-row buckets, 1 ms window) from a ``ReplicaPool`` of 1, then
3, then 1, then 3 replicas on the CPU, each under 6 closed-loop clients of
8-24 rows for 1.5 s, and prints one JSON line a pool: requests a second,
latency p50/p99, batches a second, segments a batch and the mean time a
batch takes in ``ServingEngine._run_batch``. ``--profile`` adds the
process's top functions by own time under ``cProfile`` for each pool (the
profile slows every call; read it for shares, not times). ``wake`` times 300
``threading.Condition.wait(0.02)`` calls (or as many as ``S`` seconds hold)
in a process that does nothing else, and prints how late they return: run
it beside another command (a test run under ``-n 6``) to see how late that
load makes a thread that holds no lock wake up.

Run it from the repository root (or with another checkout first on
``PYTHONPATH`` to trace that tree); nothing here touches a card.
"""

import cProfile
import io
import json
import pstats
import sys
import threading
import time

import numpy as np


def _pool_trace(n_replicas: int, profile: bool) -> dict:
    import flinkml_tpu_torch.serving.engine as engine_mod
    from tests.test_torch_autoscaler import _chain, _data, _pool

    batches = []
    serve = engine_mod.ServingEngine._run_batch

    def timed(self, batch):
        t0 = time.perf_counter()
        serve(self, batch)
        batches.append((t0, len(batch), time.perf_counter() - t0))

    engine_mod.ServingEngine._run_batch = timed
    x, y = _data()
    pool = _pool(_chain(x, y), x, n_replicas=n_replicas,
                 name=f"trace{n_replicas}", max_queue_rows=512).start()
    stop, lat, lock = threading.Event(), [], threading.Lock()

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            rows = int(rng.integers(8, 25))
            lo = int(rng.integers(0, x.shape[0] - rows))
            t0 = time.perf_counter()
            pool.predict({"features": x[lo:lo + rows]})
            with lock:
                lat.append((time.perf_counter(), time.perf_counter() - t0))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    prof = cProfile.Profile() if profile else None
    if prof is not None:
        prof.enable()
    t0 = time.perf_counter()
    time.sleep(1.5)
    t1 = time.perf_counter()
    if prof is not None:
        prof.disable()
    stop.set()
    for t in threads:
        t.join(30.0)
    pool.stop()
    engine_mod.ServingEngine._run_batch = serve
    ms = np.array([d for tc, d in lat if t0 <= tc < t1]) * 1e3
    won = [(n, d) for tb, n, d in batches if t0 <= tb < t1]
    out = {
        "replicas": n_replicas,
        "requests_per_s": len(ms) / (t1 - t0),
        "p50_ms": float(np.percentile(ms, 50)),
        "p99_ms": float(np.percentile(ms, 99)),
        "batches_per_s": len(won) / (t1 - t0),
        "segments_per_batch": float(np.mean([n for n, _ in won])),
        "batch_ms": float(np.mean([d for _, d in won])) * 1e3,
    }
    if prof is not None:
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(8)
        out["profile_top"] = [
            line.strip() for line in text.getvalue().splitlines()
            if line.strip()[:1].isdigit()
        ]
    return out


def main(argv) -> int:
    if argv[:1] == ["wake"]:
        cond = threading.Condition()
        late = []
        end = (time.monotonic() + float(argv[argv.index("--seconds") + 1])
               if "--seconds" in argv else None)
        while (len(late) < 300 if end is None else time.monotonic() < end):
            with cond:
                t0 = time.monotonic()
                cond.wait(0.02)
                late.append((time.monotonic() - t0 - 0.02) * 1e3)
        late = np.array(late)
        print(json.dumps({
            "waits": len(late), "late_p50_ms": float(np.percentile(late, 50)),
            "late_p99_ms": float(np.percentile(late, 99)),
            "late_max_ms": float(late.max()),
            "late_over_5ms": int((late > 5.0).sum()),
        }))
        return 0
    if argv[:1] != ["replicas"]:
        print(__doc__, file=sys.stderr)
        return 2
    from flinkml_tpu_torch.device import use_device

    with use_device("cpu"):
        for n in (1, 3, 1, 3):
            print(json.dumps(_pool_trace(n, "--profile" in argv)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
