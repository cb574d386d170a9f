"""Worker child process: one ServingEngine behind the frame transport.

Run as ``python -m flinkml_tpu_torch.cluster.worker <spec.pkl>``. The spec
(written by :class:`~flinkml_tpu_torch.cluster.process.WorkerProcess`)
names the model source, the request schema example, the engine config,
the device the parent requested and the compile-cache directory. The
worker configures that store (:mod:`flinkml_tpu_torch.compile_cache`)
and, on ``cuda``, loads every kernel library the pool built there before
the spawn, so a worker runs no ``nvcc``
(:func:`flinkml_tpu_torch.kernels._build.nvcc_runs`; its ``stats`` op
reports the store's counters beside it), and every batch it serves is one
``fused_chain`` launch on its card.

Startup order:

1. make the spec's device the process default
   (:func:`~flinkml_tpu_torch.device.set_default_device`: ``cuda`` on a
   host without a usable card raises, so the start fails and the parent
   raises :class:`~flinkml_tpu_torch.cluster.errors.WorkerSpawnError`),
   then :func:`~flinkml_tpu_torch.parallel.distributed.init_distributed`
   — a no-op single-process unless the parent exported the
   ``FLINKML_TPU_COORD_ADDR``-family rendezvous env;
2. build + start the engine (load, warmup);
3. bind ``127.0.0.1:0``, print ONE JSON ready line
   (``{"ready": true, "port": N, "pid": P, "spawn_stage_ms": ...}``)
   to stdout — the only thing a worker ever writes there; logs go to
   stderr;
4. serve request frames until ``shutdown`` (each connection gets its
   own reader thread; ops run on a small pool so one slow predict
   cannot starve ``ping``).

Every op answers with a RESPONSE frame or a typed ERROR frame
(:func:`~flinkml_tpu_torch.cluster.errors.encode_error`); recognized
serving errors re-raise client-side as themselves, so the router's
failover table is process-transparent. A predict answer holds host numpy
arrays: the engine reads its batch back once, after waiting on its own
CUDA stream, and the op threads never synchronize the device.

The ``cluster.worker`` fault seam fires before every predict dispatch
with ``{"worker", "request"}`` context — a scripted
:class:`~flinkml_tpu_torch.faults.WorkerCrash` hard-exits the process
mid-traffic, which is how the chaos stages kill a real worker instead
of simulating one.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np

from flinkml_tpu_torch import faults
from flinkml_tpu_torch.cluster import protocol
from flinkml_tpu_torch.cluster.errors import (
    ConnectionClosedError,
    OversizedFrameError,
    TransportError,
    TransportTimeoutError,
    encode_error,
)

OPS_THREADS = 8


def _find_embedding_table(model: Any):
    """The served model's embedding stage, if any: a stage (bare or
    inside a pipeline's stages) exposing host ``_rows`` or a bound
    ``_table``."""
    stages = list(getattr(model, "stages", None) or [model])
    for stage in stages:
        if hasattr(stage, "_table") or hasattr(stage, "_rows"):
            return stage
    return None


class WorkerServer:
    """The in-process server; split from ``main`` so tests can run a
    worker inside a thread against scripted transports."""

    def __init__(self, engine: Any, *, name: str = "worker",
                 max_payload: Optional[int] = None):
        self.engine = engine
        self.name = name
        self.max_payload = (
            int(max_payload) if max_payload
            else protocol.DEFAULT_MAX_PAYLOAD
        )
        self._listener: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._ops = ThreadPoolExecutor(
            max_workers=OPS_THREADS, thread_name_prefix=f"{name}-op"
        )
        self._predicts = 0
        self._count_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def bind(self, host: str = "127.0.0.1", port: int = 0) -> int:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        sock.listen(8)
        self._listener = sock
        return sock.getsockname()[1]

    def serve_forever(self) -> None:
        if self._listener is None:
            raise RuntimeError("WorkerServer.bind() first")
        self._listener.settimeout(0.25)
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._serve_connection, args=(conn,),
                name=f"{self.name}-conn", daemon=True,
            ).start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        self._ops.shutdown(wait=False)

    # -- connection loop ---------------------------------------------------
    def _serve_connection(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        try:
            while not self._stop.is_set():
                try:
                    frame = protocol.recv_frame(
                        conn, deadline=time.monotonic() + 1.0,
                        max_payload=self.max_payload,
                    )
                except TransportTimeoutError:
                    continue
                ftype, req_id, payload = frame
                if ftype != protocol.REQUEST:
                    continue
                self._ops.submit(
                    self._handle, conn, send_lock, req_id, payload
                )
        except (ConnectionClosedError, TransportError, OSError):
            pass  # the client hung up or broke the stream: drop it
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, conn: socket.socket, send_lock: threading.Lock,
                req_id: int, payload: Dict[str, Any]) -> None:
        op = str(payload.get("op", ""))
        try:
            result = self._dispatch(op, payload)
            ftype, body = protocol.RESPONSE, result
        except BaseException as e:  # noqa: BLE001 — typed over the wire
            ftype, body = protocol.ERROR, encode_error(e)
        try:
            with send_lock:
                protocol.send_frame(
                    conn, ftype, req_id, body, self.max_payload
                )
        except OSError:
            pass  # client went away; nothing to tell it

    # -- ops ---------------------------------------------------------------
    def _dispatch(self, op: str, p: Dict[str, Any]) -> Dict[str, Any]:
        if op == "ping":
            return {"ok": True, "pid": os.getpid(), "worker": self.name}
        if op == "predict":
            with self._count_lock:
                self._predicts += 1
                n = self._predicts
            if faults.ACTIVE is not None:
                faults.fire("cluster.worker", worker=self.name, request=n)
            resp = self.engine.predict(
                p["columns"], timeout_ms=p.get("timeout_ms")
            )
            return {
                "columns": {
                    c: np.asarray(v) for c, v in resp.columns.items()
                },
                "version": resp.version,
                "shed": resp.shed,
            }
        if op == "stats":
            return self._stats()
        if op == "swap_to":
            return {"version": self.engine.swap_to(p.get("version"))}
        if op == "embedding_rows":
            return self._embedding_rows(p)
        if op == "lease":
            return self._lease_op(p)
        if op == "arm_faults":
            faults.arm(faults.plan_from_json(p["plan_json"]))
            return {"ok": True, "faults": len(faults.ACTIVE.faults)}
        if op == "crash":
            # Test/chaos hook: die NOW, mid-protocol — the client must
            # see WorkerDiedError, never a hang.
            os._exit(int(p.get("code", 11)))
        if op == "shutdown":
            drain = bool(p.get("drain", True))
            threading.Thread(
                target=self._stop_engine, args=(drain,), daemon=True
            ).start()
            return {"ok": True}
        raise ValueError(f"unknown worker op {op!r}")

    def _stats(self) -> Dict[str, Any]:
        """The engine's stats and this process's build audit: programs in
        the fused executor's cache, ``nvcc`` runs, the compile-cache
        store's counters, kernel launches (the port's counterpart of the
        JAX worker's ``pipeline.fusion`` compile counters)."""
        from flinkml_tpu_torch import pipeline_fusion
        from flinkml_tpu_torch.kernels import _build, launch_counts
        from flinkml_tpu_torch.utils.metrics import metrics

        return {
            "stats": self.engine.stats(),
            "compiled_programs": pipeline_fusion.compiled_program_count(),
            "nvcc_runs": _build.nvcc_runs(),
            "compile_cache": metrics.group("compile_cache").snapshot()[
                "counters"],
            "launches": dict(launch_counts()),
            "device": str(getattr(self.engine, "device", "")),
            "pid": os.getpid(),
        }

    def _embedding_rows(self, p: Dict[str, Any]) -> Dict[str, Any]:
        active = getattr(self.engine, "_active", None)
        table = _find_embedding_table(
            active.model if active is not None else None
        )
        if table is None:
            raise ValueError(
                "served model has no embedding stage to exchange rows from"
            )
        ids = np.asarray(p["ids"], np.int64).ravel()
        rows_src = getattr(table, "_rows")
        vocab, dim = rows_src.shape
        want_bytes = int(ids.size) * int(dim) * rows_src.dtype.itemsize
        # The exchange is batch-sized BY CONSTRUCTION — a vocab-sized
        # request is refused before a row is gathered, with the type the
        # framing cap raises.
        budget = self.max_payload // 2
        if ids.size >= vocab or want_bytes > budget:
            raise OversizedFrameError(
                f"embedding row request of {ids.size} ids "
                f"({want_bytes} bytes) is not batch-sized "
                f"(vocab {vocab}, payload budget {budget}); "
                "exchange batch-sized id sets only"
            )
        if ids.size and (ids.min() < 0 or ids.max() >= vocab):
            raise ValueError(f"embedding ids out of range [0, {vocab})")
        bound = getattr(table, "_table", None)
        if bound is not None:
            rows = np.asarray(bound.lookup(ids.astype(np.int32)))
        else:
            rows = np.asarray(rows_src)[ids]
        return {"rows": rows, "dim": int(dim)}

    def _stop_engine(self, drain: bool) -> None:
        try:
            self.engine.stop(drain=drain, timeout=10.0)
        finally:
            self.shutdown()

    def _lease_op(self, p: Dict[str, Any]) -> Dict[str, Any]:
        """Cross-process lease reclaim: the revoke→release handshake
        served over the transport. ``list`` exposes this process's active
        slice leases; ``request_revoke`` asks the holder to wind down;
        ``wait_released`` blocks (bounded) until the holder's own release
        lands. ``acquire``/``release`` exist so tests can stand up a real
        lease inside the worker: on a one-device mesh of this worker's
        device (its rank 0)."""
        from flinkml_tpu_torch.parallel import dispatch as pdispatch

        cmd = str(p.get("cmd", "list"))
        if cmd == "list":
            return {
                "leases": [ls.snapshot() for ls in pdispatch.active_leases()]
            }
        if cmd == "acquire":
            from flinkml_tpu_torch.parallel.mesh import DeviceMesh

            lease = pdispatch.lease_devices(
                DeviceMesh(devices=[0]), str(p.get("holder", "worker-trainer"))
            )
            if bool(p.get("cooperative", False)):
                # Stand in for a trainer honoring the revoke contract:
                # watch for request_revoke and release at the next safe
                # point (here: immediately) — the holder-side half the
                # cross-process reclaim handshake needs to complete.
                def _honor_revoke(ls=lease):
                    while ls.active:
                        if ls.revoke_requested():
                            ls.release()
                            return
                        time.sleep(0.05)

                threading.Thread(
                    target=_honor_revoke,
                    name=f"{self.name}-lease-holder", daemon=True,
                ).start()
            return {"token": lease.token, "devices": sorted(lease.devices)}
        token = str(p.get("token", ""))
        lease = next(
            (ls for ls in pdispatch.active_leases() if ls.token == token),
            None,
        )
        if cmd == "request_revoke":
            if lease is None:
                return {"found": False, "released": True}
            lease.request_revoke(str(p.get("reason", "remote reclaim")))
            return {"found": True, "released": False}
        if cmd == "release":
            if lease is not None:
                lease.release()
            return {"found": lease is not None, "released": True}
        if cmd == "wait_released":
            if lease is None:
                return {"found": False, "released": True}
            released = lease.wait_released(
                timeout=float(p.get("timeout_s", 5.0))
            )
            return {"found": True, "released": bool(released)}
        raise ValueError(f"unknown lease cmd {cmd!r}")


def build_engine_from_spec(spec: Dict[str, Any]):
    """Engine construction shared by ``main`` and in-thread test
    servers. The spec is the pickled dict WorkerSpec writes; the engine
    runs on the calling thread's requested device."""
    from flinkml_tpu_torch.serving import (
        ModelRegistry,
        ServingConfig,
        ServingEngine,
    )
    from flinkml_tpu_torch.table import Table

    source_spec = spec["source"]
    kind = source_spec.get("kind")
    if kind == "registry":
        source = ModelRegistry(source_spec["root"])
    elif kind == "fixed_via_registry":
        # A fixed (registry-less) model shipped through the registry's
        # save/load machinery because it does not pickle: load it back
        # and serve it FIXED (version=None responses, exactly like the
        # in-process engine would).
        _, source = ModelRegistry(source_spec["root"]).get()
    else:
        source = pickle.loads(source_spec["blob"])
    config = ServingConfig(**(spec.get("config") or {}))
    example = Table(dict(spec["example"]))
    return ServingEngine(
        source, example, config,
        output_cols=spec.get("output_cols"),
        name=spec.get("name", "worker"),
    )


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m flinkml_tpu_torch.cluster.worker <spec.pkl>",
              file=sys.stderr)
        return 2
    t0 = time.monotonic()
    with open(argv[0], "rb") as f:
        spec = pickle.load(f)

    from flinkml_tpu_torch.device import default_device, set_default_device
    from flinkml_tpu_torch.parallel import init_distributed
    from flinkml_tpu_torch.utils.logging import get_logger

    log = get_logger("cluster.worker")
    if spec.get("compile_cache_dir"):
        from flinkml_tpu_torch import compile_cache

        compile_cache.configure(spec["compile_cache_dir"])
    # The parent's device, or a failed start: never a CPU carry-on.
    set_default_device(spec.get("device", "cuda"))
    if default_device().type == "cuda":
        # Every kernel library from the store: a respawn runs no nvcc.
        from flinkml_tpu_torch.kernels import _build

        _build.load_all()
    # Env-driven rendezvous (FLINKML_TPU_COORD_ADDR et al. — a no-op
    # single-process): world size = process count.
    rank, world = init_distributed()

    engine = build_engine_from_spec(spec)
    engine.start()

    server = WorkerServer(
        engine, name=spec.get("name", "worker"),
        max_payload=spec.get("max_payload"),
    )
    port = server.bind()
    # The ready line: the ONE stdout write, parsed by WorkerProcess.
    print(json.dumps({
        "ready": True, "port": port, "pid": os.getpid(),
        "rank": rank, "world": world, "device": str(engine.device),
        "spawn_stage_ms": round((time.monotonic() - t0) * 1000.0, 1),
    }), flush=True)
    log.info("worker %s serving on 127.0.0.1:%d (rank %d/%d, %s)",
             spec.get("name", "worker"), port, rank, world, engine.device)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
