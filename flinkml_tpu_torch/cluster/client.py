"""Client half of the worker transport: one multiplexed connection.

The port's counterpart of the JAX package's ``cluster/client.py``, a
copy of it.

A :class:`WorkerClient` owns one TCP connection to a worker and
multiplexes any number of in-flight requests over it, correlated by the
frame's request id. A single reader thread completes requests as
response/error frames arrive and sweeps per-request transport deadlines
between reads, so a silent worker surfaces as
:class:`~flinkml_tpu_torch.cluster.errors.TransportTimeoutError` on exactly
the overdue requests — never as an unbounded block. When the connection
dies (EOF, reset, torn frame) every request still in flight fails with
:class:`~flinkml_tpu_torch.cluster.errors.WorkerDiedError`: the typed signal
the serving router turns into retire-and-failover.

``submit`` is callback-style (the RemoteEngine completes a
``ServingRequest`` from the reader thread — no extra hop); ``call`` is
the synchronous convenience built on it.
"""

from __future__ import annotations

import itertools
import socket
import threading
import time
from typing import Any, Callable, Dict, Optional

from flinkml_tpu_torch.cluster import protocol
from flinkml_tpu_torch.cluster.errors import (
    ConnectionClosedError,
    TransportError,
    TransportTimeoutError,
    WorkerDiedError,
    decode_error,
)
from flinkml_tpu_torch.utils.logging import get_logger

_log = get_logger("cluster.client")

#: on_done callback: (payload_or_None, error_or_None) — exactly one set.
DoneCallback = Callable[[Optional[Dict[str, Any]],
                         Optional[BaseException]], None]


class _Inflight:
    __slots__ = ("deadline", "on_done")

    def __init__(self, deadline: Optional[float], on_done: DoneCallback):
        self.deadline = deadline
        self.on_done = on_done


class WorkerClient:
    """One connection to one worker; thread-safe."""

    def __init__(self, host: str, port: int, *,
                 max_payload: int = protocol.DEFAULT_MAX_PAYLOAD,
                 connect_timeout_s: float = 10.0,
                 on_transport_latency: Optional[
                     Callable[[float], None]] = None,
                 metrics_group: Optional[Any] = None):
        self.host = host
        self.port = port
        self.max_payload = int(max_payload)
        self.connect_timeout_s = float(connect_timeout_s)
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._inflight: Dict[int, _Inflight] = {}
        self._ids = itertools.count(1)
        self._reader: Optional[threading.Thread] = None
        self._closed = False
        self._ever_connected = False
        self._on_transport_latency = on_transport_latency
        self._metrics = metrics_group
        self.reconnects_total = 0

    # -- lifecycle ---------------------------------------------------------
    @property
    def connected(self) -> bool:
        return self._sock is not None and not self._closed

    def connect(self) -> "WorkerClient":
        """Connect (or reconnect after a drop) and start the reader."""
        with self._state_lock:
            if self._sock is not None:
                return self
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout_s
            )
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
            self._closed = False
            if self._ever_connected:
                self.reconnects_total += 1
                if self._metrics is not None:
                    self._metrics.counter("reconnects_total")
            self._ever_connected = True
            self._reader = threading.Thread(
                target=self._read_loop, args=(sock,),
                name=f"cluster-client-{self.host}:{self.port}", daemon=True,
            )
            self._reader.start()
        return self

    def close(self) -> None:
        with self._state_lock:
            self._closed = True
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
        self._fail_all(WorkerDiedError("client closed"))

    # -- request path ------------------------------------------------------
    def submit(self, op: str, payload: Optional[Dict[str, Any]] = None,
               deadline: Optional[float] = None,
               on_done: Optional[DoneCallback] = None) -> int:
        """Send one request; ``on_done`` fires from the reader thread
        with the response payload or a typed error. ``deadline`` is
        absolute ``time.monotonic()`` — the client-side transport
        deadline, swept even if the worker never answers."""
        sock = self._sock
        if sock is None or self._closed:
            raise WorkerDiedError(
                f"no connection to worker {self.host}:{self.port}"
            )
        req_id = next(self._ids)
        body = {"op": op}
        if payload:
            body.update(payload)
        frame = protocol.encode_frame(
            protocol.REQUEST, req_id, body, self.max_payload
        )
        if on_done is not None:
            with self._state_lock:
                self._inflight[req_id] = _Inflight(deadline, on_done)
        try:
            with self._send_lock:
                sock.sendall(frame)
        except OSError as e:
            with self._state_lock:
                self._inflight.pop(req_id, None)
            self._drop(WorkerDiedError(f"send failed: {e}"))
            raise WorkerDiedError(f"send to worker failed: {e}") from e
        return req_id

    def call(self, op: str, payload: Optional[Dict[str, Any]] = None,
             timeout_s: Optional[float] = 30.0) -> Dict[str, Any]:
        """Synchronous RPC: raises the typed error the worker (or the
        transport) produced."""
        done = threading.Event()
        box: Dict[str, Any] = {}

        def _done(result, error):
            box["result"], box["error"] = result, error
            done.set()

        deadline = (
            time.monotonic() + timeout_s if timeout_s is not None else None
        )
        self.submit(op, payload, deadline=deadline, on_done=_done)
        # The reader thread sweeps the deadline; the extra grace only
        # covers a reader wedged in recv — it still surfaces typed.
        if not done.wait(None if timeout_s is None else timeout_s + 1.0):
            raise TransportTimeoutError(
                f"worker {self.host}:{self.port} did not answer "
                f"{op!r} within {timeout_s}s"
            )
        if box["error"] is not None:
            raise box["error"]
        return box["result"]

    # -- reader ------------------------------------------------------------
    def _read_loop(self, sock: socket.socket) -> None:
        # FrameReader accumulates partial frames across polls, so the
        # deadline-sweeping wakeups below never tear a frame mid-read.
        reader = protocol.FrameReader(sock, self.max_payload)
        while True:
            if self._closed or self._sock is not sock:
                return
            try:
                frame = reader.poll(timeout_s=0.05)
            except ConnectionClosedError:
                self._drop(WorkerDiedError(
                    f"worker {self.host}:{self.port} closed the "
                    "connection"
                ), sock)
                return
            except (TransportError, OSError) as e:
                self._drop(WorkerDiedError(
                    f"worker {self.host}:{self.port} transport broke: "
                    f"{type(e).__name__}: {e}"
                ), sock)
                return
            if frame is None:
                self._sweep_deadlines()
                continue
            ftype, req_id, payload = frame
            with self._state_lock:
                entry = self._inflight.pop(req_id, None)
            if entry is None:  # deadline-swept or never ours: discard
                continue
            if ftype == protocol.ERROR:
                self._complete(entry, None, decode_error(payload))
            else:
                self._complete(entry, payload, None)
            self._sweep_deadlines()

    def _sweep_deadlines(self) -> None:
        now = time.monotonic()
        expired = []
        with self._state_lock:
            for req_id, entry in list(self._inflight.items()):
                if entry.deadline is not None and entry.deadline <= now:
                    expired.append((req_id, entry))
                    del self._inflight[req_id]
        for req_id, entry in expired:
            self._complete(entry, None, TransportTimeoutError(
                f"request {req_id} to worker {self.host}:{self.port} "
                "exceeded its transport deadline"
            ))

    def _complete(self, entry: _Inflight,
                  result: Optional[Dict[str, Any]],
                  error: Optional[BaseException]) -> None:
        try:
            entry.on_done(result, error)
        except Exception:  # noqa: BLE001 — a callback must not kill the reader
            _log.exception("on_done callback raised")

    def _drop(self, error: WorkerDiedError,
              sock: Optional[socket.socket] = None) -> None:
        """Connection is gone: detach it and fail everything in flight."""
        with self._state_lock:
            if sock is not None and self._sock is not sock:
                return  # a reconnect already replaced it
            dead, self._sock = self._sock, None
        if dead is not None:
            try:
                dead.close()
            except OSError:
                pass
        self._fail_all(error)

    def _fail_all(self, error: BaseException) -> None:
        with self._state_lock:
            pending = list(self._inflight.values())
            self._inflight.clear()
        for entry in pending:
            self._complete(entry, None, error)

    @property
    def inflight(self) -> int:
        with self._state_lock:
            return len(self._inflight)
