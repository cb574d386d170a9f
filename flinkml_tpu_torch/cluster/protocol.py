"""Length-prefixed frame protocol for worker IPC (localhost TCP).

The port's counterpart of the JAX package's ``cluster/protocol.py``, a
copy of it: the same bytes on the wire, so a frame either package writes
parses in the other. Payloads hold numpy arrays and plain Python values only, never
a torch tensor (a CUDA tensor would pickle a device pointer).

Wire format (all integers big-endian)::

    +-------+------+------------+-----------+------------------+
    | magic | type | request id | length    | payload          |
    | 4 B   | 1 B  | 8 B        | 8 B       | `length` bytes   |
    +-------+------+------------+-----------+------------------+

- ``magic`` is ``b"FMC1"`` — protocol/version tag; anything else is a
  :class:`~flinkml_tpu_torch.cluster.errors.FrameError` (the stream is not
  ours, or it de-synced).
- ``type`` is one of :data:`REQUEST` / :data:`RESPONSE` /
  :data:`ERROR`.
- ``request id`` correlates a response (or error) frame with its
  request — the client multiplexes any number of in-flight requests on
  one connection.
- ``length`` is capped (:data:`DEFAULT_MAX_PAYLOAD`, ~64 MiB): the
  sender refuses an oversized payload before writing a byte, and the
  receiver refuses on the HEADER, before allocating or reading the
  payload — a misbehaving peer cannot make either side buffer a
  vocab-sized transfer
  (:class:`~flinkml_tpu_torch.cluster.errors.OversizedFrameError`).
- ``payload`` is a pickled dict (protocol 5 — numpy columns ride as
  contiguous buffers). Error frames carry ``{"etype", "message"}``
  only, never pickled exception objects (see
  :func:`flinkml_tpu_torch.cluster.errors.decode_error`).

Deadlines are enforced PER BYTE, not per frame: :func:`recv_frame`
slices its socket timeout against an absolute monotonic deadline, so a
peer that sends half a frame and stalls surfaces as
:class:`~flinkml_tpu_torch.cluster.errors.TransportTimeoutError` when the
deadline passes — mid-read, not after an unbounded block. EOF at a
frame boundary is the distinct
:class:`~flinkml_tpu_torch.cluster.errors.ConnectionClosedError` (a clean
hang-up); EOF anywhere inside a frame is a torn frame
(:class:`~flinkml_tpu_torch.cluster.errors.FrameError`).

This module imports neither torch nor numpy — the framing tests exercise
it against scripted sockets.
"""

from __future__ import annotations

import io
import pickle
import socket
import struct
import time
from typing import Any, Dict, Optional, Tuple

from flinkml_tpu_torch.cluster.errors import (
    ConnectionClosedError,
    FrameError,
    OversizedFrameError,
    TransportTimeoutError,
)

MAGIC = b"FMC1"
REQUEST = 0x01
RESPONSE = 0x02
ERROR = 0x03

_HEADER = struct.Struct(">4sBQQ")
HEADER_SIZE = _HEADER.size

#: Per-frame payload cap. Generous for batch-sized serving payloads
#: (a 1024-row float64 batch of a few hundred features is ~4 MB) while
#: refusing vocab-sized embedding-table transfers outright.
DEFAULT_MAX_PAYLOAD = 64 * 1024 * 1024

#: Socket-timeout slice used to poll the deadline while reading.
_POLL_S = 0.25


def dumps(payload: Dict[str, Any]) -> bytes:
    return pickle.dumps(payload, protocol=5)


def loads(raw: bytes) -> Dict[str, Any]:
    return pickle.loads(raw)


def encode_frame(ftype: int, request_id: int, payload: Dict[str, Any],
                 max_payload: int = DEFAULT_MAX_PAYLOAD) -> bytes:
    """Serialize one frame; refuses oversized payloads before building
    the buffer a send would write."""
    raw = dumps(payload)
    if len(raw) > max_payload:
        raise OversizedFrameError(
            f"frame payload is {len(raw)} bytes > cap {max_payload}; "
            "split the request (batch-sized payloads only)"
        )
    return _HEADER.pack(MAGIC, ftype, request_id, len(raw)) + raw


def send_frame(sock: socket.socket, ftype: int, request_id: int,
               payload: Dict[str, Any],
               max_payload: int = DEFAULT_MAX_PAYLOAD) -> None:
    sock.sendall(encode_frame(ftype, request_id, payload, max_payload))


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float]) -> bytes:
    """Read exactly ``n`` bytes, polling ``deadline`` (absolute
    ``time.monotonic()``) between socket-timeout slices. Raises
    :class:`ConnectionClosedError` on EOF at offset 0,
    :class:`FrameError` on EOF mid-buffer (torn), and
    :class:`TransportTimeoutError` when the deadline passes mid-read."""
    buf = io.BytesIO()
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TransportTimeoutError(
                    f"transport deadline expired mid-read "
                    f"({got}/{n} bytes)"
                )
            sock.settimeout(min(_POLL_S, remaining))
        else:
            sock.settimeout(_POLL_S)
        try:
            chunk = sock.recv(n - got)
        except socket.timeout:
            continue
        if not chunk:
            if got == 0:
                raise ConnectionClosedError("peer closed the connection")
            raise FrameError(
                f"torn frame: peer closed after {got}/{n} bytes"
            )
        buf.write(chunk)
        got += len(chunk)
    return buf.getvalue()


def recv_frame(
    sock: socket.socket,
    deadline: Optional[float] = None,
    max_payload: int = DEFAULT_MAX_PAYLOAD,
) -> Tuple[int, int, Dict[str, Any]]:
    """Read one frame → ``(type, request_id, payload)``. The deadline
    covers header AND payload bytes; the payload length is validated
    against ``max_payload`` before a payload byte is read."""
    header = _recv_exact(sock, HEADER_SIZE, deadline)
    magic, ftype, request_id, length = _HEADER.unpack(header)
    if magic != MAGIC:
        raise FrameError(
            f"bad frame magic {magic!r} (expected {MAGIC!r}); "
            "stream is de-synced or not a cluster transport"
        )
    if length > max_payload:
        raise OversizedFrameError(
            f"peer declared a {length}-byte payload > cap {max_payload}; "
            "refusing to read it"
        )
    raw = _recv_exact(sock, length, deadline) if length else b""
    try:
        payload = loads(raw)
    except Exception as e:
        raise FrameError(f"undecodable frame payload: {e}") from e
    return ftype, request_id, payload


class FrameReader:
    """Incremental frame parser for a reader loop that must wake on a
    cadence (to sweep request deadlines) WITHOUT tearing a partially
    received frame: bytes accumulate across :meth:`poll` calls, so a
    frame larger than one ``recv`` — or one that straddles two polls —
    reassembles instead of de-syncing the stream.

    ``poll`` returns one complete frame or ``None`` at the timeout;
    it raises the same typed errors as :func:`recv_frame` (bad magic,
    oversized header, torn frame at EOF, clean close)."""

    def __init__(self, sock: socket.socket,
                 max_payload: int = DEFAULT_MAX_PAYLOAD):
        self._sock = sock
        self._max_payload = int(max_payload)
        self._buf = bytearray()

    def poll(self, timeout_s: float = _POLL_S
             ) -> Optional[Tuple[int, int, Dict[str, Any]]]:
        frame = self._try_parse()
        if frame is not None:
            return frame
        self._sock.settimeout(timeout_s)
        try:
            chunk = self._sock.recv(1 << 20)
        except socket.timeout:
            return None
        if not chunk:
            if self._buf:
                raise FrameError(
                    f"torn frame: peer closed with {len(self._buf)} "
                    "buffered bytes mid-frame"
                )
            raise ConnectionClosedError("peer closed the connection")
        self._buf.extend(chunk)
        return self._try_parse()

    def _try_parse(self) -> Optional[Tuple[int, int, Dict[str, Any]]]:
        if len(self._buf) < HEADER_SIZE:
            return None
        magic, ftype, request_id, length = _HEADER.unpack_from(self._buf)
        if magic != MAGIC:
            raise FrameError(
                f"bad frame magic {bytes(magic)!r} (expected {MAGIC!r})"
            )
        if length > self._max_payload:
            raise OversizedFrameError(
                f"peer declared a {length}-byte payload > cap "
                f"{self._max_payload}; refusing to read it"
            )
        if len(self._buf) < HEADER_SIZE + length:
            return None
        raw = bytes(self._buf[HEADER_SIZE:HEADER_SIZE + length])
        del self._buf[:HEADER_SIZE + length]
        try:
            payload = loads(raw)
        except Exception as e:
            raise FrameError(f"undecodable frame payload: {e}") from e
        return ftype, request_id, payload
