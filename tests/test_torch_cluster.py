"""flinkml_tpu_torch.cluster: the multi-process worker runtime, on the CPU,
against the JAX package.

Mirrors the JAX package's ``tests/test_cluster.py`` case for case:

1. transport framing edge cases against scripted sockets — torn frames,
   oversized refusal on BOTH sides, deadline expiry mid-read, worker
   death mid-response — every failure a TYPED error; the frames and error
   payloads are the JAX package's bytes;
2. the worker server + client in-process (op dispatch, error-frame
   reconstruction, batch-sized embedding exchange with a fake stage,
   request correlation);
3. the env rendezvous family and the ``WorkerCrash`` plan, held against
   the JAX package's;
4. the full multi-process scenarios in clean child interpreters
   (``tests/_torch_cluster_child.py``: bitwise parity with the port's
   in-process engine and 1e-10 against JAX's per-stage transform,
   kill-mid-traffic with zero lost requests, a respawn that runs no
   ``nvcc`` with a flat program count, cross-process lease reclaim, the
   metrics; ``tests/_torch_elastic_rank.py``: a real world-shrink resume
   through the rank-scoped snapshot family's layout tags).

The JAX package's lease-reclaim and metrics cases fail on this host (its
compile-cache store; ROADMAP.md Queue 3), so the port's are held against
their own assertions only. Every child run has its own timeout.
"""

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

import flinkml_tpu.cluster as jax_cluster
from flinkml_tpu import faults as jax_faults
from flinkml_tpu.cluster import errors as jax_errors
from flinkml_tpu.cluster import protocol as jax_protocol
from flinkml_tpu.parallel import init_distributed as jax_init_distributed
from flinkml_tpu_torch import faults
from flinkml_tpu_torch.cluster import (
    ElasticProcessWorld,
    WorkerClient,
    WorkerProcess,
    WorkerSpawnError,
    WorkerSpec,
    rendezvous_env,
)
from flinkml_tpu_torch.cluster import protocol
from flinkml_tpu_torch.cluster.errors import (
    ConnectionClosedError,
    FrameError,
    OversizedFrameError,
    RemoteError,
    TransportTimeoutError,
    WorkerDiedError,
    decode_error,
    encode_error,
)
from flinkml_tpu_torch.cluster.process import visible_cards
from flinkml_tpu_torch.cluster.worker import WorkerServer
from flinkml_tpu_torch.parallel import distributed as tdist
from flinkml_tpu_torch.serving.errors import (
    ServingOverloadError,
    ServingSchemaError,
)
from tests._torch_serving_common import _on_cpu, _time_limit  # noqa: F401

_HERE = os.path.dirname(os.path.abspath(__file__))
CHILD_TIMEOUT_S = 100


def _child_env(**extra):
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.dirname(_HERE)]
        + ([os.environ["PYTHONPATH"]]
           if os.environ.get("PYTHONPATH") else [])
    ), **extra}


# ---------------------------------------------------------------------------
# 1. Framing edge cases (scripted sockets)
# ---------------------------------------------------------------------------

def _pair():
    return socket.socketpair()


def test_frame_roundtrip():
    a, b = _pair()
    try:
        protocol.send_frame(a, protocol.REQUEST, 7,
                            {"op": "ping", "x": np.arange(3)})
        ftype, rid, payload = protocol.recv_frame(
            b, deadline=time.monotonic() + 2.0
        )
        assert (ftype, rid) == (protocol.REQUEST, 7)
        assert payload["op"] == "ping"
        np.testing.assert_array_equal(payload["x"], np.arange(3))
    finally:
        a.close(), b.close()


@pytest.mark.parametrize("payload", [
    {"op": "ping", "x": np.arange(3)},
    {"columns": {"features": np.linspace(0, 1, 24).reshape(4, 6)},
     "timeout_ms": 1000.0},
    {"rows": np.ones((3, 2), np.float32), "dim": 2},
])
def test_frames_are_the_jax_packages_bytes(payload):
    """The same payload encodes to the same bytes in both packages, and
    each package parses the other's frame."""
    for ftype in (protocol.REQUEST, protocol.RESPONSE, protocol.ERROR):
        assert protocol.encode_frame(ftype, 11, payload) == \
            jax_protocol.encode_frame(ftype, 11, payload)
    a, b = _pair()
    try:
        a.sendall(jax_protocol.encode_frame(protocol.RESPONSE, 5, payload))
        _, rid, got = protocol.recv_frame(b, deadline=time.monotonic() + 2)
        assert rid == 5 and got.keys() == payload.keys()
    finally:
        a.close(), b.close()
    assert (protocol.MAGIC, protocol.HEADER_SIZE,
            protocol.DEFAULT_MAX_PAYLOAD) == (
        jax_protocol.MAGIC, jax_protocol.HEADER_SIZE,
        jax_protocol.DEFAULT_MAX_PAYLOAD)


def test_torn_frame_is_typed():
    """Peer dies mid-frame: the receiver sees a FrameError naming the
    tear, never a hang or a bare EOFError."""
    a, b = _pair()
    frame = protocol.encode_frame(protocol.RESPONSE, 1, {"k": "v" * 100})
    a.sendall(frame[: len(frame) // 2])
    a.close()
    with pytest.raises(FrameError, match="torn frame"):
        protocol.recv_frame(b, deadline=time.monotonic() + 2.0)
    b.close()


def test_clean_eof_is_connection_closed():
    """EOF at a frame BOUNDARY is the distinct clean-hangup type."""
    a, b = _pair()
    a.close()
    with pytest.raises(ConnectionClosedError):
        protocol.recv_frame(b, deadline=time.monotonic() + 2.0)
    b.close()


def test_bad_magic_is_typed():
    a, b = _pair()
    a.sendall(b"HTTP" + b"\x00" * (protocol.HEADER_SIZE - 4) + b"junk")
    with pytest.raises(FrameError, match="magic"):
        protocol.recv_frame(b, deadline=time.monotonic() + 2.0)
    a.close(), b.close()


def test_oversized_payload_refused_on_send():
    """The sender refuses before a byte leaves (batch-sized payloads
    only)."""
    a, b = _pair()
    with pytest.raises(OversizedFrameError, match="batch-sized"):
        protocol.send_frame(a, protocol.REQUEST, 1,
                            {"rows": np.zeros(4096)}, max_payload=64)
    a.close(), b.close()


def test_oversized_header_refused_before_payload_read():
    """A peer DECLARING an oversized payload is refused at the header."""
    a, b = _pair()
    header = struct.pack(">4sBQQ", protocol.MAGIC, protocol.RESPONSE,
                         1, 1 << 40)
    a.sendall(header)
    with pytest.raises(OversizedFrameError, match="refusing"):
        protocol.recv_frame(b, deadline=time.monotonic() + 2.0,
                            max_payload=1024)
    a.close(), b.close()


def test_deadline_expires_mid_read():
    """Half a frame then silence: the deadline is enforced PER BYTE, so
    the stall surfaces as TransportTimeoutError (a TimeoutError)."""
    a, b = _pair()
    frame = protocol.encode_frame(protocol.RESPONSE, 1, {"k": "v" * 64})
    a.sendall(frame[:protocol.HEADER_SIZE + 4])
    t0 = time.monotonic()
    with pytest.raises(TransportTimeoutError, match="mid-read"):
        protocol.recv_frame(b, deadline=t0 + 0.5)
    assert time.monotonic() - t0 < 5.0
    assert isinstance(TransportTimeoutError("x"), TimeoutError)
    a.close(), b.close()


def test_frame_reader_reassembles_across_polls():
    """FrameReader buffers partial bytes across poll() wakeups."""
    a, b = _pair()
    frame = protocol.encode_frame(protocol.RESPONSE, 9, {"n": 42})
    reader = protocol.FrameReader(b)
    got = []

    def drip():
        for i in range(0, len(frame), 7):
            a.sendall(frame[i:i + 7])
            time.sleep(0.01)

    t = threading.Thread(target=drip)
    t.start()
    deadline = time.monotonic() + 5.0
    while not got and time.monotonic() < deadline:
        out = reader.poll(timeout_s=0.02)
        if out is not None:
            got.append(out)
    t.join(10.0)
    assert not t.is_alive()
    assert got and got[0][1] == 9 and got[0][2] == {"n": 42}
    a.close(), b.close()


# ---------------------------------------------------------------------------
# 2. Error frames: typed reconstruction across the boundary
# ---------------------------------------------------------------------------

def test_known_errors_cross_as_themselves():
    for exc in (ServingSchemaError("bad column"),
                ServingOverloadError("queue full"),
                OversizedFrameError("too big"),
                faults.FaultInjected("scripted")):
        back = decode_error(encode_error(exc))
        assert type(back) is type(exc)
        assert str(exc) in str(back)


def test_error_payloads_cross_packages():
    """An error payload is the JAX package's; one written by a JAX worker
    re-raises in the port as the port's own type of that name."""
    from flinkml_tpu.serving import errors as jax_serving_errors

    for jexc, port_type in (
            (jax_serving_errors.ServingSchemaError("bad"), ServingSchemaError),
            (jax_faults.FaultInjected("boom"), faults.FaultInjected),
            (jax_errors.WorkerDiedError("gone"), WorkerDiedError)):
        payload = jax_errors.encode_error(jexc)
        assert encode_error(port_type(str(jexc))) == payload
        back = decode_error(payload)
        assert type(back) is port_type and str(back) == str(jexc)
    assert sorted(jax_errors._raisable_types()) == sorted(
        __import__("flinkml_tpu_torch.cluster.errors",
                   fromlist=["x"])._raisable_types())


def test_unknown_error_becomes_remote_error():
    payload = {"etype": "SomeWorkerOnlyError", "message": "boom"}
    back = decode_error(payload)
    assert isinstance(back, RemoteError)
    assert back.etype == "SomeWorkerOnlyError"
    assert back.remote_message == "boom"


def test_exports_are_the_jax_packages():
    import flinkml_tpu_torch.cluster as port_cluster

    assert port_cluster.__all__ == jax_cluster.__all__
    for name in port_cluster.__all__:
        assert getattr(port_cluster, name) is not None


# ---------------------------------------------------------------------------
# 3. Worker server + client in-process (fake engine; no spawn)
# ---------------------------------------------------------------------------

class _FakeResponse:
    def __init__(self, columns):
        self.columns = columns
        self.version = 3
        self.shed = False


class _FakeActive:
    def __init__(self, model):
        self.model = model


class _FakeEmbeddingStage:
    def __init__(self, vocab=64, dim=4):
        self._rows = np.arange(vocab * dim, dtype=np.float32
                               ).reshape(vocab, dim)


class _FakeEngine:
    """Just enough engine surface for WorkerServer's op table."""

    def __init__(self):
        self._active = _FakeActive(_FakeEmbeddingStage())
        self.stopped = False

    def predict(self, columns, timeout_ms=None):
        feats = np.asarray(columns["features"])
        if feats.ndim != 2:
            raise ServingSchemaError("features must be rank 2")
        return _FakeResponse({"prediction": feats.sum(axis=1)})

    def stats(self):
        return {"name": "fake"}

    def stop(self, drain=True, timeout=None):
        self.stopped = True


@pytest.fixture()
def worker_pair():
    server = WorkerServer(_FakeEngine(), name="fake", max_payload=1 << 20)
    port = server.bind()
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    client = WorkerClient("127.0.0.1", port).connect()
    yield server, client
    client.close()
    server.shutdown()


def test_worker_ops_roundtrip(worker_pair):
    _, client = worker_pair
    assert client.call("ping")["ok"] is True
    out = client.call("predict", {
        "columns": {"features": np.ones((4, 3))}, "timeout_ms": 1000,
    })
    np.testing.assert_array_equal(out["columns"]["prediction"],
                                  np.full(4, 3.0))
    assert out["version"] == 3
    stats = client.call("stats")
    assert stats["stats"] == {"name": "fake"} and stats["nvcc_runs"] == 0
    assert set(stats["launches"]) >= {"fused_chain"}


def test_worker_typed_error_surfaces_as_itself(worker_pair):
    """A ServingSchemaError raised inside the worker re-raises
    client-side AS ServingSchemaError."""
    _, client = worker_pair
    with pytest.raises(ServingSchemaError, match="rank 2"):
        client.call("predict", {
            "columns": {"features": np.ones(3)}, "timeout_ms": 1000,
        })


def test_embedding_exchange_is_batch_sized_only(worker_pair):
    _, client = worker_pair
    out = client.call("embedding_rows", {"ids": np.array([0, 5, 2])})
    stage = _FakeEmbeddingStage()
    np.testing.assert_array_equal(out["rows"], stage._rows[[0, 5, 2]])
    # A vocab-sized request is refused with the framing cap's own typed
    # error — never a vocab-sized transfer.
    with pytest.raises(OversizedFrameError, match="batch-sized"):
        client.call("embedding_rows", {"ids": np.arange(64)})
    with pytest.raises(ValueError, match="out of range"):
        client.call("embedding_rows", {"ids": np.array([-1])})


def test_unknown_op_is_typed(worker_pair):
    _, client = worker_pair
    with pytest.raises(ValueError, match="unknown worker op"):
        client.call("nonsense")


def test_client_correlates_out_of_order_responses():
    """Two in-flight requests answered in REVERSE order each complete
    their own callback (request-id correlation, one connection)."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    port = listener.getsockname()[1]

    def serve():
        conn, _ = listener.accept()
        frames = [protocol.recv_frame(conn, deadline=time.monotonic() + 5)
                  for _ in range(2)]
        for ftype, rid, payload in reversed(frames):
            protocol.send_frame(conn, protocol.RESPONSE, rid,
                                {"echo": payload["tag"]})
        time.sleep(0.2)
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    client = WorkerClient("127.0.0.1", port).connect()
    results = {}
    done = threading.Event()

    def on_done(tag):
        def _cb(result, error):
            results[tag] = (result, error)
            if len(results) == 2:
                done.set()
        return _cb

    client.submit("a", {"tag": "first"}, on_done=on_done("first"))
    client.submit("b", {"tag": "second"}, on_done=on_done("second"))
    assert done.wait(5.0)
    assert results["first"][0]["echo"] == "first"
    assert results["second"][0]["echo"] == "second"
    client.close()
    listener.close()


def test_worker_death_mid_response_fails_inflight_typed():
    """The worker dies after HALF a response frame: the in-flight
    request fails with WorkerDiedError, not a hang or a parse crash."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    port = listener.getsockname()[1]

    def serve():
        conn, _ = listener.accept()
        protocol.recv_frame(conn, deadline=time.monotonic() + 5)
        frame = protocol.encode_frame(
            protocol.RESPONSE, 1, {"big": "x" * 4096}
        )
        conn.sendall(frame[: len(frame) // 2])  # tear it
        conn.close()

    threading.Thread(target=serve, daemon=True).start()
    client = WorkerClient("127.0.0.1", port).connect()
    box = {}
    done = threading.Event()

    def _cb(result, error):
        box["error"] = error
        done.set()

    client.submit("predict", {"x": 1}, on_done=_cb)
    assert done.wait(5.0)
    assert isinstance(box["error"], WorkerDiedError)
    client.close()
    listener.close()


def test_silent_worker_times_out_only_overdue_requests():
    """A worker that accepts and never answers: the reader sweep fails
    exactly the requests whose transport deadline passed."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    port = listener.getsockname()[1]
    conns = []
    threading.Thread(
        target=lambda: conns.append(listener.accept()[0]), daemon=True
    ).start()
    client = WorkerClient("127.0.0.1", port).connect()
    outcomes = {}
    events = {k: threading.Event() for k in ("soon", "later")}

    def _cb(key):
        def cb(result, error):
            outcomes[key] = error
            events[key].set()
        return cb

    now = time.monotonic()
    client.submit("a", {}, deadline=now + 0.3, on_done=_cb("soon"))
    client.submit("b", {}, deadline=now + 30.0, on_done=_cb("later"))
    assert events["soon"].wait(5.0)
    assert isinstance(outcomes["soon"], TransportTimeoutError)
    assert not events["later"].is_set()  # the healthy deadline survives
    assert client.inflight == 1
    client.close()
    listener.close()


# ---------------------------------------------------------------------------
# 4. init_distributed env family, held against the JAX package
# ---------------------------------------------------------------------------

_ENV_FAMILIES = ("FLINKML_TPU_COORD_ADDR", "FLINKML_TPU_WORLD_SIZE",
                 "FLINKML_TPU_RANK", "JAX_COORDINATOR_ADDRESS",
                 "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "MASTER_ADDR",
                 "MASTER_PORT", "WORLD_SIZE", "RANK")


def _patch_rendezvous(monkeypatch):
    """Both packages' rendezvous calls recorded as ``(address, world,
    rank)``, none performed."""
    port_calls, jax_calls = [], []
    for var in _ENV_FAMILIES:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(
        tdist._dist(), "init_process_group",
        lambda backend, init_method, world_size, rank, **kw:
        port_calls.append((init_method, world_size, rank)))
    monkeypatch.setattr(
        jax.distributed, "initialize",
        lambda **kw: jax_calls.append(
            ("tcp://" + kw["coordinator_address"], kw["num_processes"],
             kw["process_id"])))
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False)
    import flinkml_tpu.parallel.distributed as jdist

    monkeypatch.setattr(jdist, "_enable_cpu_collectives", lambda: None)
    return port_calls, jax_calls


def test_init_distributed_framework_env_wins(monkeypatch):
    """The FLINKML_TPU_COORD_ADDR family beats the launcher's generic
    vars (torch's MASTER_ADDR family in the port, JAX_* in the JAX
    package): spawned workers and operator-launched processes share ONE
    rendezvous path."""
    port_calls, jax_calls = _patch_rendezvous(monkeypatch)
    monkeypatch.setenv("FLINKML_TPU_COORD_ADDR", "10.0.0.9:9999")
    monkeypatch.setenv("FLINKML_TPU_WORLD_SIZE", "4")
    monkeypatch.setenv("FLINKML_TPU_RANK", "2")
    for prefix in (("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                    "JAX_PROCESS_ID"), ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
        monkeypatch.setenv(prefix[0], "10.1.1.1:1111" if "JAX" in prefix[0]
                           else "10.1.1.1")
        monkeypatch.setenv(prefix[1], "8")
        monkeypatch.setenv(prefix[2], "7")
    tdist.init_distributed()
    jax_init_distributed()
    assert port_calls == jax_calls == [("tcp://10.0.0.9:9999", 4, 2)]


def test_init_distributed_launcher_env_fallback(monkeypatch):
    """Without the framework family each package reads its launcher's
    vars, to the same rendezvous."""
    port_calls, jax_calls = _patch_rendezvous(monkeypatch)
    monkeypatch.setenv("MASTER_ADDR", "10.1.1.1")
    monkeypatch.setenv("MASTER_PORT", "1111")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.1.1.1:1111")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "3")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    tdist.init_distributed()
    jax_init_distributed()
    assert port_calls == jax_calls == [("tcp://10.1.1.1:1111", 3, 1)]


def test_init_distributed_explicit_args_beat_env(monkeypatch):
    port_calls, jax_calls = _patch_rendezvous(monkeypatch)
    monkeypatch.setenv("FLINKML_TPU_COORD_ADDR", "10.0.0.9:9999")
    monkeypatch.setenv("FLINKML_TPU_WORLD_SIZE", "4")
    monkeypatch.setenv("FLINKML_TPU_RANK", "2")
    tdist.init_distributed("10.2.2.2:2222", 2, 0)
    jax_init_distributed("10.2.2.2:2222", 2, 0)
    assert port_calls == jax_calls == [("tcp://10.2.2.2:2222", 2, 0)]


def test_rendezvous_env_exports_the_family():
    env = rendezvous_env(rank=3, world=4, port=8476, base={})
    assert env == jax_cluster.rendezvous_env(rank=3, world=4, port=8476,
                                             base={}) == {
        "FLINKML_TPU_COORD_ADDR": "127.0.0.1:8476",
        "FLINKML_TPU_WORLD_SIZE": "4",
        "FLINKML_TPU_RANK": "3",
    }


# ---------------------------------------------------------------------------
# 5. WorkerCrash fault (the cluster.worker seam)
# ---------------------------------------------------------------------------

def test_worker_crash_plan_json_roundtrip(tmp_path):
    marker = str(tmp_path / "crash.marker")
    plan = faults.FaultPlan(faults.WorkerCrash(
        at=5, key="epoch", exit_code=29, marker=marker,
    ))
    text = faults.plan_to_json(plan)
    assert text == jax_faults.plan_to_json(jax_faults.FaultPlan(
        jax_faults.WorkerCrash(at=5, key="epoch", exit_code=29,
                               marker=marker)))
    (f,) = faults.plan_from_json(text).faults
    assert isinstance(f, faults.WorkerCrash)
    assert (f.at, f.key, f.exit_code, f.marker) == (5, "epoch", 29, marker)


def test_worker_crash_marker_gives_crash_once_across_restarts(tmp_path):
    """The marker file is the cross-RESTART once-flag (``should_fire``
    only — ``apply`` is a real os._exit)."""
    marker = str(tmp_path / "crash.marker")
    f = faults.WorkerCrash(at=3, key="epoch", marker=marker)
    assert not f.should_fire({"epoch": 2})
    assert f.should_fire({"epoch": 3})
    open(marker, "w").close()  # "the previous incarnation fired"
    assert not f.should_fire({"epoch": 3})


def test_fuzz_plan_requires_marker_dir_for_worker_seam(tmp_path):
    with pytest.raises(ValueError, match="marker_dir"):
        faults.FuzzPlan(seed=1, seams=("cluster.worker",))
    plan = faults.FuzzPlan(seed=1, seams=("cluster.worker",),
                           marker_dir=str(tmp_path))
    sampled = plan.sample(0)
    assert any(isinstance(f, faults.WorkerCrash) for f in sampled.faults)


# ---------------------------------------------------------------------------
# 6. Devices: the parent's request, the worker's cards
# ---------------------------------------------------------------------------

def test_worker_spec_carries_the_requested_device():
    """The spec's device is the constructing thread's request (the
    autouse fixture asks for the CPU); a thread that asked for nothing
    gets the process default (``cuda`` unless changed)."""
    from flinkml_tpu_torch.device import requested_device

    assert WorkerSpec(example={}, source={}).device == "cpu"
    result = []
    t = threading.Thread(target=lambda: result.append(
        (WorkerSpec(example={}, source={}).device, requested_device().type)))
    t.start()
    t.join(10.0)
    assert result[0][0] == result[0][1]


def test_visible_cards_round_robin():
    env = {"CUDA_VISIBLE_DEVICES": "0"}
    assert [visible_cards(i, 1, env) for i in range(3)] == ["0", "0", "0"]
    env = {"CUDA_VISIBLE_DEVICES": "3,5,6,7"}
    assert [visible_cards(i, 1, env) for i in range(5)] == \
        ["3", "5", "6", "7", "3"]
    assert [visible_cards(i, 2, env) for i in range(3)] == \
        ["3,5", "6,7", "3,5"]
    assert visible_cards(0, 1, {"CUDA_VISIBLE_DEVICES": ""}) is None


def test_cuda_worker_without_a_card_fails_its_spawn(tmp_path):
    """A worker asked for ``cuda`` on a host without a usable card fails
    its spawn with WorkerSpawnError and the child's stderr tail: it never
    carries on on the CPU."""
    spec = WorkerSpec.for_model(None, {"features": np.zeros((2, 3))},
                                name="nocard", device="cuda")
    proc = WorkerProcess(spec, env={"CUDA_VISIBLE_DEVICES": ""},
                         spawn_timeout_s=CHILD_TIMEOUT_S,
                         workdir=str(tmp_path))
    with pytest.raises(WorkerSpawnError, match="is_available"):
        proc.spawn()
    assert proc.join(10.0) not in (None, 0)


# ---------------------------------------------------------------------------
# 7. The full multi-process scenarios (clean children)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster_child(tmp_path_factory):
    """The five-stage chain fitted in the JAX package and saved; the child
    loads it in the port and runs parity / kill-mid-traffic / respawn /
    lease reclaim in a fresh interpreter on the CPU. Returns ``(report,
    served outputs, JAX model, x)``."""
    from tests._torch_port_common import five_stage_pair

    workdir = tmp_path_factory.mktemp("cluster_child")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 6)) * 2.0 + 1.0
    jax_model, _ = five_stage_pair(x, rng.normal(size=6))
    jax_model.save(str(workdir / "model"))
    np.save(workdir / "x.npy", x)
    proc = subprocess.run(
        [sys.executable, os.path.join(_HERE, "_torch_cluster_child.py"),
         str(workdir)],
        capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
        env=_child_env(),
    )
    assert proc.returncode == 0, (
        f"cluster child failed:\n{proc.stdout}\n{proc.stderr[-4000:]}"
    )
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    served = dict(np.load(workdir / "served.npz"))
    return report, served, jax_model, x


def test_cluster_pool_bitwise_parity(cluster_child):
    rep, served, _, _ = cluster_child
    assert rep["parity_bitwise"] is True, rep
    for c in ("s4", "prediction", "rawPrediction"):
        np.testing.assert_array_equal(served[f"pool_{c}"], served[f"ref_{c}"])
    assert rep["predecessor_devices"] == ["cpu", "cpu"], rep


def test_cluster_pool_matches_jax_per_stage(cluster_child):
    """The workers' responses against the JAX package's per-stage
    transform of the same chain: float64 within 1e-10, predictions equal
    where the margin is decisive."""
    from tests._torch_port_common import (
        F64_RAW_RTOL,
        assert_lr_outputs_close,
        jax_per_stage,
    )

    _, served, jax_model, x = cluster_child
    want = jax_per_stage(jax_model, x)
    got = {c: served[f"pool_{c}"] for c in ("s4", "prediction",
                                             "rawPrediction")}
    np.testing.assert_allclose(got["s4"], want["s4"], rtol=F64_RAW_RTOL,
                               atol=F64_RAW_RTOL)
    coef = np.asarray(jax_model.stages[-1].get_model_data()[0]
                      .column("coefficient"))[0]
    assert_lr_outputs_close(got, want, want["s4"] @ coef, f64=True)


def test_worker_killed_mid_traffic_loses_zero_requests(cluster_child):
    """A WorkerCrash (real os._exit, armed over the transport) mid-
    closed-loop-traffic loses ZERO requests — the typed WorkerDiedError
    rides the router's retire-and-failover path."""
    rep = cluster_child[0]
    assert rep["crashed_rc"] == 23, rep
    assert rep["requests_ok"] > 0, rep
    assert rep["requests_lost"] == 0, rep
    assert rep["requests_mismatched"] == 0, rep
    assert rep["health_after_crash"]["r1"] == "HEALTHY", rep


def test_respawn_rejoins_warm_zero_new_compiles(cluster_child):
    """The port's "zero new compiles": the respawned worker runs no
    ``nvcc``, builds as many fused programs at warmup as its predecessor
    (eager PyTorch programs, kept in memory only), and that count stays
    flat under traffic; parity still bitwise."""
    rep = cluster_child[0]
    assert rep["respawned"] == ["r2"], rep
    assert rep["respawn_nvcc_runs"] == 0, rep
    assert rep["respawn_programs"] == rep["predecessor_programs"][0] > 0, rep
    assert rep["respawn_programs_after_traffic"] == rep["respawn_programs"]
    assert rep["post_respawn_parity"] is True, rep


def test_cross_process_lease_reclaim(cluster_child):
    """A slice lease held INSIDE a worker revokes and releases over the
    transport."""
    rep = cluster_child[0]
    assert rep["lease_acquired"]["devices"] == [0], rep
    assert rep["lease_reclaimed"] == [
        {"released": True, "holder": "child-trainer"}], rep
    assert rep["leases_after"] == 0, rep


def test_cluster_metrics_published(cluster_child):
    rep = cluster_child[0]
    assert rep["workers_alive_gauge"] == 2.0, rep
    assert rep["transport_p99_ms"] is not None, rep
    assert rep["spawn_ms_samples"] == 3, rep  # 2 initial + 1 respawn


def test_elastic_world_shrinks_and_resumes_bit_exact(tmp_path):
    """World size = PROCESS count: a 2-process world loses its highest
    rank to a WorkerCrash, the supervisor relaunches the survivor as
    world 1, and the survivor reassembles the rank-scoped snapshot family
    through its layout tags — finishing bit for bit as a continuous
    golden run, resumed from the crash-time epoch (never a silent fresh
    start). Each rank's state lives on the launcher's device (the CPU
    here)."""
    wd = str(tmp_path)
    script = os.path.join(_HERE, "_torch_elastic_rank.py")
    world = ElasticProcessWorld(
        lambda rank, w, rnd: [sys.executable, script, wd],
        env=_child_env(), workdir=wd, round_timeout_s=CHILD_TIMEOUT_S,
    )
    assert world.device == "cpu"
    final_world = world.run(2, min_world=1)
    assert final_world == 1
    assert world.rounds[0]["lost"] == 1
    assert 23 in world.rounds[0]["exit_codes"]

    subprocess.run([sys.executable, script, wd, "golden"], check=True,
                   timeout=CHILD_TIMEOUT_S,
                   env=_child_env(FLINKML_TPU_DEVICE="cpu"))
    res = json.load(open(os.path.join(wd, "result.json")))
    gold = json.load(open(os.path.join(wd, "result-golden.json")))
    assert res["resumed_from"] > 0, res  # not a silent fresh start
    assert res["device"] == gold["device"] == "cpu"
    assert res["w"] == gold["w"]
    assert res["rows"] == gold["rows"]
