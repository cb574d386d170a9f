"""Shared pieces of the port's serving tests: the CPU device scope and a
per-test time limit (the repo has no timeout plugin), both autouse
fixtures a test module imports by name."""

import signal
import threading

import pytest

from flinkml_tpu_torch.device import use_device

#: Seconds a serving test may run before it fails with ``TimeoutError``
#: (its ``finally`` blocks still stop its engines).
TEST_LIMIT_S = 120


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


@pytest.fixture(autouse=True)
def _time_limit(request):
    """Fail the test (in its own thread, so ``finally`` runs) once it has
    run :data:`TEST_LIMIT_S` seconds."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expired(signum, frame):
        raise TimeoutError(
            f"{request.node.nodeid} ran longer than {TEST_LIMIT_S}s"
        )

    previous = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def on_cpu(fn):
    """``fn`` run under ``use_device("cpu")``: the device scope is per
    thread, so a test's client thread that calls the port's own
    ``transform`` (a reference) must enter it, as the engine's threads
    enter theirs."""
    def run(*args, **kwargs):
        with use_device("cpu"):
            return fn(*args, **kwargs)
    return run


def program_counts():
    """``(fused programs in the cache, kernel libraries built)``: both
    stay flat from the end of an engine's ``start()`` to its ``stop()``
    (the port's counterpart of the JAX package's no-retrace guard)."""
    from flinkml_tpu_torch import pipeline_fusion
    from flinkml_tpu_torch.kernels import _build

    return pipeline_fusion.compiled_program_count(), len(_build._LIBS)


class FakeEngine:
    """The signals a guard or autoscaler reads from a replica's engine."""

    def __init__(self, max_queue_rows=256):
        self.queued_rows = 0
        self.observed_p99_ms = None
        self.config = type("Config", (), {"max_queue_rows": max_queue_rows})


class FakeReplica:
    def __init__(self, name, health, device=None):
        self.name, self.health, self.device = name, health, device
        self.engine = FakeEngine()
        self.mesh = None
        self.model_id = None


class FakePool:
    """A replica pool without engines, for one package's serving classes
    (``pkg`` is ``flinkml_tpu`` or ``flinkml_tpu_torch``): what
    ``GrayFailGuard.step`` and ``PoolAutoscaler.step`` read and call, so
    both packages' decisions can be driven by the same scripted signals."""

    def __init__(self, pkg, n, devices, name="fake"):
        self._health = __import__(f"{pkg}.serving.health", fromlist=["x"])
        self.name = name
        self._example = None  # no canary dispatches
        self._device_universe = list(devices)
        self._next_index = 0
        self.replicas = []
        self.brownout_shed_classes = frozenset()
        self.events = []
        for _ in range(n):
            self.add_replica()

    def add_replica(self, device=None, **_):
        if device is None:
            device = self._device_universe[
                self._next_index % len(self._device_universe)]
        name = f"r{self._next_index}"
        self._next_index += 1
        self.replicas.append(FakeReplica(
            name, self._health.ReplicaHealth(name), device))
        self.events.append(("add", name))

    def remove_replica(self, replica_name=None, **_):
        healthy = [r for r in self.replicas
                   if r.health.state is self._health.ReplicaState.HEALTHY]
        if len(healthy) <= 1:
            raise ValueError("refusing to remove the last healthy replica")
        victim = min(healthy, key=lambda r: r.health.outstanding_rows)
        self.replicas.remove(victim)
        self.events.append(("remove", victim.name))
        return victim.name

    def prune_retired(self):
        gone = [r.name for r in self.replicas
                if r.health.state is self._health.ReplicaState.UNHEALTHY]
        self.replicas = [r for r in self.replicas if r.name not in gone]
        self.events.extend(("prune", g) for g in gone)
        return gone

    def set_brownout(self, shed):
        self.brownout_shed_classes = frozenset(shed)
        self.events.append(("brownout", tuple(sorted(shed))))

    def _retire(self, replica, error):
        self.events.append(("retire", replica.name))

    def _seed_ewma(self, replica):
        self.events.append(("seed", replica.name))

    def _update_health_gauge(self):
        pass

    def states(self):
        return [(r.name, r.health.state.value) for r in self.replicas]
