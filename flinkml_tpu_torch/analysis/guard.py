"""Transfer/retrace guard for hot loops (FML401–FML403).

The port's counterpart of ``flinkml_tpu.analysis.guard``. The fused
executor's performance contract: after warmup, a hot ``transform`` loop
builds **no** program (the row-bucketed cache serves every row count in a
bucket), runs no ``nvcc``, and moves no surprise bytes between host and
device. A fingerprint regression or a stage falling back to the host path
would otherwise only show as a latency cliff.

:class:`TransferRetraceGuard` instruments the region it wraps:

  - **compiles** (FML402): every program the fused cache builds inside the
    region (``pipeline_fusion.on_compile``) is checked against the bucket
    policy, and every ``nvcc`` run (a kernel library built, ``kernels.
    _build.nvcc_runs``) counts as a compile of a new chain. A compile whose chain (cache key
    minus the bucket component) was already compiled — before or inside
    the region — is a legitimate *new-bucket* compile and is allowed by
    default (``allow_new_buckets``). Any other compile counts against
    ``allow_compiles`` (default 0: warm up before entering the guard).
  - **cache aliasing** (FML403): two in-region compiles with identical
    input specs and bucket but different chain fingerprints indicate an
    unstable fingerprint churning the cache.
  - **transfers** (FML401): deltas of the ``pipeline.fusion``
    host→device counters and the ``table`` device→host materialization
    counters, checked against declared budgets (``None`` = unchecked).

Use as a context manager (raises :class:`GuardViolation` listing the
findings) or with ``raise_on_violation=False`` and read ``.findings``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from flinkml_tpu_torch.analysis.findings import Finding


class GuardViolation(AssertionError):
    """Raised when a guarded region breaks its transfer/retrace budget."""

    def __init__(self, findings: List[Finding]):
        self.findings = list(findings)
        super().__init__(
            "transfer/retrace guard violated:\n"
            + "\n".join(f.render() for f in self.findings)
        )


def _chain_identity(key: Tuple) -> Tuple:
    """A fused-cache key minus its row bucket (index 3 of the layout
    ``(fingerprints, ext specs, const specs, bucket, device, [policy],
    out names)``, ``pipeline_fusion._program``): the identity under which
    a program at a NEW bucket is policy-allowed. The device and the
    precision policy STAY in the identity — either builds a genuinely
    different program."""
    return key[:3] + key[4:]


def _counters(group: str) -> Dict[str, float]:
    from flinkml_tpu_torch.utils.metrics import metrics

    return dict(metrics.group(group).snapshot()["counters"])


class TransferRetraceGuard:
    """Budget-checked instrumentation of a fused-execution region."""

    def __init__(
        self,
        allow_compiles: int = 0,
        allow_new_buckets: bool = True,
        allow_host_to_device: Optional[int] = None,
        allow_device_to_host: Optional[int] = None,
        raise_on_violation: bool = True,
        location: Optional[str] = None,
    ):
        self.allow_compiles = int(allow_compiles)
        self.allow_new_buckets = bool(allow_new_buckets)
        self.allow_host_to_device = allow_host_to_device
        self.allow_device_to_host = allow_device_to_host
        self.raise_on_violation = bool(raise_on_violation)
        self.location = location
        self.findings: List[Finding] = []
        self.nvcc_runs = 0
        self._compiled_keys: List[Tuple] = []

    # -- region lifecycle --------------------------------------------------
    def __enter__(self) -> "TransferRetraceGuard":
        from flinkml_tpu_torch import pipeline_fusion
        from flinkml_tpu_torch.kernels import _build

        self._fusion_before = _counters("pipeline.fusion")
        self._table_before = _counters("table")
        self._nvcc_before = _build.nvcc_runs()
        # Chains already built before the region: programs for these at
        # NEW buckets are policy-allowed, not retraces.
        with pipeline_fusion._LOCK:
            self._known_chains = {
                _chain_identity(k) for k in pipeline_fusion._CACHE
            }
        self._compiled_keys = []
        pipeline_fusion.on_compile.append(self._compiled_keys.append)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        from flinkml_tpu_torch import pipeline_fusion
        from flinkml_tpu_torch.kernels import _build

        try:
            pipeline_fusion.on_compile.remove(self._compiled_keys.append)
        except ValueError:
            # A test hook reset on_compile inside the region; fine.
            pass
        self.nvcc_runs = _build.nvcc_runs() - self._nvcc_before
        self.findings = self._evaluate()
        if exc_type is None and self.findings and self.raise_on_violation:
            raise GuardViolation(self.findings)
        return False

    # -- evaluation --------------------------------------------------------
    def _evaluate(self) -> List[Finding]:
        findings: List[Finding] = []

        # Compile policy. Fingerprint-churn detection: keyed by everything
        # EXCEPT the fingerprints. Two legitimately different chains almost
        # always differ in const specs or output names too; an unstable
        # fingerprint differs ONLY in the fingerprint, every call —
        # requiring 3+ distinct fingerprints keeps a deliberate pair of
        # alternative chains (budgeted via allow_compiles) unflagged.
        counted = self.nvcc_runs
        seen_chains = set(self._known_chains)
        by_shape: Dict[Tuple, set] = {}
        for key in self._compiled_keys:
            by_shape.setdefault(key[1:], set()).add(key[0])
        for rest, fps in by_shape.items():
            if len(fps) >= 3:
                findings.append(Finding(
                    "FML403",
                    f"{len(fps)} compiles share input/constant specs, "
                    f"outputs, and bucket {rest[2]} but differ only in "
                    "chain fingerprint — an unstable fingerprint is "
                    "churning the program cache",
                    location=self.location,
                    fix_hint="make transform_kernel fingerprints a pure "
                             "function of stage config",
                ))
        for key in self._compiled_keys:
            chain = _chain_identity(key)
            # The identity is bucket-independent (but policy- and
            # device-INCLUSIVE), so a chain seen at ANY bucket (pre-region
            # cache or earlier in-region build) makes this a new-bucket
            # build of a known chain.
            if chain in seen_chains:
                if not self.allow_new_buckets:
                    counted += 1
            else:
                counted += 1
                seen_chains.add(chain)
        if counted > self.allow_compiles:
            findings.append(Finding(
                "FML402",
                f"{counted} compile(s) of new chains or kernel libraries "
                f"in a guarded region (budget {self.allow_compiles}) — a "
                "hot loop rebuilt beyond the declared bucket policy",
                location=self.location,
                fix_hint="warm the chain up before the guarded region, or "
                         "raise allow_compiles if new chains are expected",
            ))

        fusion_after = _counters("pipeline.fusion")
        table_after = _counters("table")

        def delta(before, after, key):
            return after.get(key, 0.0) - before.get(key, 0.0)

        if self.allow_host_to_device is not None:
            h2d = delta(self._fusion_before, fusion_after,
                        "host_to_device_transfers")
            if h2d > self.allow_host_to_device:
                findings.append(Finding(
                    "FML401",
                    f"{int(h2d)} host->device transfer(s) in a guarded "
                    f"region (budget {self.allow_host_to_device})",
                    location=self.location,
                    fix_hint="keep hot-loop inputs device-resident "
                             "(reuse the same Table; fused outputs stay "
                             "on device)",
                ))
        if self.allow_device_to_host is not None:
            d2h = delta(self._table_before, table_after,
                        "device_to_host_materializations")
            if d2h > self.allow_device_to_host:
                findings.append(Finding(
                    "FML401",
                    f"{int(d2h)} device->host materialization(s) in a "
                    f"guarded region (budget {self.allow_device_to_host})",
                    location=self.location,
                    fix_hint="an intermediate is being read back to host "
                             "inside the loop — read results once outside, "
                             "or budget the reads explicitly",
                ))
        return findings


def transfer_retrace_guard(**kwargs) -> TransferRetraceGuard:
    """Convenience alias: ``with transfer_retrace_guard(...):``."""
    return TransferRetraceGuard(**kwargs)
