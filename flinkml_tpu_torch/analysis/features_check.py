"""FML505 — hash front end vs embedding table sizing (pre-compile).

The port's copy of ``flinkml_tpu.analysis.features_check`` (it reads
JSON only).

A hashed feature front end and the embedding table it feeds share one
integer: ``num_buckets`` IS the table's vocab row count. When they
drift — a retuned hash space without a resized table, or vice versa —
the failure is silent and data-dependent: ids beyond ``vocab`` corrupt
the lookup (or crash only on the first unlucky key), and ids *under* it
quietly strand rows that can never be addressed. So the mismatch is
priced as a plan-band ERROR and refused before anything compiles, the
same shape as the FML501–504 layout gates.

Config shape (``*.features.json``, the fixture/CI gate format)::

    {"hash":  {"seed": 42, "numBuckets": 4096},
     "table": {"vocab": 4096, "dim": 16}}

``tables`` (a list) is accepted for multi-table fronts; every table must
match the hash space. The live half of the gate is
:func:`flinkml_tpu_torch.features.hashing.check_hash_vocab`, which model
constructors call with the same FML505 message.
"""

from __future__ import annotations

import json
from typing import List

from flinkml_tpu_torch.analysis.findings import Finding

_HINT = ("size the embedding table's vocab to exactly the hash space "
         "(vocab = num_buckets); see docs/operators/features.md")


def check_features_file(path: str) -> List[Finding]:
    """Validate one ``*.features.json`` config. Unreadable or malformed
    files report one FML505 finding naming the path — the gate must
    fail loudly, not skip silently."""
    try:
        with open(path, "r") as fh:
            doc = json.load(fh)
        hash_cfg = doc["hash"]
        num_buckets = int(hash_cfg["numBuckets"])
        raw_tables = doc.get("tables")
        if raw_tables is None:
            raw_tables = [doc["table"]] if "table" in doc else []
        tables = [(str(t.get("name", f"table[{i}]")), int(t["vocab"]))
                  for i, t in enumerate(raw_tables)]
    except (OSError, ValueError, KeyError, TypeError) as e:
        return [Finding(
            "FML505",
            f"features file {path} is unreadable or malformed: {e!r}",
            location=path,
            fix_hint="see flinkml_tpu_torch/analysis/features_check.py for the "
                     "*.features.json schema",
        )]
    findings: List[Finding] = []
    if num_buckets < 1:
        findings.append(Finding(
            "FML505",
            f"hash front end declares num_buckets={num_buckets} (< 1)",
            location=path, fix_hint=_HINT,
        ))
    if not tables:
        findings.append(Finding(
            "FML505",
            "features file names a hash front end but no embedding "
            "table to check it against",
            location=path, fix_hint=_HINT,
        ))
    for name, vocab in tables:
        if vocab != num_buckets:
            findings.append(Finding(
                "FML505",
                f"hash num_buckets={num_buckets} != embedding table "
                f"{name!r} vocab={vocab}: hashed ids would "
                f"{'overrun' if num_buckets > vocab else 'strand'} "
                f"{abs(num_buckets - vocab)} rows",
                location=path, stage=name, fix_hint=_HINT,
            ))
    return findings
