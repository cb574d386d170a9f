"""Clean-process feature-hash determinism probe of the port behind
``tests/test_torch_hashed_features.py`` (the port's copy of
``tests/_hash_child.py``: it imports numpy and the port's hashing only).

Why a child process: the hardening claim is that hashed row ids are
independent of ``PYTHONHASHSEED``, interpreter instance, and anything
else a process randomizes at startup — ``hash()``-based code would pass
any in-process test and still scatter a model's rows across restarts.
The parent runs this script twice under DIFFERENT ``PYTHONHASHSEED``
values and asserts the JSON reports (and the committed golden vectors)
are bit-identical.
"""

import json
import os
import sys


KEYS = ["", "a", "hello", "user:12345", "日本語", "the quick brown fox",
        0, 1, -1, 7, 123456789, 2**31, -(2**31), 2**63 - 1, -(2**63)]


def main() -> None:
    import numpy as np

    from flinkml_tpu_torch.features.hashing import (
        _hash_ints_vectorized,
        _key_bytes,
        hash_buckets,
        murmur3_32,
    )

    report = {
        "python_hash_seed": os.environ.get("PYTHONHASHSEED"),
        "hashes": {},
        "buckets": {},
    }
    for seed in (0, 1, 42, 0x9747B28C):
        report["hashes"][str(seed)] = {
            repr(k): int(murmur3_32(_key_bytes(k), seed)) for k in KEYS
        }
    for b in (16, 1024, 1 << 20):
        report["buckets"][str(b)] = {
            repr(k): int(hash_buckets([k], seed=42, num_buckets=b)[0])
            for k in KEYS
        }
    int_keys = np.array([k for k in KEYS if isinstance(k, int)], np.int64)
    vec = _hash_ints_vectorized(int_keys, 42)
    scalar = [murmur3_32(_key_bytes(int(k)), 42) for k in int_keys]
    report["vectorized_matches_scalar"] = (
        [int(v) for v in vec] == [int(s) for s in scalar]
    )
    report["imported_jax"] = "jax" in sys.modules
    json.dump(report, sys.stdout)
    print()


if __name__ == "__main__":
    main()
