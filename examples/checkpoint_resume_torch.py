"""Fault-tolerant training on the PyTorch port: chunked device-loop
checkpointing and exact resume. The trainer snapshots its carry
(coefficient, epoch, loss) between chunks of epochs; a crash loses at
most one chunk, and the resumed run gives the same coefficients as an
uninterrupted one. Runs on an NVIDIA GPU, or on the CPU with
--device cpu:

    python examples/checkpoint_resume_torch.py [--device cpu] [--small]
"""

import argparse
import os
import sys

try:
    import flinkml_tpu_torch  # noqa: F401
except ImportError:  # run from a checkout: put the repo root on sys.path
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )

import flinkml_tpu_torch as fml

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device the port computes on (default: cuda)")
parser.add_argument("--small", action="store_true",
                    help="a smaller problem, for a quick run on the CPU")
args = parser.parse_args()
fml.set_default_device(args.device)

import tempfile

import numpy as np

from flinkml_tpu_torch.iteration import CheckpointManager
from flinkml_tpu_torch.models.logistic_regression import (
    train_logistic_regression,
)
from flinkml_tpu_torch.parallel import DeviceMesh

rng = np.random.default_rng(0)
n, d = (1024 if args.small else 4096), 32
x = rng.normal(size=(n, d)).astype(np.float32)
y = (x @ rng.normal(size=d) > 0).astype(np.float32)
w = np.ones(n, dtype=np.float32)
mesh = DeviceMesh()

hyper = dict(
    mesh=mesh, max_iter=60, learning_rate=0.5, global_batch_size=n,
    reg=0.0, tol=0.0, seed=42,
)

# --- Golden run: no failures ---------------------------------------------
golden = train_logistic_regression(x, y, w, **hyper)

with tempfile.TemporaryDirectory() as td:
    mgr = CheckpointManager(td)
    # --- "Crash" after 24 epochs (checkpoint every 12) --------------------
    train_logistic_regression(
        x, y, w, **{**hyper, "max_iter": 24},
        checkpoint_manager=mgr, checkpoint_interval=12,
    )
    print("checkpoints on disk:", mgr.all_epochs())  # [12, 24]

    # --- Resume: restores the epoch-24 carry, finishes to 60 --------------
    resumed = train_logistic_regression(
        x, y, w, **hyper,
        checkpoint_manager=mgr, checkpoint_interval=12, resume=True,
    )

np.testing.assert_allclose(resumed, golden, rtol=1e-12)
print("resumed coefficients are exactly the uninterrupted result")
print("checkpoint_resume OK")
