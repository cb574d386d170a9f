"""Rank-tagged operational logging.

The port's counterpart of ``flinkml_tpu.utils.logging``: one logger
namespace (``flinkml_tpu_torch.*``) whose records carry a ``[rank i/n]``
tag, so logs gathered from every rank of a run stay attributable.

A ``NullHandler`` sits on the package root logger, so an embedding
application stays silent unless it configures handlers;
:func:`enable_console` is the one-liner for operators.

The tag comes from :func:`set_rank` once it is called
(:func:`~flinkml_tpu_torch.parallel.init_distributed` pins it after the
rendezvous), else from the default ``torch.distributed`` group when one
exists, else from the launcher environment (``FLINKML_TPU_RANK`` /
``FLINKML_TPU_WORLD_SIZE``, then torch's ``RANK`` / ``WORLD_SIZE``), in
place of the JAX package's ``JAX_PROCESS_ID`` / ``JAX_NUM_PROCESSES``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

ROOT_NAME = "flinkml_tpu_torch"

logging.getLogger(ROOT_NAME).addHandler(logging.NullHandler())

# (rank, world size) once known; None = ask the group, then the env.
_RANK: Optional[Tuple[int, int]] = None


def set_rank(rank: int, world_size: int) -> None:
    """Pin the rank tag (called by ``init_distributed`` after the
    rendezvous; safe to call again on re-init)."""
    global _RANK
    _RANK = (int(rank), int(world_size))


def _env_int(*names: str, default: int) -> int:
    for name in names:
        value = os.environ.get(name)
        if value:
            return int(value)
    return default


def rank_tag() -> str:
    """``[rank i/n]``: from :func:`set_rank` when pinned, else from the
    default process group, else from the launcher environment
    (single-process default ``[rank 0/1]``)."""
    if _RANK is not None:
        i, n = _RANK
    else:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            i, n = dist.get_rank(), dist.get_world_size()
        else:
            i = _env_int("FLINKML_TPU_RANK", "RANK", default=0)
            n = _env_int("FLINKML_TPU_WORLD_SIZE", "WORLD_SIZE", default=1)
    return f"[rank {i}/{n}]"


class _RankAdapter(logging.LoggerAdapter):
    def process(self, msg, kwargs):
        return f"{rank_tag()} {msg}", kwargs


def get_logger(name: str = ROOT_NAME) -> logging.LoggerAdapter:
    """A rank-tagged logger under the ``flinkml_tpu_torch`` namespace.

    ``name`` may be a dotted suffix (``"distributed"``) or a full module
    path; either way the logger lands under the package root, so one
    handler and level setting controls the whole library.
    """
    if not name.startswith(ROOT_NAME):
        name = f"{ROOT_NAME}.{name}"
    return _RankAdapter(logging.getLogger(name), {})


def enable_console(level: int = logging.INFO) -> logging.Handler:
    """Attach a stderr handler to the package root (idempotent: reuses an
    existing console handler) and set its level. Returns the handler."""
    root = logging.getLogger(ROOT_NAME)
    for h in root.handlers:
        if isinstance(h, logging.StreamHandler) and not isinstance(
            h, logging.NullHandler
        ):
            handler = h
            break
    else:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        root.addHandler(handler)
    root.setLevel(level)
    handler.setLevel(level)
    return handler
