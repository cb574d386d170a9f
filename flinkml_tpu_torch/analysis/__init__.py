"""Checks that run before any step: the port's part of the JAX package's
``flinkml_tpu.analysis``.

- :mod:`.collectives`: :class:`~.collectives.CollectiveOp` and the
  cross-rank collective-order comparator (FML301);
- :mod:`.sharding_check`: sharding-plan validation (FML501–FML504).
- :mod:`.memory`: :func:`~.memory.estimate_serving_bytes`, the serving
  engine's load-time memory gate.

The precision rules (FML6xx) live in :mod:`flinkml_tpu_torch.precision`.
The JAX package's program walkers (jaxpr passes, the AST lint, the
retrace guard and the CLI) come with ROADMAP.md Queue 1 item 13.
"""
