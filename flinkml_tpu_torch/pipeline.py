"""Pipeline and PipelineModel — linear chains of stages.

The port's counterpart of ``flinkml_tpu.pipeline``:
  - ``Pipeline.fit`` trains each Estimator on the running inputs and
    transforms inputs forward only while an Estimator remains downstream;
  - ``PipelineModel.transform`` chains every stage's output into the next,
    fusing runs of kernel-capable stages into one ``fused_chain`` launch
    (:mod:`flinkml_tpu_torch.pipeline_fusion`);
  - both save as metadata + numbered per-stage subdirectories, in the same
    format as the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from flinkml_tpu_torch.api import AlgoOperator, Estimator, Model, Stage
from flinkml_tpu_torch.io import read_write
from flinkml_tpu_torch.table import Table


class Pipeline(Estimator):
    """Linear chain of stages, trained front to back: an Estimator is fit
    on the current inputs, an AlgoOperator is used as-is, and the inputs
    advance through a stage only if another Estimator remains after it."""

    def __init__(self, stages: Sequence[Stage] = ()):  # noqa: D107
        super().__init__()
        self._stages: List[Stage] = list(stages)

    @property
    def stages(self) -> List[Stage]:
        return list(self._stages)

    def append_stage(self, stage: Stage) -> "Pipeline":
        self._stages.append(stage)
        return self

    def fit(self, *inputs: Table) -> "PipelineModel":
        last_estimator_idx = -1
        for i, stage in enumerate(self._stages):
            if isinstance(stage, Estimator):
                last_estimator_idx = i

        model_stages: List[AlgoOperator] = []
        last_inputs: Tuple[Table, ...] = tuple(inputs)
        for i, stage in enumerate(self._stages):
            if isinstance(stage, AlgoOperator):
                model_stage: AlgoOperator = stage
            else:
                model_stage = stage.fit(*last_inputs)  # type: ignore[union-attr]
            model_stages.append(model_stage)
            if i < last_estimator_idx:
                last_inputs = tuple(model_stage.transform(*last_inputs))
        return PipelineModel(model_stages)

    def save(self, path: str) -> None:
        _save_stage_chain(self, self._stages, path)

    @classmethod
    def load(cls, path: str) -> "Pipeline":
        return cls(_load_stage_chain(path))


class PipelineModel(Model):
    """Chain of transformer stages applied sequentially. ``transform``
    partitions the chain into maximal runs of kernel-capable stages and
    runs each as one fused program with device-resident intermediates;
    the other stages take the per-stage path."""

    def __init__(self, stages: Sequence[AlgoOperator] = ()):  # noqa: D107
        super().__init__()
        self._stages: List[AlgoOperator] = list(stages)

    @property
    def stages(self) -> List[AlgoOperator]:
        return list(self._stages)

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        from flinkml_tpu_torch import pipeline_fusion

        outputs: Tuple[Table, ...] = tuple(inputs)
        stages = self._stages
        i = 0
        while i < len(stages):
            # Fusion applies to the single-table spine of the chain.
            if len(outputs) == 1 and pipeline_fusion.enabled():
                kernels, end = pipeline_fusion.collect_run(
                    outputs[0], stages, i
                )
                if len(kernels) >= 2:
                    outputs = (
                        pipeline_fusion.execute_kernel_chain(
                            outputs[0], kernels
                        ),
                    )
                    i = end
                    continue
            outputs = tuple(stages[i].transform(*outputs))
            i += 1
        return outputs

    def save(self, path: str) -> None:
        _save_stage_chain(self, self._stages, path)

    @classmethod
    def load(cls, path: str) -> "PipelineModel":
        return cls(_load_stage_chain(path))


def _save_stage_chain(composite: Stage, stages: Sequence[Stage], path: str) -> None:
    read_write.save_metadata(composite, path, extra={"numStages": len(stages)})
    for i, stage in enumerate(stages):
        stage.save(read_write.stage_path(path, i))


def _load_stage_chain(path: str) -> List[Stage]:
    meta = read_write.load_metadata(path)
    num_stages = int(meta["numStages"])
    return [read_write.load_stage(read_write.stage_path(path, i))
            for i in range(num_stages)]
