"""Shared ``HasXxx`` parameter mixins.

Parity: the 17 mixin interfaces in
``flink-ml-lib/.../ml/common/param/Has*.java`` (SURVEY.md §2.3) — same param
names, defaults, and validators. Stages compose these by inheritance exactly
as the reference's interfaces compose by ``extends``.
"""

from __future__ import annotations

from flinkml_tpu_torch.params import (
    FloatParam,
    IntParam,
    LongParam,
    ParamValidators,
    StringArrayParam,
    StringParam,
    WithParams,
)


class HasFeaturesCol(WithParams):
    FEATURES_COL = StringParam(
        "featuresCol", "Features column name.", "features", ParamValidators.not_null()
    )


class HasLabelCol(WithParams):
    LABEL_COL = StringParam(
        "labelCol", "Label column name.", "label", ParamValidators.not_null()
    )


class HasPredictionCol(WithParams):
    PREDICTION_COL = StringParam(
        "predictionCol", "Prediction column name.", "prediction", ParamValidators.not_null()
    )


class HasRawPredictionCol(WithParams):
    RAW_PREDICTION_COL = StringParam(
        "rawPredictionCol", "Raw prediction column name.", "rawPrediction"
    )


class HasWeightCol(WithParams):
    WEIGHT_COL = StringParam("weightCol", "Weight column name.", None)


class HasMaxIter(WithParams):
    MAX_ITER = IntParam(
        "maxIter", "Maximum number of iterations.", 20, ParamValidators.gt(0)
    )


class HasReg(WithParams):
    REG = FloatParam("reg", "Regularization parameter.", 0.0, ParamValidators.gt_eq(0.0))


class HasLearningRate(WithParams):
    LEARNING_RATE = FloatParam(
        "learningRate", "Learning rate of optimization method.", 0.1,
        ParamValidators.gt(0.0),
    )


class HasGlobalBatchSize(WithParams):
    GLOBAL_BATCH_SIZE = IntParam(
        "globalBatchSize", "Global batch size of training algorithms.", 32,
        ParamValidators.gt(0),
    )


class HasTol(WithParams):
    TOL = FloatParam(
        "tol", "Convergence tolerance for iterative algorithms.", 1e-6,
        ParamValidators.gt_eq(0.0),
    )


class HasSeed(WithParams):
    SEED = LongParam("seed", "The random seed.", None)

    def get_seed(self) -> int:
        """Default seed is drawn once per call when unset (reference:
        HasSeed.getSeed falls back to a random value)."""
        seed = self.get(HasSeed.SEED)
        if seed is None:
            import random

            return random.getrandbits(31)
        return int(seed)


class HasMultiClass(WithParams):
    MULTI_CLASS = StringParam(
        "multiClass", "Classification type.", "auto",
        ParamValidators.in_array(["auto", "binomial", "multinomial"]),
    )


class HasSmoothing(WithParams):
    SMOOTHING = FloatParam(
        "smoothing", "The smoothing parameter.", 1.0, ParamValidators.gt_eq(0.0)
    )


class HasK(WithParams):
    K = IntParam(
        "k", "The number of nearest neighbors.", 5, ParamValidators.gt(0)
    )


class HasDistanceMeasure(WithParams):
    DISTANCE_MEASURE = StringParam(
        "distanceMeasure", "Distance measure.", "euclidean",
        ParamValidators.in_array(["euclidean", "cosine", "manhattan"]),
    )


class HasInputCol(WithParams):
    INPUT_COL = StringParam("inputCol", "Input column name.", "input")


class HasOutputCol(WithParams):
    OUTPUT_COL = StringParam("outputCol", "Output column name.", "output")


class HasInputCols(WithParams):
    INPUT_COLS = StringArrayParam(
        "inputCols", "Input column names.", None, ParamValidators.non_empty_array()
    )


class HasOutputCols(WithParams):
    OUTPUT_COLS = StringArrayParam(
        "outputCols", "Output column names.", None, ParamValidators.non_empty_array()
    )


class HasHandleInvalid(WithParams):
    ERROR_INVALID = "error"
    SKIP_INVALID = "skip"
    KEEP_INVALID = "keep"

    HANDLE_INVALID = StringParam(
        "handleInvalid", "Strategy to handle invalid entries.", "error",
        ParamValidators.in_array(["error", "skip", "keep"]),
    )


class HasBatchStrategy(WithParams):
    """Online-algorithm batching strategy (reference: HasBatchStrategy with
    COUNT strategy only)."""

    COUNT_STRATEGY = "count"

    BATCH_STRATEGY = StringParam(
        "batchStrategy", "Strategy to create mini batch from online train data.",
        "count", ParamValidators.in_array(["count"]),
    )


class HasDecayFactor(WithParams):
    DECAY_FACTOR = FloatParam(
        "decayFactor", "The forgetfulness of the previous centroids.", 0.0,
        ParamValidators.in_range(0.0, 1.0),
    )


class HasElasticNet(WithParams):
    ELASTIC_NET = FloatParam(
        "elasticNet", "ElasticNet parameter (0 = L2, 1 = L1).", 0.0,
        ParamValidators.in_range(0.0, 1.0),
    )
