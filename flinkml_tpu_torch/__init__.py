"""flinkml_tpu_torch — the PyTorch/CUDA port of flinkml_tpu.

A second package beside the JAX one (``flinkml_tpu``, the reference), with
the same module paths, the same pipeline API and the same on-disk model
format, on torch tensors. Entry points compute on the CUDA device unless
the caller asks for the CPU (:func:`use_device` /
:func:`set_default_device`); the hot loops are hand-written CUDA kernels
for Hopper (:mod:`flinkml_tpu_torch.kernels`).

Ported so far: tables, params, persistence, ``Pipeline``/``PipelineModel``
with the fused executor, the four scalers (fit + transform),
``OneHotEncoder`` and ``VectorAssembler``, ``LogisticRegression``
(binomial fit, dense and sparse, in RAM and streamed;
multinomial, dense) and ``LogisticRegressionModel`` (binomial and
multinomial, dense and sparse transform), ``LinearSVC`` and
``LinearRegression`` (in RAM and streamed; the normal equations),
``OnlineLogisticRegression`` (FTRL over a stream), ``Knn``, ``MinHashLSH``,
``KMeans`` (in RAM, and streamed out of core with checkpoints),
``OnlineKMeans`` and ``BisectingKMeans`` with their models (and the
catalog's later slices: ALS, the recsys family, the histogram GBTs and
random forests, GaussianMixture, PCA, Correlation, PIC, the selectors,
KBinsDiscretizer and AFT survival); the
iteration runtime (``iterate``), checkpoint/resume (``CheckpointManager``)
and the out-of-core data cache (``DataCache``) in
:mod:`flinkml_tpu_torch.iteration`; the input pipeline
(:mod:`flinkml_tpu_torch.data`: ``Dataset``, ``ElasticFeed``, cursors, the
device prefetcher; CSV and LibSVM through native parsers) and the
sorted-column stream it feeds; ``ops.BatchedCSR`` and the three sparse
gradient layouts (``unsorted``, ``sorted``, ``cumsum``); and all four
kernels: ``fused_chain``, ``spmv``, ``segment_sum`` and ``topk``. Fused serving
runs under the precision tiers (``precision``:
``pipeline_fusion.precision_scope("mixed_inference")`` and the others),
and the kernels take bfloat16. :mod:`flinkml_tpu_torch.parallel` runs the
in-RAM linear and KMeans fits data parallel on a ``torch.distributed``
mesh (``mesh=``), one process and one device per rank;
:mod:`flinkml_tpu_torch.sharding` shards the linear fits' state by a
``ShardingPlan`` (``sharding_plan=``) and trains them under a precision
policy (``precision="mixed"``). ``NaiveBayes`` and the graph API
(``GraphBuilder``, ``Graph``, ``GraphModel``) complete the reference's
surface. :mod:`flinkml_tpu_torch.faults` scripts failures at the runtime's
seams, :mod:`flinkml_tpu_torch.recovery` checks a fit's numerics on the
device and heals a poisoned batch by rollback and quarantine (with
``OnlineStandardScaler``, the three online trainers take ``sentinel=`` and
``recovery=``), and :mod:`flinkml_tpu_torch.utils.preemption` stops a fit
cleanly on SIGTERM or a lost rank. :mod:`flinkml_tpu_torch.serving` serves
fitted pipelines online: a micro-batching ``ServingEngine`` over the fused
executor (one CUDA stream an engine), a versioned ``ModelRegistry`` with hot
swaps, a ``ReplicaPool`` with gray-failure defense, an autoscaler and a
multi-model pool. :mod:`flinkml_tpu_torch.parallel` also carries tensor,
pipeline and expert parallelism and ring attention;
:mod:`flinkml_tpu_torch.embeddings` shards embedding tables over a mesh,
:mod:`flinkml_tpu_torch.features` hashes raw keys into them and publishes
a streaming FM trainer's rows as registry deltas, and ``ALS`` factors a
ratings matrix with the ``segment_sum`` kernel and recommends with
``topk``.
"""

from flinkml_tpu_torch.api import (  # noqa: F401
    AlgoOperator,
    ColumnKernel,
    Estimator,
    Model,
    Stage,
    Transformer,
)
from flinkml_tpu_torch.device import (  # noqa: F401
    default_device,
    set_default_device,
    use_device,
)
from flinkml_tpu_torch.io.read_write import (  # noqa: F401
    ModelIntegrityError,
    load_stage,
    stage_from_arrays,
)
from flinkml_tpu_torch.kernels import (  # noqa: F401
    KernelUnsupportedError,
    launch_counts,
    reset_launch_counts,
)
from flinkml_tpu_torch.linalg import (  # noqa: F401
    DenseVector,
    SparseVector,
    Vector,
    Vectors,
)
from flinkml_tpu_torch.models import (  # noqa: F401
    AFTSurvivalRegression,
    AFTSurvivalRegressionModel,
    ALS,
    ALSModel,
    ANOVATest,
    BisectingKMeans,
    BisectingKMeansModel,
    ChiSqTest,
    Correlation,
    CountVectorizer,
    CountVectorizerModel,
    FMClassifier,
    FMClassifierModel,
    FMRegressor,
    FMRegressorModel,
    FValueTest,
    GBTClassifier,
    GBTClassifierModel,
    GBTRegressor,
    GBTRegressorModel,
    GaussianMixture,
    GaussianMixtureModel,
    HashingTF,
    IDF,
    IDFModel,
    IsotonicRegression,
    IsotonicRegressionModel,
    KBinsDiscretizer,
    KBinsDiscretizerModel,
    KMeans,
    KMeansModel,
    Knn,
    KnnModel,
    LinearRegression,
    LinearRegressionModel,
    LinearSVC,
    LinearSVCModel,
    LogisticRegression,
    LogisticRegressionModel,
    MLPClassifier,
    MLPClassifierModel,
    MLPRegressor,
    MLPRegressorModel,
    MaxAbsScaler,
    MaxAbsScalerModel,
    MinHashLSH,
    MinHashLSHModel,
    MinMaxScaler,
    MinMaxScalerModel,
    NGram,
    NaiveBayes,
    NaiveBayesModel,
    OneHotEncoder,
    OneHotEncoderModel,
    OnlineKMeans,
    OnlineKMeansModel,
    OnlineLogisticRegression,
    OnlineLogisticRegressionModel,
    PCA,
    PCAModel,
    PowerIterationClustering,
    RandomForestClassifier,
    RandomForestClassifierModel,
    RandomForestRegressor,
    RandomForestRegressorModel,
    RegexTokenizer,
    RobustScaler,
    RobustScalerModel,
    StandardScaler,
    StandardScalerModel,
    Tokenizer,
    UnivariateFeatureSelector,
    UnivariateFeatureSelectorModel,
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
    VectorAssembler,
    Word2Vec,
    Word2VecModel,
)
from flinkml_tpu_torch import (  # noqa: F401
    data,
    iteration,
    ops,
    precision,
    sharding,
)
from flinkml_tpu_torch.graph import (  # noqa: F401
    Graph,
    GraphBuilder,
    GraphModel,
    TableId,
)
from flinkml_tpu_torch.iteration import (  # noqa: F401
    CheckpointManager,
    DataCache,
    iterate,
)
from flinkml_tpu_torch.params import (  # noqa: F401
    BoolParam,
    FloatArrayParam,
    FloatParam,
    IntArrayParam,
    IntParam,
    LongParam,
    Param,
    ParamValidators,
    StringArrayParam,
    StringParam,
    WithParams,
)
from flinkml_tpu_torch.pipeline import Pipeline, PipelineModel  # noqa: F401
from flinkml_tpu_torch.precision import (  # noqa: F401
    PrecisionPolicy,
    PrecisionValidationError,
)
from flinkml_tpu_torch.table import Table  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "AFTSurvivalRegression",
    "AFTSurvivalRegressionModel",
    "ALS",
    "ALSModel",
    "ANOVATest",
    "AlgoOperator",
    "BisectingKMeans",
    "BisectingKMeansModel",
    "BoolParam",
    "CheckpointManager",
    "ChiSqTest",
    "ColumnKernel",
    "Correlation",
    "CountVectorizer",
    "CountVectorizerModel",
    "DataCache",
    "DenseVector",
    "Estimator",
    "FMClassifier",
    "FMClassifierModel",
    "FMRegressor",
    "FMRegressorModel",
    "FValueTest",
    "FloatArrayParam",
    "FloatParam",
    "GBTClassifier",
    "GBTClassifierModel",
    "GBTRegressor",
    "GBTRegressorModel",
    "GaussianMixture",
    "GaussianMixtureModel",
    "Graph",
    "GraphBuilder",
    "GraphModel",
    "HashingTF",
    "IDF",
    "IDFModel",
    "IntArrayParam",
    "IntParam",
    "IsotonicRegression",
    "IsotonicRegressionModel",
    "KBinsDiscretizer",
    "KBinsDiscretizerModel",
    "KMeans",
    "KMeansModel",
    "KernelUnsupportedError",
    "Knn",
    "KnnModel",
    "LinearRegression",
    "LinearRegressionModel",
    "LinearSVC",
    "LinearSVCModel",
    "LogisticRegression",
    "LogisticRegressionModel",
    "LongParam",
    "MLPClassifier",
    "MLPClassifierModel",
    "MLPRegressor",
    "MLPRegressorModel",
    "MaxAbsScaler",
    "MaxAbsScalerModel",
    "MinHashLSH",
    "MinHashLSHModel",
    "MinMaxScaler",
    "MinMaxScalerModel",
    "Model",
    "ModelIntegrityError",
    "NGram",
    "NaiveBayes",
    "NaiveBayesModel",
    "OneHotEncoder",
    "OneHotEncoderModel",
    "OnlineKMeans",
    "OnlineKMeansModel",
    "OnlineLogisticRegression",
    "OnlineLogisticRegressionModel",
    "PCA",
    "PCAModel",
    "Param",
    "ParamValidators",
    "Pipeline",
    "PipelineModel",
    "PowerIterationClustering",
    "PrecisionPolicy",
    "PrecisionValidationError",
    "RandomForestClassifier",
    "RandomForestClassifierModel",
    "RandomForestRegressor",
    "RandomForestRegressorModel",
    "RegexTokenizer",
    "RobustScaler",
    "RobustScalerModel",
    "SparseVector",
    "Stage",
    "StandardScaler",
    "StandardScalerModel",
    "StringArrayParam",
    "StringParam",
    "Table",
    "TableId",
    "Tokenizer",
    "Transformer",
    "UnivariateFeatureSelector",
    "UnivariateFeatureSelectorModel",
    "VarianceThresholdSelector",
    "VarianceThresholdSelectorModel",
    "Vector",
    "VectorAssembler",
    "Vectors",
    "WithParams",
    "Word2Vec",
    "Word2VecModel",
    "__version__",
    "data",
    "default_device",
    "iterate",
    "iteration",
    "launch_counts",
    "load_stage",
    "ops",
    "reset_launch_counts",
    "set_default_device",
    "sharding",
    "stage_from_arrays",
    "use_device",
]
