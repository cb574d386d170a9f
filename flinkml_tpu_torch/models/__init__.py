"""Stages of the model catalog ported so far: the four scalers,
OneHotEncoder, VectorAssembler, LogisticRegression, LinearSVC,
LinearRegression, OnlineLogisticRegression, Knn, MinHashLSH, KMeans (in
RAM and streamed), OnlineKMeans, OnlineStandardScaler, BisectingKMeans
NaiveBayes and ALS (estimators and models)."""

from flinkml_tpu_torch.models.als import ALS, ALSModel  # noqa: F401
from flinkml_tpu_torch.models.bisecting_kmeans import (  # noqa: F401
    BisectingKMeans,
    BisectingKMeansModel,
)
from flinkml_tpu_torch.models.kmeans import KMeans, KMeansModel  # noqa: F401
from flinkml_tpu_torch.models.knn import Knn, KnnModel  # noqa: F401
from flinkml_tpu_torch.models.linear_regression import (  # noqa: F401
    LinearRegression,
    LinearRegressionModel,
)
from flinkml_tpu_torch.models.linear_svc import (  # noqa: F401
    LinearSVC,
    LinearSVCModel,
)
from flinkml_tpu_torch.models.logistic_regression import (  # noqa: F401
    LogisticRegression,
    LogisticRegressionModel,
)
from flinkml_tpu_torch.models.lsh import MinHashLSH, MinHashLSHModel  # noqa: F401
from flinkml_tpu_torch.models.naive_bayes import (  # noqa: F401
    NaiveBayes,
    NaiveBayesModel,
)
from flinkml_tpu_torch.models.online_kmeans import (  # noqa: F401
    OnlineKMeans,
    OnlineKMeansModel,
)
from flinkml_tpu_torch.models.online_logistic_regression import (  # noqa: F401
    OnlineLogisticRegression,
    OnlineLogisticRegressionModel,
)
from flinkml_tpu_torch.models.online_scaler import (  # noqa: F401
    OnlineStandardScaler,
    OnlineStandardScalerModel,
)
from flinkml_tpu_torch.models.one_hot_encoder import (  # noqa: F401
    OneHotEncoder,
    OneHotEncoderModel,
)
from flinkml_tpu_torch.models.scalers import (  # noqa: F401
    MaxAbsScaler,
    MaxAbsScalerModel,
    MinMaxScaler,
    MinMaxScalerModel,
    RobustScaler,
    RobustScalerModel,
    StandardScaler,
    StandardScalerModel,
)
from flinkml_tpu_torch.models.vector_assembler import VectorAssembler  # noqa: F401

__all__ = [
    "ALS",
    "ALSModel",
    "BisectingKMeans",
    "BisectingKMeansModel",
    "KMeans",
    "KMeansModel",
    "Knn",
    "KnnModel",
    "LinearRegression",
    "LinearRegressionModel",
    "LinearSVC",
    "LinearSVCModel",
    "LogisticRegression",
    "LogisticRegressionModel",
    "MaxAbsScaler",
    "MaxAbsScalerModel",
    "MinHashLSH",
    "MinHashLSHModel",
    "MinMaxScaler",
    "MinMaxScalerModel",
    "NaiveBayes",
    "NaiveBayesModel",
    "OneHotEncoder",
    "OneHotEncoderModel",
    "OnlineKMeans",
    "OnlineKMeansModel",
    "OnlineLogisticRegression",
    "OnlineLogisticRegressionModel",
    "OnlineStandardScaler",
    "OnlineStandardScalerModel",
    "RobustScaler",
    "RobustScalerModel",
    "StandardScaler",
    "StandardScalerModel",
    "VectorAssembler",
]
