"""Stages of the model catalog ported so far: the four scalers,
OneHotEncoder, VectorAssembler, LogisticRegression, LinearSVC,
LinearRegression, OnlineLogisticRegression, Knn, MinHashLSH, KMeans (in
RAM and streamed), OnlineKMeans, OnlineStandardScaler, BisectingKMeans,
NaiveBayes, ALS, the MLPs, the factorization machines,
IsotonicRegression, the text features (Tokenizer, RegexTokenizer,
HashingTF, CountVectorizer, IDF), NGram, Word2Vec, the histogram GBTs and
random forests, GaussianMixture, PCA, Correlation,
PowerIterationClustering, the feature tests and selectors,
KBinsDiscretizer and AFTSurvivalRegression (estimators and models).
``__all__`` lists them in the JAX package's order."""

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
from flinkml_tpu_torch.models.fm import (  # noqa: F401
    FMClassifier,
    FMClassifierModel,
    FMRegressor,
    FMRegressorModel,
)
from flinkml_tpu_torch.models.isotonic import (  # noqa: F401
    IsotonicRegression,
    IsotonicRegressionModel,
)
from flinkml_tpu_torch.models.mlp import (  # noqa: F401
    MLPClassifier,
    MLPClassifierModel,
    MLPRegressor,
    MLPRegressorModel,
)
from flinkml_tpu_torch.models.ngram import NGram  # noqa: F401
from flinkml_tpu_torch.models.text import (  # noqa: F401
    IDF,
    CountVectorizer,
    CountVectorizerModel,
    HashingTF,
    IDFModel,
    RegexTokenizer,
    Tokenizer,
)
from flinkml_tpu_torch.models.word2vec import Word2Vec, Word2VecModel  # noqa: F401
from flinkml_tpu_torch.models.discretizer import (  # noqa: F401
    KBinsDiscretizer,
    KBinsDiscretizerModel,
)
from flinkml_tpu_torch.models.gbt import (  # noqa: F401
    GBTClassifier,
    GBTClassifierModel,
    GBTRegressor,
    GBTRegressorModel,
    RandomForestClassifier,
    RandomForestClassifierModel,
    RandomForestRegressor,
    RandomForestRegressorModel,
)
from flinkml_tpu_torch.models.gmm import (  # noqa: F401
    GaussianMixture,
    GaussianMixtureModel,
)
from flinkml_tpu_torch.models.pca import PCA, PCAModel  # noqa: F401
from flinkml_tpu_torch.models.pic import PowerIterationClustering  # noqa: F401
from flinkml_tpu_torch.models.selectors import (  # noqa: F401
    ANOVATest,
    ChiSqTest,
    FValueTest,
    UnivariateFeatureSelector,
    UnivariateFeatureSelectorModel,
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
)
from flinkml_tpu_torch.models.stats import Correlation  # noqa: F401
from flinkml_tpu_torch.models.survival import (  # noqa: F401
    AFTSurvivalRegression,
    AFTSurvivalRegressionModel,
)

__all__ = [
    "LogisticRegression",
    "LogisticRegressionModel",
    "KMeans",
    "KMeansModel",
    "Knn",
    "KnnModel",
    "NaiveBayes",
    "NaiveBayesModel",
    "OneHotEncoder",
    "OneHotEncoderModel",
    "LinearSVC",
    "LinearSVCModel",
    "LinearRegression",
    "LinearRegressionModel",
    "OnlineKMeans",
    "OnlineKMeansModel",
    "OnlineLogisticRegression",
    "OnlineLogisticRegressionModel",
    "StandardScaler",
    "StandardScalerModel",
    "MinMaxScaler",
    "MinMaxScalerModel",
    "MaxAbsScaler",
    "MaxAbsScalerModel",
    "RobustScaler",
    "RobustScalerModel",
    "KBinsDiscretizer",
    "KBinsDiscretizerModel",
    "OnlineStandardScaler",
    "OnlineStandardScalerModel",
    "Correlation",
    "ALS",
    "ALSModel",
    "BisectingKMeans",
    "BisectingKMeansModel",
    "PowerIterationClustering",
    "GaussianMixture",
    "GaussianMixtureModel",
    "GBTClassifier",
    "GBTClassifierModel",
    "GBTRegressor",
    "GBTRegressorModel",
    "RandomForestClassifier",
    "RandomForestClassifierModel",
    "RandomForestRegressor",
    "RandomForestRegressorModel",
    "MLPClassifier",
    "MLPClassifierModel",
    "MLPRegressor",
    "MLPRegressorModel",
    "FMClassifier",
    "FMClassifierModel",
    "FMRegressor",
    "FMRegressorModel",
    "IsotonicRegression",
    "IsotonicRegressionModel",
    "AFTSurvivalRegression",
    "AFTSurvivalRegressionModel",
    "PCA",
    "PCAModel",
    "Tokenizer",
    "RegexTokenizer",
    "HashingTF",
    "CountVectorizer",
    "CountVectorizerModel",
    "IDF",
    "IDFModel",
    "VectorAssembler",
    "NGram",
    "Word2Vec",
    "Word2VecModel",
    "MinHashLSH",
    "MinHashLSHModel",
    "ChiSqTest",
    "ANOVATest",
    "FValueTest",
    "VarianceThresholdSelector",
    "VarianceThresholdSelectorModel",
    "UnivariateFeatureSelector",
    "UnivariateFeatureSelectorModel",
]
