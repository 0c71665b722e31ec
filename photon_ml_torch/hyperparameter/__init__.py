"""Hyperparameter search (reference photon-lib hyperparameter/**).

Counterpart of ``photon_ml_tpu/hyperparameter``. Like the reference, which
runs its Sobol and GP search on the Spark driver, the search runs on the
host in float64 numpy; each candidate evaluation trains on the device
(tournament lanes in ``search_driver.py``, whole GAME fits in
``game_glue.py``).
"""

from photon_ml_torch.hyperparameter.acquisition import (
    confidence_bound,
    expected_improvement,
)
from photon_ml_torch.hyperparameter.estimators import (
    GaussianProcessEstimator,
    GaussianProcessModel,
)
from photon_ml_torch.hyperparameter.kernels import Matern52, RBF, Kernel
from photon_ml_torch.hyperparameter.rescaling import VectorRescaling
from photon_ml_torch.hyperparameter.search import (
    EvaluationFunction,
    GaussianProcessSearch,
    RandomSearch,
)
from photon_ml_torch.hyperparameter.search_driver import (
    SearchOutcome,
    SearchSpace,
    parse_search_space,
    run_model_search,
)
from photon_ml_torch.hyperparameter.slice_sampler import slice_sample

__all__ = [
    "SearchOutcome",
    "SearchSpace",
    "parse_search_space",
    "run_model_search",
    "confidence_bound",
    "expected_improvement",
    "GaussianProcessEstimator",
    "GaussianProcessModel",
    "Kernel",
    "Matern52",
    "RBF",
    "VectorRescaling",
    "EvaluationFunction",
    "GaussianProcessSearch",
    "RandomSearch",
    "slice_sample",
]
