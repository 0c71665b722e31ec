"""Model diagnostics (the port's own copies; reference photon-diagnostics)."""

from photon_ml_torch.diagnostics.bootstrap import BootstrapReport, bootstrap_training
from photon_ml_torch.diagnostics.feature_importance import (
    FeatureImportanceReport,
    feature_importance,
)
from photon_ml_torch.diagnostics.fitting import FittingReport, fitting_diagnostic
from photon_ml_torch.diagnostics.hosmer_lemeshow import HosmerLemeshowReport, hosmer_lemeshow
from photon_ml_torch.diagnostics.independence import (
    IndependenceReport,
    kendall_tau_independence,
)
from photon_ml_torch.diagnostics.metrics import evaluate_model
from photon_ml_torch.diagnostics.summary import CoefficientSummary

__all__ = [
    "BootstrapReport",
    "bootstrap_training",
    "FeatureImportanceReport",
    "feature_importance",
    "FittingReport",
    "fitting_diagnostic",
    "HosmerLemeshowReport",
    "hosmer_lemeshow",
    "IndependenceReport",
    "kendall_tau_independence",
    "evaluate_model",
    "CoefficientSummary",
]
