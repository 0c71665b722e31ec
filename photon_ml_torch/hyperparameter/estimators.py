"""Gaussian-process regression with slice-sampled kernel hyperparameters.

Reference parity: photon-lib hyperparameter/estimators/
GaussianProcessEstimator.scala:36-60 (fit = sample kernel configurations
from their posterior via slice sampling, keep the ensemble) and
GaussianProcessModel.scala (posterior mean/variance, averaged over the
sampled kernels).

The port's own copy of ``photon_ml_tpu/hyperparameter/estimators.py`` (numpy and
scipy only), equal to it bit for bit under the same seeds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.linalg import cho_factor, cho_solve

from photon_ml_torch.hyperparameter.kernels import Kernel, Matern52
from photon_ml_torch.hyperparameter.slice_sampler import slice_sample


@dataclasses.dataclass
class _FittedKernel:
    kernel: Kernel
    chol: tuple
    alpha: np.ndarray  # (K + σ²I)⁻¹ y


@dataclasses.dataclass
class GaussianProcessModel:
    """Posterior over a scalar response, ensemble-averaged over kernels."""

    x_train: np.ndarray
    y_mean: float
    y_std: float
    fitted: list[_FittedKernel]

    def predict(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Return (mean, variance) at candidate points [m, d], in the
        original (un-standardized) response units."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        means, variances = [], []
        for f in self.fitted:
            k_star = f.kernel(x, self.x_train)  # [m, n]
            mu = k_star @ f.alpha
            v = cho_solve(f.chol, k_star.T)  # [n, m]
            # stationary kernel: prior variance is the constant amplitude²
            prior = np.full(len(x), f.kernel.amplitude**2)
            var = np.maximum(prior - np.einsum("mn,nm->m", k_star, v), 1e-12)
            means.append(mu)
            variances.append(var)
        mean = np.mean(means, axis=0)
        # law of total variance across the kernel ensemble
        var = np.mean(variances, axis=0) + np.var(means, axis=0)
        return mean * self.y_std + self.y_mean, var * self.y_std**2


@dataclasses.dataclass
class GaussianProcessEstimator:
    """Fit a GP by slice-sampling kernel hyperparameters from the marginal
    likelihood × prior (reference GaussianProcessEstimator.scala:36-60)."""

    kernel: Kernel = dataclasses.field(default_factory=Matern52)
    num_kernel_samples: int = 5
    burn_in: int = 10
    seed: int = 0
    #: explicit generator for the slice sampler — searchers thread ONE
    #: generator through every fit so trajectories replay deterministically
    #: (None = a fresh default_rng(seed) per fit, the standalone behavior)
    rng: np.random.Generator | None = None
    #: log-normal prior scale on (log amplitude, log noise, log lengthscale)
    prior_scale: float = 2.0

    def fit(self, x: np.ndarray, y: np.ndarray) -> GaussianProcessModel:
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.asarray(y, dtype=np.float64).ravel()
        y_mean = float(y.mean())
        y_std = float(y.std()) or 1.0
        ys = (y - y_mean) / y_std
        d = x.shape[1]

        def unpack(theta: np.ndarray) -> Kernel:
            return self.kernel.with_params(
                amplitude=float(np.exp(theta[0])),
                noise=float(np.exp(theta[1])),
                lengthscale=np.exp(theta[2 : 2 + d]),
            )

        def log_marginal(theta: np.ndarray) -> float:
            if np.any(np.abs(theta) > 20.0):
                return -np.inf
            kern = unpack(theta)
            k = kern(x)
            try:
                chol = cho_factor(k, lower=True)
            except np.linalg.LinAlgError:
                return -np.inf
            alpha = cho_solve(chol, ys)
            log_det = 2.0 * np.sum(np.log(np.diag(chol[0])))
            ll = -0.5 * ys @ alpha - 0.5 * log_det
            prior = -0.5 * float(theta @ theta) / self.prior_scale**2
            return float(ll + prior)

        theta0 = np.zeros(2 + d)
        theta0[1] = np.log(0.1)  # start with moderate noise
        rng = self.rng if self.rng is not None else np.random.default_rng(self.seed)
        thetas = slice_sample(
            log_marginal,
            theta0,
            rng,
            num_samples=self.num_kernel_samples,
            burn_in=self.burn_in,
        )

        fitted = []
        for theta in thetas:
            kern = unpack(theta)
            chol = cho_factor(kern(x), lower=True)
            fitted.append(
                _FittedKernel(kernel=kern, chol=chol, alpha=cho_solve(chol, ys))
            )
        return GaussianProcessModel(
            x_train=x, y_mean=y_mean, y_std=y_std, fitted=fitted
        )
