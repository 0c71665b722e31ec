"""Covariance kernels for GP-based hyperparameter search.

Reference parity: photon-lib hyperparameter/estimators/kernels/ — RBF and
Matern52 with amplitude, per-dimension lengthscales, and a noise floor;
`StationaryKernel` expected-improvement machinery works on the same
hyperparameters (amplitude, noise, lengthScale).

The port's own copy of ``photon_ml_tpu/hyperparameter/kernels.py`` (numpy and
scipy only), equal to it bit for bit under the same seeds.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _scaled_sqdist(x1: np.ndarray, x2: np.ndarray, lengthscale: np.ndarray) -> np.ndarray:
    """Pairwise squared distance of rows after per-dim lengthscale division."""
    a = x1 / lengthscale
    b = x2 / lengthscale
    aa = (a * a).sum(axis=1)[:, None]
    bb = (b * b).sum(axis=1)[None, :]
    sq = aa + bb - 2.0 * (a @ b.T)
    return np.maximum(sq, 0.0)


@dataclasses.dataclass(frozen=True)
class Kernel:
    """amplitude² · k(r/lengthscale) (+ noise² on the diagonal of K(X, X))."""

    amplitude: float = 1.0
    noise: float = 1e-4
    lengthscale: np.ndarray | float = 1.0

    def _ls(self, dim: int) -> np.ndarray:
        ls = np.asarray(self.lengthscale, dtype=np.float64)
        if ls.ndim == 0:
            ls = np.full((dim,), float(ls))
        return ls

    def __call__(self, x1: np.ndarray, x2: np.ndarray | None = None) -> np.ndarray:
        x1 = np.atleast_2d(np.asarray(x1, dtype=np.float64))
        symmetric = x2 is None
        x2m = x1 if symmetric else np.atleast_2d(np.asarray(x2, dtype=np.float64))
        k = self.amplitude**2 * self._corr(_scaled_sqdist(x1, x2m, self._ls(x1.shape[1])))
        if symmetric:
            k = k + self.noise**2 * np.eye(len(x1))
        return k

    def _corr(self, sqdist: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def with_params(self, amplitude: float, noise: float, lengthscale) -> "Kernel":
        return dataclasses.replace(
            self, amplitude=amplitude, noise=noise, lengthscale=lengthscale
        )


@dataclasses.dataclass(frozen=True)
class RBF(Kernel):
    """Squared-exponential kernel (reference kernels/RBF.scala)."""

    def _corr(self, sqdist: np.ndarray) -> np.ndarray:
        return np.exp(-0.5 * sqdist)


@dataclasses.dataclass(frozen=True)
class Matern52(Kernel):
    """Matérn 5/2 kernel (reference kernels/Matern52.scala) — the
    reference's default for hyperparameter response surfaces."""

    def _corr(self, sqdist: np.ndarray) -> np.ndarray:
        r = np.sqrt(5.0 * sqdist)
        return (1.0 + r + (5.0 / 3.0) * sqdist) * np.exp(-r)
