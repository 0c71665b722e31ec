"""The slice as a whole: the port's train_glm on sparse batches against the
JAX package's, in f64 on the CPU, across solvers and layouts, with
variances."""

import numpy as np
import pytest
import torch

from photon_ml_tpu.estimators import train_glm as jax_train_glm
from photon_ml_tpu.optim.optimizer import OptimizerConfig as JaxConfig
from photon_ml_tpu.optim.optimizer import OptimizerType as JaxType
from photon_ml_tpu.types import TaskType as JaxTask
from photon_ml_torch import convert
from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.estimators import train_glm
from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
from photon_ml_torch.types import TaskType
from tests.test_torch_sparse_objective import batch_pair, sparse_problem
from tests.torch_parity import normalizations, to_np

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

LAMBDAS = (0.1, 1.0, 20.0)
D = 37

# task, normalization, elastic-net alpha, optimizer (type, max_iterations, tolerance), view
CASES = [
    ("LOGISTIC_REGRESSION", "STANDARDIZATION", 0.0, ("LBFGS", 100, 1e-7), "ell_tail"),
    ("LOGISTIC_REGRESSION", "SCALE_WITH_STANDARD_DEVIATION", 0.0, ("LBFGS", 100, 1e-7), "flat"),
    ("LOGISTIC_REGRESSION", "SCALE_WITH_STANDARD_DEVIATION", 0.5, ("LBFGS", 100, 1e-7),
     "ell_tail"),
    # the column-sorted view sums its runs in another order than jnp.cumsum
    # (rounding ~1e-14); TRON's CG on squared or Poisson loss amplifies that
    # to ~1e-6 in where it stops at this tolerance, logistic TRON does not
    ("LOGISTIC_REGRESSION", "STANDARDIZATION", 0.0, ("TRON", 15, 1e-5), "column_sorted"),
    ("POISSON_REGRESSION", "NONE", 0.0, ("TRON", 15, 1e-5), "hybrid"),
    ("LOGISTIC_REGRESSION", "NONE", 0.0, ("TRON", 15, 1e-5), "hybrid"),
    # the smoothed hinge's piecewise curvature makes L-BFGS's path follow
    # last-bit differences of the margins (~1e-6 in the end on every view);
    # its objective is held to the JAX package in test_torch_sparse_objective
    ("LOGISTIC_REGRESSION", "SCALE_WITH_STANDARD_DEVIATION", 0.5, ("LBFGS", 100, 1e-7),
     "column_sorted"),
    ("LINEAR_REGRESSION", "NONE", 0.5, ("LBFGS", 100, 1e-7), "flat_padded"),
]


def _fit_both(task, norm, alpha, opt, view, **kwargs):
    problem = sparse_problem(seed=21, binary=TaskType[task].is_classification)
    if task == "POISSON_REGRESSION":
        problem = problem[:3] + (np.round(problem[3]),) + problem[4:]
    port_b, ref_b = batch_pair(view, problem)
    jn, tn = normalizations(norm, problem[-1], intercept_index=D - 1)
    otype, iters, tol = opt
    common = dict(regularization_weights=LAMBDAS, elastic_net_alpha=alpha, intercept_index=D - 1,
                  **kwargs)
    ref = jax_train_glm(ref_b, JaxTask[task], optimizer=JaxConfig(JaxType[otype], iters, tol),
                        normalization=jn, **common)
    port = train_glm(port_b, TaskType[task],
                     optimizer=OptimizerConfig(OptimizerType[otype], iters, tol),
                     normalization=tn, **common)
    return ref, port


@pytest.mark.parametrize("task,norm,alpha,opt,view", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3][0]}-{c[4]}" for c in CASES])
def test_sparse_train_glm_matches(task, norm, alpha, opt, view):
    ref, port = _fit_both(task, norm, alpha, opt, view, compute_variance=True)
    assert sorted(port) == sorted(ref) == sorted(LAMBDAS)
    for lam in LAMBDAS:
        pc, rc = port[lam].coefficients, ref[lam].coefficients
        np.testing.assert_allclose(to_np(pc.means), to_np(rc.means), rtol=1e-7, atol=1e-9)
        assert pc.variances is not None and pc.variances.shape == (D,)
        np.testing.assert_allclose(to_np(pc.variances), to_np(rc.variances), rtol=1e-6)
        assert port[lam].task.value == ref[lam].task.value
    if alpha > 0.0:  # the elastic-net path zeroes coefficients at the largest λ
        assert (to_np(port[20.0].coefficients.means) == 0.0).any()


def test_sparse_matches_dense_port():
    """The same entries as a dense batch: the port's two paths agree."""
    problem = sparse_problem(seed=22)
    port_b, _ = batch_pair("ell_tail", problem)
    x = problem[-1]
    dense = LabeledPointBatch.create(x, problem[3], problem[4], problem[5], device="cpu")
    kw = dict(regularization_weights=(0.5,), compute_variance=True)
    ms = train_glm(port_b, TaskType.LOGISTIC_REGRESSION, **kw)[0.5].coefficients
    md = train_glm(dense, TaskType.LOGISTIC_REGRESSION, variance_mode="diagonal", **kw)[0.5] \
        .coefficients
    torch.testing.assert_close(ms.means, md.means, rtol=1e-7, atol=1e-9)
    torch.testing.assert_close(ms.variances, md.variances, rtol=1e-7, atol=1e-12)


def test_explicit_full_variance_raises_before_any_solve():
    problem = sparse_problem(seed=23)
    port_b, _ = batch_pair("flat", problem)
    solves = []
    with pytest.raises(ValueError, match="dense Hessian"):
        train_glm(port_b, TaskType.LOGISTIC_REGRESSION, compute_variance=True,
                  variance_mode="full", on_solve=lambda lam, r: solves.append(lam))
    with pytest.raises(ValueError, match="variance mode"):
        train_glm(port_b, TaskType.LOGISTIC_REGRESSION, variance_mode="exact",
                  on_solve=lambda lam, r: solves.append(lam))
    assert solves == []


def test_bf16_sparse_batch_solves_in_f32():
    rows, cols, vals, labels, offsets, weights, _ = sparse_problem(seed=24)
    kw = dict(dim=D, offsets=offsets.astype(np.float32), weights=weights.astype(np.float32),
              device="cpu")
    b16 = convert.sparse_batch_from_numpy(rows, cols, vals.astype(np.float32), labels,
                                          dtype=torch.bfloat16, **kw)
    b32 = convert.sparse_batch_from_numpy(rows, cols, vals.astype(np.float32), labels, **kw)
    m16 = train_glm(b16, TaskType.LOGISTIC_REGRESSION, regularization_weights=(1.0,))[1.0]
    m32 = train_glm(b32, TaskType.LOGISTIC_REGRESSION, regularization_weights=(1.0,))[1.0]
    assert m16.coefficients.means.dtype == torch.float32
    np.testing.assert_allclose(to_np(m16.coefficients.means), to_np(m32.coefficients.means),
                               rtol=5e-2, atol=5e-2)
