"""The slice as a whole: the port's train_glm against the JAX package's, in
f64 on the CPU, then scoring and metrics of the trained models."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.estimators import train_glm as jax_train_glm
from photon_ml_tpu.evaluation import local_metrics as jax_metrics
from photon_ml_tpu.optim.optimizer import OptimizerConfig as JaxConfig
from photon_ml_tpu.optim.optimizer import OptimizerType as JaxType
from photon_ml_tpu.types import TaskType as JaxTask
from photon_ml_torch import convert
from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.estimators import train_glm
from photon_ml_torch.evaluation import local_metrics
from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
from photon_ml_torch.types import TaskType
from tests.torch_parity import batches, make_data, normalizations, to_np

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

LAMBDAS = (0.1, 1.0, 50.0)

# task, normalization, elastic-net alpha, optimizer (type, max_iterations, tolerance)
CASES = [
    ("LOGISTIC_REGRESSION", "STANDARDIZATION", 0.0, ("LBFGS", 100, 1e-7)),
    ("LOGISTIC_REGRESSION", "SCALE_WITH_STANDARD_DEVIATION", 0.5, ("LBFGS", 100, 1e-7)),
    ("LINEAR_REGRESSION", "STANDARDIZATION", 0.5, ("LBFGS", 100, 1e-7)),
    ("POISSON_REGRESSION", "SCALE_WITH_STANDARD_DEVIATION", 0.0, ("TRON", 15, 1e-5)),
    ("SMOOTHED_HINGE_LOSS_LINEAR_SVM", "NONE", 0.0, ("LBFGS", 100, 1e-7)),
]


def _fit_both(task, norm, alpha, opt, *, n=300, d=8, seed=0, **kwargs):
    binary = TaskType[task].is_classification
    x, y, o, ws = make_data(seed, n, d, binary)
    if task == "POISSON_REGRESSION":
        y = np.round(y)  # counts
    jb, tb = batches(x, y, o, ws)
    jn, tn = normalizations(norm, x, intercept_index=d - 1)
    otype, iters, tol = opt
    ref = jax_train_glm(jb, JaxTask[task], optimizer=JaxConfig(JaxType[otype], iters, tol),
                        regularization_weights=LAMBDAS, elastic_net_alpha=alpha,
                        normalization=jn, intercept_index=d - 1, **kwargs)
    port = train_glm(tb, TaskType[task], optimizer=OptimizerConfig(OptimizerType[otype], iters, tol),
                     regularization_weights=LAMBDAS, elastic_net_alpha=alpha,
                     normalization=tn, intercept_index=d - 1, **kwargs)
    return ref, port, (x, y, o, ws)


@pytest.mark.parametrize("task,norm,alpha,opt", CASES, ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CASES])
def test_train_glm_matches(task, norm, alpha, opt):
    ref, port, (x, y, o, ws) = _fit_both(task, norm, alpha, opt)
    assert sorted(port) == sorted(ref) == sorted(LAMBDAS)
    for lam in LAMBDAS:
        np.testing.assert_allclose(to_np(port[lam].coefficients.means),
                                   to_np(ref[lam].coefficients.means), rtol=1e-7, atol=1e-9)
        assert port[lam].task.value == ref[lam].task.value
    if alpha > 0.0:  # the elastic-net path zeroes coefficients at the largest λ
        assert (to_np(port[50.0].coefficients.means) == 0.0).any()

    # scoring and metrics of the trained models
    xt, ot = torch.from_numpy(x), torch.from_numpy(o)
    for lam in LAMBDAS:
        m_port, m_ref = port[lam], ref[lam]
        scores = m_port.score(xt, ot)
        ref_scores = to_np(m_ref.score(jnp.asarray(x), jnp.asarray(o)))
        np.testing.assert_allclose(to_np(scores), ref_scores, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(to_np(m_port.predict(xt, ot)),
                                   to_np(m_ref.predict(jnp.asarray(x), jnp.asarray(o))),
                                   rtol=1e-7, atol=1e-9)
        if m_port.task.is_classification:
            got = local_metrics.area_under_roc_curve(scores, y, ws)
            want = jax_metrics.area_under_roc_curve(ref_scores, y, ws)
            assert 0.5 < got <= 1.0
        else:
            got = local_metrics.root_mean_squared_error(m_port.predict(xt, ot), y, ws)
            want = jax_metrics.root_mean_squared_error(
                to_np(m_ref.predict(jnp.asarray(x), jnp.asarray(o))), y, ws)
        np.testing.assert_allclose(got, want, rtol=1e-9)


def test_train_glm_box_constraints_match():
    lo, hi = np.full(8, -0.2), np.full(8, 0.3)
    ref, port, _ = _fit_both("LINEAR_REGRESSION", "NONE", 0.0, ("LBFGSB", 100, 1e-7),
                             lower_bounds=lo, upper_bounds=hi)
    for lam in LAMBDAS:
        w = to_np(port[lam].coefficients.means)
        np.testing.assert_allclose(w, to_np(ref[lam].coefficients.means), rtol=1e-7, atol=1e-9)
        assert (w >= lo - 1e-12).all() and (w <= hi + 1e-12).all()


def test_classify_matches():
    ref, port, (x, _, o, _) = _fit_both("LOGISTIC_REGRESSION", "NONE", 0.0, ("LBFGS", 100, 1e-7))
    got = port[1.0].classify(torch.from_numpy(x), torch.from_numpy(o))
    want = ref[1.0].classify(jnp.asarray(x), jnp.asarray(o))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    linear = convert.glm_from_numpy(np.zeros(3), None, JaxTask.LINEAR_REGRESSION, device="cpu")
    assert linear.task == TaskType.LINEAR_REGRESSION
    with pytest.raises(ValueError, match="classification"):
        linear.classify(torch.zeros(2, 3, dtype=torch.float64))


def test_on_solve_reports_each_lambda():
    x, y, o, ws = make_data(1, 120, 5, True)
    seen = []
    train_glm(convert.batch_from_numpy(x, y, o, ws, device="cpu"), TaskType.LOGISTIC_REGRESSION,
              regularization_weights=(5.0, 0.5), on_solve=lambda lam, r: seen.append((lam, r)))
    assert [lam for lam, _ in seen] == [0.5, 5.0]  # sorted, warm-started in order
    for _, result in seen:
        hist = to_np(result.value_history)[: result.iterations + 1]
        assert np.isfinite(hist).all() and (np.diff(hist) <= 0).all()


def test_train_glm_rejections():
    x, y, o, ws = make_data(2, 50, 4, True)
    batch = convert.batch_from_numpy(x, y, o, ws, device="cpu")
    solves = []
    with pytest.raises(ValueError, match="variance mode"):
        train_glm(batch, TaskType.LOGISTIC_REGRESSION, compute_variance=True,
                  variance_mode="exact", on_solve=lambda lam, r: solves.append(lam))
    assert solves == []  # rejected before any solve
    with pytest.raises(TypeError, match="LabeledPointBatch"):
        train_glm(object(), TaskType.LOGISTIC_REGRESSION)
    with pytest.raises(ValueError, match="box constraints"):
        train_glm(batch, TaskType.LOGISTIC_REGRESSION, elastic_net_alpha=0.5,
                  regularization_weights=(1.0,), lower_bounds=np.zeros(4))
    with pytest.raises(ValueError, match="STANDARDIZATION"):
        _, tn = normalizations("STANDARDIZATION", x, intercept_index=None)
        train_glm(batch, TaskType.LOGISTIC_REGRESSION, normalization=tn)


def test_bf16_batch_solves_in_f32():
    x, y, o, ws = make_data(3, 200, 6, True, dtype=np.float32)
    b16 = LabeledPointBatch.create(x, y, o, ws, dtype=torch.bfloat16, device="cpu")
    b32 = LabeledPointBatch.create(x, y, o, ws, device="cpu")
    m16 = train_glm(b16, TaskType.LOGISTIC_REGRESSION, regularization_weights=(1.0,))[1.0]
    m32 = train_glm(b32, TaskType.LOGISTIC_REGRESSION, regularization_weights=(1.0,))[1.0]
    assert m16.coefficients.means.dtype == torch.float32
    np.testing.assert_allclose(to_np(m16.coefficients.means), to_np(m32.coefficients.means),
                               rtol=5e-2, atol=5e-2)
