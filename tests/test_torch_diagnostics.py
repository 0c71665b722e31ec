"""The port's diagnostics (``photon_ml_torch/diagnostics``) against the JAX
package's on the same numpy fixtures, in float64 on the CPU.

The host statistics (Hosmer-Lemeshow bins, Kendall's tau, coefficient
summaries, feature importance) take the same inputs in both packages and
hold at rel 1e-10. The bootstrap and fitting diagnostics draw their
resamples from the same ``np.random.default_rng(seed)`` and refit through
each package's own ``train_glm``, so they hold at rel 1e-6. The renderers
are held byte for byte on report trees of the same content.
"""

import importlib

import numpy as np
import pytest

from photon_ml_torch import convert
from photon_ml_torch.diagnostics import bootstrap as t_boot
from photon_ml_torch.diagnostics import fitting as t_fit
from photon_ml_torch.diagnostics import independence as t_ind
from photon_ml_torch.diagnostics import report_builder as t_rb
from photon_ml_torch.diagnostics import reporting as t_rep
from photon_ml_torch.diagnostics.summary import CoefficientSummary as TSummary
from photon_ml_torch.estimators import train_glm as t_train_glm
from photon_ml_torch.optim.optimizer import OptimizerConfig as TOpt
from photon_ml_torch.types import TaskType as TTask
from photon_ml_tpu.diagnostics import bootstrap as j_boot
from photon_ml_tpu.diagnostics import fitting as j_fit
from photon_ml_tpu.diagnostics import independence as j_ind
from photon_ml_tpu.diagnostics import report_builder as j_rb
from photon_ml_tpu.diagnostics import reporting as j_rep
from photon_ml_tpu.diagnostics.summary import CoefficientSummary as JSummary
from photon_ml_tpu.estimators import train_glm as j_train_glm
from photon_ml_tpu.optim.optimizer import OptimizerConfig as JOpt
from photon_ml_tpu.types import TaskType as JTask
from tests import torch_parity as P

# the package namespaces re-export functions of these modules' names
t_imp = importlib.import_module("photon_ml_torch.diagnostics.feature_importance")
t_hl = importlib.import_module("photon_ml_torch.diagnostics.hosmer_lemeshow")
j_imp = importlib.import_module("photon_ml_tpu.diagnostics.feature_importance")
j_hl = importlib.import_module("photon_ml_tpu.diagnostics.hosmer_lemeshow")

LAMBDA = 0.5
ITERS = 100
TOL = 1e-10


def _data(seed: int, binary: bool, n: int = 480, d: int = 6):
    x, y, offsets, weights = P.make_data(seed, n, d, binary, zero_weight_every=0)
    cut = n * 3 // 4
    train = P.batches(x[:cut], y[:cut], offsets[:cut], weights[:cut])
    val = P.batches(x[cut:], y[cut:], offsets[cut:], weights[cut:])
    return train, val


@pytest.fixture(scope="module")
def logistic():
    return _data(0, True)


@pytest.fixture(scope="module")
def linear():
    return _data(1, False)


def _train_fns(task: str):
    def jfn(batch):
        return j_train_glm(batch, JTask[task], optimizer=JOpt(max_iterations=ITERS, tolerance=TOL),
                           regularization_weights=(LAMBDA,))[LAMBDA]

    def tfn(batch):
        return t_train_glm(batch, TTask[task], optimizer=TOpt(max_iterations=ITERS, tolerance=TOL),
                           regularization_weights=(LAMBDA,))[LAMBDA]

    return jfn, tfn


def _close(a, b, rtol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=rtol * max(1.0, float(np.abs(b).max(initial=0))))


def _fields(obj) -> dict:
    return {k: getattr(obj, k) for k in ("min", "q1", "median", "q3", "max", "mean", "std")}


@pytest.mark.parametrize("num_bins,probabilities", [(10, False), (5, False), (10, True)])
def test_hosmer_lemeshow_matches(num_bins, probabilities):
    """Bins, statistic, degrees of freedom and p-value at rel 1e-10."""
    rng = np.random.default_rng(3)
    scores = rng.normal(size=500) * 2.0
    if probabilities:
        scores = 1.0 / (1.0 + np.exp(-scores))
    labels = (rng.uniform(size=500) < 0.4).astype(np.float64)
    weights = rng.uniform(0.5, 2.0, size=500)
    kw = dict(num_bins=num_bins, scores_are_probabilities=probabilities)
    j = j_hl.hosmer_lemeshow(scores, labels, weights, **kw)
    t = t_hl.hosmer_lemeshow(scores, labels, weights, **kw)
    assert len(t.bins) == len(j.bins) and t.degrees_of_freedom == j.degrees_of_freedom
    for tb, jb in zip(t.bins, j.bins):
        _close([tb.lower, tb.upper, tb.count, tb.observed_positives, tb.expected_positives],
               [jb.lower, jb.upper, jb.count, jb.observed_positives, jb.expected_positives],
               1e-10)
    _close([t.chi_square, t.p_value], [j.chi_square, j.p_value], 1e-10)
    assert t.well_calibrated == j.well_calibrated


@pytest.mark.parametrize("n,max_samples", [(400, 5000), (900, 300)])
def test_kendall_tau_and_coefficient_summary_match(n, max_samples):
    """Kendall's tau (with and without the subsample draw) and the
    coefficient summary of the same samples, rel 1e-10."""
    rng = np.random.default_rng(n)
    scores, labels = rng.normal(size=n), rng.normal(size=n)
    j = j_ind.kendall_tau_independence(scores, labels, max_samples=max_samples, seed=5)
    t = t_ind.kendall_tau_independence(scores, labels, max_samples=max_samples, seed=5)
    _close([t.tau, t.p_value], [j.tau, j.p_value], 1e-10)
    assert t.num_samples == j.num_samples and t.independent == j.independent
    samples = rng.normal(size=37)
    js, ts = JSummary.from_samples(samples), TSummary.from_samples(samples)
    _close(list(_fields(ts).values()), list(_fields(js).values()), 1e-10)
    assert ts.straddles_zero() == js.straddles_zero()


@pytest.mark.parametrize("kind", ["expected_magnitude", "variance"])
def test_feature_importance_matches(logistic, kind):
    """Both kinds rank the same features with importances at rel 1e-10, on
    the same coefficients over the same batch."""
    (jb, tb), _ = logistic
    means = np.random.default_rng(11).normal(size=jb.dim)
    from photon_ml_tpu.models.coefficients import Coefficients as JCoef
    from photon_ml_tpu.models.glm import GeneralizedLinearModel as JGLM

    jm = JGLM(JCoef(means=means), JTask.LOGISTIC_REGRESSION)
    tm = convert.glm_from_numpy(means, None, "LOGISTIC_REGRESSION", device="cpu")
    j = j_imp.feature_importance(jm, jb, kind=kind)
    t = t_imp.feature_importance(tm, tb, kind=kind)
    assert t.kind == j.kind
    assert [f.index for f in t.ranked] == [f.index for f in j.ranked]
    assert [f.name for f in t.ranked] == [f.name for f in j.ranked]
    _close([f.importance for f in t.ranked], [f.importance for f in j.ranked], 1e-10)


@pytest.mark.parametrize("task,seed", [("LOGISTIC_REGRESSION", 0), ("LINEAR_REGRESSION", 4)])
def test_bootstrap_matches(logistic, linear, task, seed):
    """The same multinomial draws refit by each package's train_glm:
    every coefficient and metric summary at rel 1e-6, the same unstable
    coefficients."""
    (jb, tb), (jv, tv) = logistic if task == "LOGISTIC_REGRESSION" else linear
    jfn, tfn = _train_fns(task)
    j = j_boot.bootstrap_training(jfn, jb, jv, num_bootstraps=3, seed=seed)
    t = t_boot.bootstrap_training(tfn, tb, tv, num_bootstraps=3, seed=seed)
    assert t.num_samples == j.num_samples == 3
    for ts, js in zip(t.coefficient_summaries, j.coefficient_summaries, strict=True):
        _close(list(_fields(ts).values()), list(_fields(js).values()), 1e-6)
    assert list(t.metric_distributions) == list(j.metric_distributions)
    for name, js in j.metric_distributions.items():
        _close(list(_fields(t.metric_distributions[name]).values()), list(_fields(js).values()),
               1e-6)
    assert t.unstable_coefficients == j.unstable_coefficients


def test_bootstrap_needs_two_rounds(logistic):
    (_, tb), (_, tv) = logistic
    with pytest.raises(ValueError, match="at least 2"):
        t_boot.bootstrap_training(_train_fns("LOGISTIC_REGRESSION")[1], tb, tv, num_bootstraps=1)


@pytest.mark.parametrize("portions", [t_fit.DEFAULT_PORTIONS, (0.3, 1.0)])
def test_fitting_matches(logistic, portions):
    """The same shuffled prefixes refit by each package: train and held-out
    metrics per portion at rel 1e-6; a portion outside (0, 1] raises."""
    (jb, tb), (jv, tv) = logistic
    jfn, tfn = _train_fns("LOGISTIC_REGRESSION")
    j = j_fit.fitting_diagnostic(jfn, jb, jv, portions=portions, seed=2)
    t = t_fit.fitting_diagnostic(tfn, tb, tv, portions=portions, seed=2)
    assert t.portions == j.portions
    for metric in j.train_metrics[0]:
        _, t_train, t_test = t.metric_curve(metric)
        _, j_train, j_test = j.metric_curve(metric)
        _close(t_train, j_train, 1e-6)
        _close(t_test, j_test, 1e-6)
    with pytest.raises(ValueError, match="portion"):
        t_fit.fitting_diagnostic(tfn, tb, tv, portions=(0.0,))


def _tree(rep):
    """One report's content built from either package's classes."""
    return rep.Report(title="Diagnostics <LOGISTIC & co>", chapters=[
        rep.Chapter(title="Metrics", sections=[rep.Section(title="Per λ", items=[
            rep.Table(headers=["lambda", "AUC", "name"],
                      rows=[[0.1, 0.8123456789, "a<b"], [10.0, float("nan"), 3]],
                      caption="validation & more"),
            rep.Text("Selected lambda = 0.1"),
        ])]),
        rep.Chapter(title="Curves", sections=[rep.Section(title="Learning curve", items=[
            rep.LineChart(title="AUC vs portion", x=[0.125, 0.5, 1.0],
                          series={"train": [0.9, 0.85, float("nan")],
                                  "validation": [0.7, 0.75, 0.8]},
                          x_label="portion", y_label="AUC"),
            rep.LineChart(title="empty", x=[], series={}),
            rep.Table(headers=["h"], rows=[]),
        ])]),
    ])


def test_renderers_are_byte_equal():
    """render_text and render_html of the same report content: the port's
    bytes are the JAX package's."""
    j, t = _tree(j_rep), _tree(t_rep)
    assert t_rep.render_text(t).encode() == j_rep.render_text(j).encode()
    assert t_rep.render_html(t).encode() == j_rep.render_html(j).encode()


def _shape(report) -> list:
    """The report's structure: titles, item kinds and table headers and
    sizes, without the values."""
    out = [report.title]
    for c in report.chapters:
        for s in c.sections:
            for item in s.items:
                kind = type(item).__name__
                extra = ((list(item.headers), len(item.rows)) if kind == "Table"
                         else list(item.series) if kind == "LineChart" else None)
                out.append((c.title, s.title, kind, extra))
    return out


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION"])
def test_build_diagnostic_report_matches(logistic, linear, task):
    """The whole report over a two-λ grid with bootstraps: the same chapters,
    sections, items and table shapes as the JAX package's; its validation
    metric table at rel 1e-6."""
    (jb, tb), (jv, tv) = logistic if task == "LOGISTIC_REGRESSION" else linear
    lams = (0.5, 5.0)
    opt_j, opt_t = JOpt(max_iterations=ITERS, tolerance=TOL), TOpt(max_iterations=ITERS,
                                                                   tolerance=TOL)
    jmodels = j_train_glm(jb, JTask[task], optimizer=opt_j, regularization_weights=lams)
    tmodels = t_train_glm(tb, TTask[task], optimizer=opt_t, regularization_weights=lams)

    def jfn(lam):
        return lambda b: j_train_glm(b, JTask[task], optimizer=opt_j,
                                     regularization_weights=(lam,))[lam]

    def tfn(lam):
        return lambda b: t_train_glm(b, TTask[task], optimizer=opt_t,
                                     regularization_weights=(lam,))[lam]

    j = j_rb.build_diagnostic_report(jmodels, jb, jv, task=JTask[task], train_fn_for_lambda=jfn,
                                     best_lambda=0.5, num_bootstraps=2, seed=1)
    t = t_rb.build_diagnostic_report(tmodels, tb, tv, task=TTask[task], train_fn_for_lambda=tfn,
                                     best_lambda=0.5, num_bootstraps=2, seed=1)
    assert _shape(t) == _shape(j)
    jt, tt = j.chapters[0].sections[0].items[0], t.chapters[0].sections[0].items[0]
    _close(np.asarray(tt.rows, np.float64), np.asarray(jt.rows, np.float64), 1e-6)
