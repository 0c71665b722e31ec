"""Assemble the diagnostics into the full report tree (the port's own copy).

Counterpart of ``photon_ml_tpu/diagnostics/report_builder.py``; reference
the legacy Driver's DIAGNOSED stage (photon-client Driver.scala:608-635,
719-739) — per-λ model metrics, fitting curves, bootstrap tables,
Hosmer-Lemeshow (logistic only), Kendall-tau independence (linear only) and
feature importance, rendered by ``diagnostics/reporting.py``. The refits of
the fitting and bootstrap chapters run through the caller's training
closure on the batch's device.
"""

from __future__ import annotations

from typing import Callable, Mapping

from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.diagnostics.bootstrap import bootstrap_training
from photon_ml_torch.diagnostics.feature_importance import feature_importance
from photon_ml_torch.diagnostics.fitting import fitting_diagnostic
from photon_ml_torch.diagnostics.hosmer_lemeshow import hosmer_lemeshow
from photon_ml_torch.diagnostics.independence import kendall_tau_independence
from photon_ml_torch.diagnostics.metrics import evaluate_model
from photon_ml_torch.diagnostics.reporting import (
    Chapter,
    LineChart,
    Report,
    Section,
    Table,
    Text,
)
from photon_ml_torch.io.index_map import IndexMap
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.types import TaskType


def build_diagnostic_report(
    models: Mapping[float, GeneralizedLinearModel],
    train_batch: LabeledPointBatch,
    validation_batch: LabeledPointBatch,
    *,
    task: TaskType,
    train_fn_for_lambda: Callable[[float], Callable[[LabeledPointBatch], GeneralizedLinearModel]],
    best_lambda: float,
    index_map: IndexMap | None = None,
    num_bootstraps: int = 0,
    seed: int = 0,
    validation_metrics: Mapping[float, Mapping[str, float]] | None = None,
) -> Report:
    """Build the model-diagnostics report over a λ grid of trained models.

    ``train_fn_for_lambda(lam)`` returns a retraining closure used by the
    bootstrap and fitting diagnostics (so they retrain with the same config).
    ``validation_metrics`` reuses per-λ metrics the caller already computed.
    """
    report = Report(title=f"Photon-ML-TPU model diagnostics ({task.name})")

    # Chapter 1: metrics per λ
    metric_rows = []
    metric_names: list[str] = []
    for lam, model in sorted(models.items()):
        if validation_metrics is not None and lam in validation_metrics:
            metrics = validation_metrics[lam]
        else:
            metrics = evaluate_model(model, validation_batch)
        if not metric_names:
            metric_names = list(metrics)
        metric_rows.append([lam, *(metrics[m] for m in metric_names)])
    report.chapters.append(
        Chapter(
            title="Model summary and metrics",
            sections=[
                Section(
                    title="Validation metrics per regularization weight",
                    items=[
                        Table(headers=["lambda", *metric_names], rows=metric_rows),
                        Text(f"Selected lambda = {best_lambda:g}"),
                    ],
                )
            ],
        )
    )

    best_model = models[best_lambda]
    device = best_model.coefficients.means.device
    margins = best_model.score(validation_batch.features.to(device),
                               validation_batch.offsets.to(device))
    scores = margins.detach().cpu().numpy()
    # mean-scale predictions (probabilities for logistic, rates for Poisson)
    # so residuals labels - predictions are comparable to the labels
    predictions = best_model.mean(margins).detach().cpu().numpy()
    labels = validation_batch.labels.cpu().numpy()
    weights = validation_batch.weights.cpu().numpy()
    train_fn = train_fn_for_lambda(best_lambda)

    # Chapter 2: fit quality
    fit = fitting_diagnostic(train_fn, train_batch, validation_batch, seed=seed)
    fit_sections = []
    for metric in fit.train_metrics[0]:
        portions, train_curve, test_curve = fit.metric_curve(metric)
        fit_sections.append(
            Section(
                title=f"Learning curve: {metric}",
                items=[
                    LineChart(
                        title=f"{metric} vs training portion",
                        x=portions,
                        series={"train": train_curve, "validation": test_curve},
                        x_label="portion of training data",
                        y_label=metric,
                    )
                ],
            )
        )
    report.chapters.append(Chapter(title="Fitting diagnostic", sections=fit_sections))

    # Chapter 3: calibration + independence
    checks = Chapter(title="Error structure", sections=[])
    if task == TaskType.LOGISTIC_REGRESSION:
        hl = hosmer_lemeshow(scores, labels, weights)
        checks.sections.append(
            Section(
                title="Hosmer-Lemeshow calibration",
                items=[
                    Table(
                        headers=["p lower", "p upper", "count", "observed+", "expected+"],
                        rows=[
                            [b.lower, b.upper, b.count, b.observed_positives, b.expected_positives]
                            for b in hl.bins
                        ],
                        caption=(
                            f"chi²={hl.chi_square:.4g}, dof={hl.degrees_of_freedom}, "
                            f"p={hl.p_value:.4g} "
                            f"({'well calibrated' if hl.well_calibrated else 'MISCALIBRATED'})"
                        ),
                    )
                ],
            )
        )
    if task == TaskType.LINEAR_REGRESSION:
        # Rank correlation of prediction vs residual is only meaningful for
        # continuous residuals: with binary/count outcomes the conditional
        # error distribution is monotone in the prediction by construction,
        # so tau is biased away from 0 even for a perfect model.
        ind = kendall_tau_independence(predictions, labels, seed=seed)
        checks.sections.append(
            Section(
                title="Prediction-error independence (Kendall tau)",
                items=[
                    Text(
                        f"tau={ind.tau:.4g}, p={ind.p_value:.4g} over {ind.num_samples} "
                        f"samples ({'independent' if ind.independent else 'DEPENDENT'})"
                    )
                ],
            )
        )
    report.chapters.append(checks)

    # Chapter 4: feature importance
    imp = feature_importance(
        best_model, train_batch, kind="expected_magnitude", index_map=index_map
    )
    var_imp = feature_importance(
        best_model, train_batch, kind="variance", index_map=index_map
    )
    report.chapters.append(
        Chapter(
            title="Feature importance",
            sections=[
                Section(
                    title=f"Top features ({r.kind})",
                    items=[
                        Table(
                            headers=["rank", "feature", "importance"],
                            rows=[
                                [i + 1, fi.name, fi.importance]
                                for i, fi in enumerate(r.top(20))
                            ],
                        )
                    ],
                )
                for r in (imp, var_imp)
            ],
        )
    )

    # Chapter 5: bootstrap (optional — expensive)
    if num_bootstraps >= 2:
        boot = bootstrap_training(
            train_fn,
            train_batch,
            validation_batch,
            num_bootstraps=num_bootstraps,
            seed=seed,
        )
        unstable = boot.unstable_coefficients
        report.chapters.append(
            Chapter(
                title="Bootstrap analysis",
                sections=[
                    Section(
                        title="Metric distributions",
                        items=[
                            Table(
                                headers=["metric", "min", "q1", "median", "q3", "max", "mean", "std"],
                                rows=[
                                    [m, s.min, s.q1, s.median, s.q3, s.max, s.mean, s.std]
                                    for m, s in boot.metric_distributions.items()
                                ],
                            )
                        ],
                    ),
                    Section(
                        title="Coefficient stability",
                        items=[
                            Text(
                                f"{len(unstable)} of {len(boot.coefficient_summaries)} "
                                "coefficients have an IQR straddling zero"
                            ),
                            Table(
                                headers=["coefficient", "feature", "q1", "median", "q3"],
                                rows=[
                                    [
                                        j,
                                        (index_map.get_feature_name(j) or str(j))
                                        if index_map
                                        else str(j),
                                        boot.coefficient_summaries[j].q1,
                                        boot.coefficient_summaries[j].median,
                                        boot.coefficient_summaries[j].q3,
                                    ]
                                    for j in unstable[:20]
                                ],
                                caption="unstable coefficients (first 20)",
                            ),
                        ],
                    ),
                ],
            )
        )
    return report
