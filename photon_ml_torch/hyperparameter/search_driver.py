"""GP-driven model search over lane-batched training tournaments.

Counterpart of ``photon_ml_tpu/hyperparameter/search_driver.py``; reference
photon-lib hyperparameter/search/RandomSearch.scala:33-50 and
GaussianProcessSearch.scala drive a sequential loop of full driver fits
through EvaluationFunction.scala. This driver keeps the same ask/tell
arithmetic (a Sobol warm-up, then the GP posterior and expected
improvement) but evaluates each proposed batch of ``lane_budget``
configurations as one lane-batched tournament (``algorithm/lane_search.py``)
with the device metric of ``evaluation/sharded.py``: scores never reach the
host, only the [L] metric values do.

Overlap: the GP fit is host numpy. The port's lane loops run eagerly, so a
round's tournament has finished by the time its metrics are read; the order
of the JAX package's rounds is kept all the same (the GP is told round r-1's
results and proposes round r+1 before round r's metrics are read), so both
packages ask the same configurations under one seed (one SeedSequence
threads the Sobol scramble and the slice sampler; EI is pure).

Warm starts: each lane starts from the nearest evaluated configuration's
coefficients (unit-cube distance); round 1 starts cold at zero. The live
function-decrease stop (``OptimizerConfig.rel_function_tolerance``) lets
warm-started lanes stop early.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from photon_ml_torch.algorithm.lane_search import (
    LaneConfigs,
    evaluate_tournament_on_device,
    run_lane_tournament,
)
from photon_ml_torch.data.batch import LabeledPointBatch, compute_margins
from photon_ml_torch.evaluation.evaluators import (
    EvaluationData,
    Evaluator,
    default_evaluator_for_task,
    parse_evaluator,
)
from photon_ml_torch.evaluation.sharded import device_evaluator
from photon_ml_torch.hyperparameter.rescaling import (
    DimensionSpec,
    VectorRescaling,
)
from photon_ml_torch.hyperparameter.search import (
    GaussianProcessSearch,
    RandomSearch,
)
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.optim.optimizer import OptimizerConfig
from photon_ml_torch.telemetry.registry import default_registry
from photon_ml_torch.types import TaskType

#: dimension names the lane tournament knows how to realize
_KNOWN_DIMS = ("lambda", "alpha", "tolerance", "box")


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Named search dimensions over tournament lane configs.

    Grammar (one comma-separated term per dimension, see
    :func:`parse_search_space`)::

        lambda=1e-4:1e2:log , alpha=0:1 , tolerance=1e-9:1e-5:log , box=0:1

    ``lambda`` is required. ``alpha`` (elastic-net mix) folds into per-lane
    l1/l2 and forces an OWL-QN tournament; ``box`` (discrete 0/1) toggles
    the driver-supplied box per lane and rides projected L-BFGS — the two
    are mutually exclusive (same rule as train_glm/train_glm_grid).
    """

    dims: tuple[DimensionSpec, ...]

    def __post_init__(self):
        names = [d.name for d in self.dims]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate search dimensions: {names}")
        for n in names:
            if n not in _KNOWN_DIMS:
                raise ValueError(
                    f"unknown search dimension '{n}' (supported: "
                    f"{', '.join(_KNOWN_DIMS)})"
                )
        if "lambda" not in names:
            raise ValueError("search space needs a 'lambda' dimension")
        if "alpha" in names and "box" in names:
            raise ValueError(
                "'alpha' (OWL-QN lanes) and 'box' (projected L-BFGS lanes) "
                "cannot share a tournament"
            )

    @property
    def rescaling(self) -> VectorRescaling:
        return VectorRescaling(self.dims)

    @property
    def dim(self) -> int:
        return len(self.dims)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(d.name for d in self.dims)

    def _column(self, values: np.ndarray, name: str):
        names = self.names
        if name not in names:
            return None
        return values[..., names.index(name)]

    def config_dicts(self, unit: np.ndarray) -> list[dict[str, float]]:
        values = self.rescaling.to_hyperparameters(np.atleast_2d(unit))
        return [
            {d.name: float(values[i, j]) for j, d in enumerate(self.dims)}
            for i in range(values.shape[0])
        ]

    def lane_configs(
        self,
        unit: np.ndarray,
        *,
        default_tolerance: float,
        feature_dim: int | None = None,
        box_lower: np.ndarray | None = None,
        box_upper: np.ndarray | None = None,
    ) -> LaneConfigs:
        """Realize a [L, dim] unit-cube batch as per-lane solver vectors.

        ``box`` lanes take the driver's global (box_lower, box_upper) [d]
        arrays; box-off lanes carry ±inf rows (the per-lane no-op box —
        tournament-level bounds=None is reserved for spaces WITHOUT a box
        dimension, preserving the unprojected bitwise path)."""
        unit = np.atleast_2d(np.asarray(unit, np.float64))
        values = self.rescaling.to_hyperparameters(unit)
        lam = np.asarray(self._column(values, "lambda"), np.float64)
        alpha_col = self._column(values, "alpha")
        alpha = (
            np.zeros_like(lam) if alpha_col is None
            else np.asarray(alpha_col, np.float64)
        )
        tol_col = self._column(values, "tolerance")
        tol = (
            np.full_like(lam, float(default_tolerance)) if tol_col is None
            else np.asarray(tol_col, np.float64)
        )
        lower = upper = None
        box_col = self._column(values, "box")
        if box_col is not None:
            if box_lower is None or box_upper is None or feature_dim is None:
                raise ValueError(
                    "a 'box' search dimension needs feature_dim plus the "
                    "box_lower/box_upper [d] arrays to toggle per lane"
                )
            on = np.asarray(box_col, np.float64) > 0.5
            lower = np.where(
                on[:, None],
                np.asarray(box_lower, np.float64)[None, :],
                -np.inf,
            )
            upper = np.where(
                on[:, None],
                np.asarray(box_upper, np.float64)[None, :],
                np.inf,
            )
        return LaneConfigs(
            l2=(1.0 - alpha) * lam,
            l1=alpha * lam,
            tolerance=tol,
            lower_bounds=lower,
            upper_bounds=upper,
        )


def parse_search_space(spec: str) -> SearchSpace:
    """Parse the CLI grammar: ``name=low:high[:log][:int]``, comma-separated.

    ``log`` selects log-scale interpolation (regularization weights,
    tolerances); ``int`` snaps to integers (the 'box' toggle). Example::

        lambda=1e-4:1e2:log,alpha=0:1,tolerance=1e-9:1e-5:log
    """
    dims = []
    for term in spec.split(","):
        term = term.strip()
        if not term:
            continue
        if "=" not in term:
            raise ValueError(
                f"bad search-space term '{term}' (want name=low:high[:log][:int])"
            )
        name, rng = term.split("=", 1)
        parts = rng.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"bad search-space range '{rng}' for '{name}' "
                "(want low:high[:log][:int])"
            )
        flags = {p.strip().lower() for p in parts[2:]}
        bad = flags - {"log", "int"}
        if bad:
            raise ValueError(
                f"unknown search-space flags {sorted(bad)} for '{name}'"
            )
        name = name.strip()
        discrete = "int" in flags or name == "box"
        dims.append(DimensionSpec(
            name=name,
            low=float(parts[0]), high=float(parts[1]),
            log_scale="log" in flags, discrete=discrete,
        ))
    return SearchSpace(dims=tuple(dims))


@dataclasses.dataclass
class SearchOutcome:
    """One finished tournament search."""

    best_model: GeneralizedLinearModel
    best_config: dict[str, float]
    best_metric: float
    evaluator_name: str
    #: one record a round
    trajectory: list[dict]
    #: every (unit-cube candidate, metric value) in evaluation order
    observations: list[tuple[np.ndarray, float]]


def _nearest_warm_starts(
    round_units: np.ndarray,
    evaluated_units: list[np.ndarray],
    evaluated_coeffs: list[np.ndarray],
) -> tuple[np.ndarray | None, int]:
    """Per-lane warm starts from the nearest EVALUATED config by unit-cube
    (rescaled) distance; (None, 0) on the round-1 cold case — the tournament
    then starts every lane at zero, never at uninitialized memory. A GP
    proposal outside the evaluated hull still has a well-defined nearest
    neighbor, so no lane ever inherits an unevaluated config's garbage."""
    if not evaluated_units:
        return None, 0
    e = np.stack(evaluated_units)
    c = np.stack(evaluated_coeffs)
    d2 = np.sum(
        (round_units[:, None, :] - e[None, :, :]) ** 2, axis=-1
    )
    nearest = np.argmin(d2, axis=1)
    return c[nearest], len(nearest)


def _make_searcher(kind: str, dim: int, seed, *, candidate_pool: int,
                   min_observations: int) -> RandomSearch:
    if kind == "gp":
        return GaussianProcessSearch(
            dim, seed=seed, candidate_pool=candidate_pool,
            min_observations=min_observations,
        )
    if kind == "sobol":
        return RandomSearch(dim, seed=seed)
    raise ValueError(f"unknown searcher '{kind}' (want 'gp' or 'sobol')")


def run_model_search(
    batch: LabeledPointBatch,
    val_batch: LabeledPointBatch,
    task: TaskType,
    space: SearchSpace,
    *,
    rounds: int,
    lane_budget: int,
    optimizer: OptimizerConfig | None = None,
    seed: int = 0,
    searcher: str = "gp",
    evaluator: "Evaluator | str | None" = None,
    normalization=None,
    intercept_index: int | None = None,
    box_lower: np.ndarray | None = None,
    box_upper: np.ndarray | None = None,
    candidate_pool: int = 250,
    min_observations: int = 3,
    journal=None,
    registry=None,
    telemetry=None,
) -> SearchOutcome:
    """Ask/tell tournament search: ``rounds`` rounds of ``lane_budget``
    configs, each round one lane-batched solve and one device metric per lane.

    ``journal``: a ``telemetry.RunJournal`` that gets a ``search_round``
    row a round, a ``search_complete`` row, or a ``search_failure`` row
    before an error propagates. ``registry``: the port's MetricsRegistry
    (default: the process default) for the ``search/*`` counters and
    gauges. Deterministic under a fixed ``seed``.
    """
    if rounds < 1 or lane_budget < 1:
        raise ValueError(
            f"need rounds >= 1 and lane_budget >= 1, got {rounds}/{lane_budget}"
        )
    optimizer = optimizer or OptimizerConfig()
    registry = registry if registry is not None else default_registry()
    if evaluator is None:
        evaluator = default_evaluator_for_task(task)
    elif isinstance(evaluator, str):
        evaluator = parse_evaluator(evaluator)
    sign = -1.0 if evaluator.larger_is_better else 1.0

    eval_data = EvaluationData(
        labels=val_batch.labels.double().cpu().numpy(),
        offsets=val_batch.offsets.double().cpu().numpy(),
        weights=val_batch.weights.double().cpu().numpy(),
    )
    dev = device_evaluator(evaluator, eval_data, device=val_batch.device)
    if dev is None:
        raise ValueError(
            f"evaluator {evaluator.name} has no device form; tournament "
            "metrics must reduce on the device (evaluation/sharded.py)"
        )

    # one objective serves the solve AND the metric program (its
    # normalization maps lanes to model space on device)
    from photon_ml_torch.estimators import _objective_for_batch
    from photon_ml_torch.ops.losses import loss_for_task

    objective = _objective_for_batch(
        batch, loss_for_task(task), 0.0, normalization
    )

    # ONE SeedSequence is the searcher's whole entropy source (Sobol
    # scramble + slice sampler; EI is pure) — int-seeded searchers keep
    # the legacy tuner derivation instead, so pass the sequence explicitly
    engine = _make_searcher(
        searcher, space.dim, np.random.SeedSequence(seed),
        candidate_pool=candidate_pool, min_observations=min_observations,
    )

    evaluated_units: list[np.ndarray] = []
    evaluated_coeffs: list[np.ndarray] = []
    observations: list[tuple[np.ndarray, float]] = []
    pending: list[tuple[np.ndarray, float]] = []
    trajectory: list[dict] = []
    best_metric = float("nan")
    best_model = None
    best_config: dict[str, float] = {}
    best_unit = None

    c_rounds = registry.counter("search/rounds")
    c_configs = registry.counter("search/configs_evaluated")
    c_gp = registry.counter("search/gp_proposal_rounds")
    c_sobol = registry.counter("search/sobol_proposal_rounds")
    c_warm = registry.counter("search/warm_start_lanes")
    c_cold = registry.counter("search/cold_start_lanes")

    round_units = engine.draw_candidates(lane_budget)  # Sobol warmup round
    source = "sobol"
    try:
        for rnd in range(rounds):
            configs = space.lane_configs(
                round_units,
                default_tolerance=optimizer.tolerance,
                feature_dim=batch.dim,
                box_lower=box_lower, box_upper=box_upper,
            )
            warm, _ = _nearest_warm_starts(
                round_units, evaluated_units, evaluated_coeffs
            )
            warm_lanes = lane_budget if warm is not None else 0
            c_warm.inc(warm_lanes)
            c_cold.inc(lane_budget - warm_lanes)
            t0 = time.perf_counter()
            tournament = run_lane_tournament(
                batch, task, configs,
                optimizer=optimizer, warm_start=warm,
                normalization=normalization,
                intercept_index=intercept_index,
                telemetry=telemetry,
            )
            metrics_dev = evaluate_tournament_on_device(
                objective, dev.compute, val_batch,
                tournament.results.coefficients, dev.consts,
                intercept_index,
            )
            # --- tell the GP round r-1's results and propose round r+1
            # before reading round r's metrics (the JAX package's order) ---
            next_units = None
            next_source = source
            gp_ms = 0.0
            if rnd + 1 < rounds:
                t_gp = time.perf_counter()
                for u, m in pending:
                    engine.observe(u, sign * m)
                pending = []
                next_units = engine.propose_batch(lane_budget)
                next_source = engine.last_proposal_source
                gp_ms = (time.perf_counter() - t_gp) * 1e3
            # --- sync point: [L] scalars + lane coefficients to host ---
            metrics = metrics_dev.double().cpu().numpy()
            coeffs = tournament.results.coefficients.cpu().numpy()
            round_ms = (time.perf_counter() - t0) * 1e3
            cfg_dicts = space.config_dicts(round_units)
            for i in range(lane_budget):
                u = np.array(round_units[i], np.float64)
                m = float(metrics[i])
                evaluated_units.append(u)
                evaluated_coeffs.append(coeffs[i])
                observations.append((u, m))
                pending.append((u, m))
                if not np.isnan(m) and evaluator.better_than(m, best_metric):
                    best_metric = m
                    best_model = tournament.models[i]
                    best_config = cfg_dicts[i]
                    best_unit = u
            c_rounds.inc()
            c_configs.inc(lane_budget)
            (c_gp if source == "gp" else c_sobol).inc()
            registry.gauge("search/best_metric").set(best_metric)
            row = {
                "round": rnd,
                "source": source,
                "lanes": lane_budget,
                "warm_lanes": warm_lanes,
                "round_ms": round_ms,
                "gp_overlap_ms": gp_ms,
                "best_metric": best_metric,
                "round_best": float(np.nanmax(metrics) if
                                    evaluator.larger_is_better
                                    else np.nanmin(metrics)),
                "metric": evaluator.name,
            }
            trajectory.append(row)
            if journal is not None:
                journal.record("search_round", **row)
            if next_units is not None:
                round_units = next_units
                source = next_source
    except Exception as exc:
        if journal is not None:
            journal.record("search_failure", round=len(trajectory),
                           error=f"{type(exc).__name__}: {exc}")
        raise
    if best_model is None:
        raise ValueError(
            f"search produced no finite {evaluator.name} over "
            f"{rounds * lane_budget} configs"
        )
    out = SearchOutcome(
        best_model=best_model,
        best_config=best_config,
        best_metric=best_metric,
        evaluator_name=evaluator.name,
        trajectory=trajectory,
        observations=observations,
    )
    if journal is not None:
        journal.record("search_complete", configs=len(observations), best_metric=best_metric,
                       best_config=best_config, metric=evaluator.name)
    return out


def host_metric_for_model(
    model: GeneralizedLinearModel,
    val_batch: LabeledPointBatch,
    evaluator: Evaluator,
) -> float:
    """Host-side cross-check of a selected model: same margins, the exact
    host evaluator (tests pin device == host on the winner)."""
    scores = compute_margins(val_batch, model.coefficients.means).double().cpu().numpy()
    data = EvaluationData(
        labels=val_batch.labels.double().cpu().numpy(),
        offsets=val_batch.offsets.double().cpu().numpy(),
        weights=val_batch.weights.double().cpu().numpy(),
    )
    return float(evaluator.evaluate(scores, data))
