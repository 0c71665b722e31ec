"""Typed driver configuration + the k=v,k=v CLI grammar (the port's copy).

Counterpart of ``photon_ml_tpu/cli/configs.py``: the same grammar, nouns and
defaults, mapped onto the port's estimator configurations. Reference parity: photon-client io/scopt/ScoptParserHelpers.scala:43-101,
155-200 — composite key-value grammar for coordinate and feature-shard
configurations ("name=X,feature.shard=Y,reg.weights=0.1|1|10"), photon-client
io/CoordinateConfiguration.scala (data config + opt config + reg-weight
grid, expandOptimizationConfigurations), io/FeatureShardConfiguration.scala,
and ModelOutputMode {NONE, BEST, EXPLICIT, TUNED, ALL}.

The reference wraps spark.ml Params in scopt; here plain dataclasses +
argparse carry the same nouns, and `expand_reg_weight_grid` reproduces the
cartesian grid fold of GameTrainingDriver.scala:612-621.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Mapping, Sequence

from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
from photon_ml_torch.estimators import (
    FixedEffectCoordinateConfig,
    MatrixFactorizationCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_ml_torch.io.data_reader import FeatureShardConfiguration
from photon_ml_torch.ops.variance import validate_variance_mode
from photon_ml_torch.optim.optimizer import (
    LaneSchedulerConfig,
    OptimizerConfig,
    OptimizerType,
)
from photon_ml_torch.projector.projectors import ProjectorType  # noqa: F401 (re-exported)


class ModelOutputMode(enum.Enum):
    """Reference: io/ModelOutputMode.scala — NONE (logs only), BEST (best
    model only), EXPLICIT (best + the explicit λ-grid models), TUNED (best +
    hyperparameter-tuning models), ALL (everything)."""

    NONE = "NONE"
    BEST = "BEST"
    EXPLICIT = "EXPLICIT"
    TUNED = "TUNED"
    ALL = "ALL"


LIST_SEP = "|"


def parse_kv_list(spec: str) -> dict[str, str]:
    """Parse "k1=v1,k2=v2" into a dict (list values use '|' separators,
    reference ScoptParserHelpers' composite grammar)."""
    out: dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, eq, value = part.partition("=")
        if not eq:
            raise ValueError(f"expected key=value, got {part!r} in {spec!r}")
        key = key.strip()
        if key in out:
            raise ValueError(f"duplicate key {key!r} in {spec!r}")
        out[key] = value.strip()
    return out


def _bool(s: str) -> bool:
    if s.lower() in ("true", "1", "yes"):
        return True
    if s.lower() in ("false", "0", "no"):
        return False
    raise ValueError(f"expected boolean, got {s!r}")


def parse_feature_shard_config(spec: str) -> tuple[str, FeatureShardConfiguration]:
    """"name=global,feature.bags=features|userFeatures,intercept=true"."""
    kv = parse_kv_list(spec)
    try:
        name = kv.pop("name")
        bags = tuple(b for b in kv.pop("feature.bags").split(LIST_SEP) if b)
    except KeyError as e:
        raise ValueError(f"feature shard config missing {e} in {spec!r}") from None
    intercept = _bool(kv.pop("intercept", "true"))
    sparse = _bool(kv.pop("sparse", "false"))
    pre_indexed = _bool(kv.pop("pre.indexed", "false"))
    dimension = kv.pop("dimension", None)
    # hybrid dense-head/sparse-tail layout (sparse shards only)
    hybrid = _bool(kv.pop("hybrid", "false"))
    hybrid_hot_cols = kv.pop("hybrid.hot.cols", None)
    hybrid_coverage = kv.pop("hybrid.coverage", None)
    # dtype=bf16 halves the dense block's device memory and the bytes each
    # evaluation reads; accepted aliases follow common usage
    dtype_aliases = {
        "f32": "float32", "float32": "float32", "fp32": "float32",
        "bf16": "bfloat16", "bfloat16": "bfloat16",
    }
    raw_dtype = kv.pop("dtype", "float32").lower()
    if raw_dtype not in dtype_aliases:
        raise ValueError(
            f"unknown feature shard dtype {raw_dtype!r} in {spec!r} "
            f"(expected one of {sorted(dtype_aliases)})"
        )
    if kv:
        raise ValueError(f"unknown feature shard keys {sorted(kv)} in {spec!r}")
    if pre_indexed and dimension is None:
        raise ValueError(
            f"pre.indexed=true requires dimension=N in {spec!r}"
        )
    return name, FeatureShardConfiguration(
        feature_bags=bags, has_intercept=intercept, sparse=sparse,
        pre_indexed=pre_indexed,
        dimension=None if dimension is None else int(dimension),
        dtype=dtype_aliases[raw_dtype],
        hybrid=hybrid,
        hybrid_hot_cols=(
            None if hybrid_hot_cols is None else int(hybrid_hot_cols)
        ),
        hybrid_coverage=(
            None if hybrid_coverage is None else float(hybrid_coverage)
        ),
    )


@dataclasses.dataclass(frozen=True)
class CoordinateCliConfig:
    """One coordinate's full CLI configuration (reference
    io/CoordinateConfiguration.scala: data config + opt config + λ grid)."""

    name: str
    feature_shard: str
    #: LBFGS (default) | OWLQN | LBFGSB | TRON (the reference's set,
    #: OptimizerType.scala) | NEWTON (batched small-d solver,
    #: optim/newton.py — the fast choice for RE/MF coordinates)
    optimizer: OptimizerType = OptimizerType.LBFGS
    max_iterations: int = 100
    tolerance: float = 1e-7
    #: live function-decrease stop (optim/common.check_convergence): the
    #: knob that lets warm-started vmapped lanes exit before max_iter.
    #: None keeps the reference behavior (the plain tolerance)
    rel_function_tolerance: float | None = None
    #: TRON inner CG cap (giant-d solves budget device time with a short
    #: CG ladder; ignored by other optimizers)
    max_cg_iterations: int = 20
    reg_weights: tuple[float, ...] = (0.0,)
    reg_alpha: float = 0.0  # elastic-net: fraction of λ on L1
    down_sampling_rate: float = 1.0
    compute_variance: bool = False
    variance_mode: str = "auto"  # "auto" | "full" | "diagonal"
    # random-effect only
    random_effect_type: str | None = None
    active_data_lower_bound: int | None = None
    active_data_upper_bound: int | None = None
    projector: ProjectorType = ProjectorType.IDENTITY
    projected_dim: int | None = None
    features_to_samples_ratio: float | None = None
    #: probe/rescue lane scheduling for the vmapped per-entity solves
    #: (algorithm/lane_scheduler.py); strictly opt-in — off is
    #: bitwise-identical to the unscheduled path
    scheduler: bool = False
    scheduler_probe_iterations: int = 2
    #: cross-sweep active sets: entities whose relative coefficient delta
    #: AND gradient norm fall below these after a sweep are frozen (skipped
    #: by later sweeps, still rescored; final sweep runs everyone). Both
    #: must be > 0 to freeze anything.
    scheduler_freeze_tolerance: float = 0.0
    scheduler_freeze_gradient: float = 0.0
    # matrix-factorization only (feature_shard is unused: the "features" of
    # an MF coordinate are the other side's latent factors)
    mf_row_effect_type: str | None = None
    mf_col_effect_type: str | None = None
    mf_latent_factors: int = 0
    mf_alternations: int = 2

    @property
    def is_random_effect(self) -> bool:
        return self.random_effect_type is not None

    @property
    def is_matrix_factorization(self) -> bool:
        return self.mf_row_effect_type is not None

    def optimization_config(self, reg_weight: float) -> CoordinateOptimizationConfig:
        l1 = self.reg_alpha * reg_weight
        l2 = (1.0 - self.reg_alpha) * reg_weight
        return CoordinateOptimizationConfig(
            optimizer=OptimizerConfig(
                optimizer_type=self.optimizer,
                max_iterations=self.max_iterations,
                tolerance=self.tolerance,
                rel_function_tolerance=self.rel_function_tolerance,
                max_cg_iterations=self.max_cg_iterations,
                scheduler=LaneSchedulerConfig(
                    probe_iterations=self.scheduler_probe_iterations,
                    freeze_coefficient_tolerance=self.scheduler_freeze_tolerance,
                    freeze_gradient_tolerance=self.scheduler_freeze_gradient,
                ) if self.scheduler else None,
            ),
            l2_weight=l2,
            l1_weight=l1,
            compute_variance=self.compute_variance,
            variance_mode=self.variance_mode,
            down_sampling_rate=self.down_sampling_rate,
        )

    def estimator_config(self, reg_weight: float):
        if self.is_matrix_factorization:
            return MatrixFactorizationCoordinateConfig(
                row_effect_type=self.mf_row_effect_type,
                col_effect_type=self.mf_col_effect_type,
                num_latent_factors=self.mf_latent_factors,
                optimization=self.optimization_config(reg_weight),
                num_alternations=self.mf_alternations,
                active_data_upper_bound=self.active_data_upper_bound,
            )
        if self.is_random_effect:
            return RandomEffectCoordinateConfig(
                random_effect_type=self.random_effect_type,
                feature_shard_id=self.feature_shard,
                optimization=self.optimization_config(reg_weight),
                active_data_lower_bound=self.active_data_lower_bound,
                active_data_upper_bound=self.active_data_upper_bound,
                projector_type=self.projector,
                projected_dim=self.projected_dim,
                features_to_samples_ratio=self.features_to_samples_ratio,
            )
        return FixedEffectCoordinateConfig(
            feature_shard_id=self.feature_shard,
            optimization=self.optimization_config(reg_weight),
        )


_CLI_DEFAULTS = {
    f.name: f.default for f in dataclasses.fields(CoordinateCliConfig)
}


def format_coordinate_config(cfg: CoordinateCliConfig) -> str:
    """Render a config back to its CLI spec string (reference ScoptParameter
    print-round-trip: parse(format(cfg)) == cfg). Only non-default fields
    are emitted; defaults come from the dataclass itself so the round-trip
    stays exact if CoordinateCliConfig's defaults ever change."""
    d = _CLI_DEFAULTS
    parts = [f"name={cfg.name}"]
    if cfg.feature_shard:
        parts.append(f"feature.shard={cfg.feature_shard}")
    if cfg.optimizer != d["optimizer"]:
        parts.append(f"optimizer={cfg.optimizer.value}")
    if cfg.max_iterations != d["max_iterations"]:
        parts.append(f"max.iter={cfg.max_iterations}")
    if cfg.tolerance != d["tolerance"]:
        parts.append(f"tolerance={cfg.tolerance!r}")
    if cfg.rel_function_tolerance is not None:
        parts.append(f"rel.function.tolerance={cfg.rel_function_tolerance!r}")
    if cfg.max_cg_iterations != d["max_cg_iterations"]:
        parts.append(f"max.cg.iter={cfg.max_cg_iterations}")
    if cfg.reg_weights != d["reg_weights"]:
        parts.append(
            "reg.weights=" + LIST_SEP.join(repr(w) for w in cfg.reg_weights)
        )
    if cfg.reg_alpha != d["reg_alpha"]:
        parts.append(f"reg.alpha={cfg.reg_alpha!r}")
    if cfg.down_sampling_rate != d["down_sampling_rate"]:
        parts.append(f"down.sampling.rate={cfg.down_sampling_rate!r}")
    if cfg.compute_variance != d["compute_variance"]:
        parts.append("variance=true")
    if cfg.variance_mode != d["variance_mode"]:
        parts.append(f"variance.mode={cfg.variance_mode}")
    if cfg.random_effect_type:
        parts.append(f"random.effect.type={cfg.random_effect_type}")
    if cfg.active_data_lower_bound is not None:
        parts.append(f"active.data.lower.bound={cfg.active_data_lower_bound}")
    if cfg.active_data_upper_bound is not None:
        parts.append(f"active.data.upper.bound={cfg.active_data_upper_bound}")
    if cfg.projector != d["projector"]:
        parts.append(f"projector={cfg.projector.value}")
    if cfg.projected_dim is not None:
        parts.append(f"projected.dim={cfg.projected_dim}")
    if cfg.features_to_samples_ratio is not None:
        parts.append(f"features.to.samples.ratio={cfg.features_to_samples_ratio!r}")
    if cfg.scheduler != d["scheduler"]:
        parts.append("scheduler=true")
    if cfg.scheduler_probe_iterations != d["scheduler_probe_iterations"]:
        parts.append(f"scheduler.probe.iter={cfg.scheduler_probe_iterations}")
    if cfg.scheduler_freeze_tolerance != d["scheduler_freeze_tolerance"]:
        parts.append(
            f"scheduler.freeze.tolerance={cfg.scheduler_freeze_tolerance!r}"
        )
    if cfg.scheduler_freeze_gradient != d["scheduler_freeze_gradient"]:
        parts.append(
            f"scheduler.freeze.gradient={cfg.scheduler_freeze_gradient!r}"
        )
    if cfg.mf_row_effect_type:
        parts.append(f"mf.row.effect.type={cfg.mf_row_effect_type}")
        parts.append(f"mf.col.effect.type={cfg.mf_col_effect_type}")
        parts.append(f"mf.latent.factors={cfg.mf_latent_factors}")
        if cfg.mf_alternations != d["mf_alternations"]:
            parts.append(f"mf.alternations={cfg.mf_alternations}")
    return ",".join(parts)


def parse_coordinate_config(spec: str) -> CoordinateCliConfig:
    """Parse one --coordinate-configurations value, e.g.
    "name=per-user,random.effect.type=userId,feature.shard=user,
     optimizer=TRON,reg.weights=0.1|1|10,active.data.upper.bound=4096"."""
    kv = parse_kv_list(spec)
    try:
        name = kv.pop("name")
        # MF coordinates take no feature shard (their features are the other
        # side's latent factors); everything else requires one.
        if "mf.row.effect.type" in kv:
            shard = kv.pop("feature.shard", "")
        else:
            shard = kv.pop("feature.shard")
    except KeyError as e:
        raise ValueError(f"coordinate config missing {e} in {spec!r}") from None

    def pop(key, default=None):
        return kv.pop(key, default)

    mf_keys_given = sorted(k for k in kv if k.startswith("mf."))

    cfg = CoordinateCliConfig(
        name=name,
        feature_shard=shard,
        optimizer=OptimizerType(pop("optimizer", "LBFGS").upper()),
        max_iterations=int(pop("max.iter", "100")),
        tolerance=float(pop("tolerance", "1e-7")),
        rel_function_tolerance=(
            float(v) if (v := pop("rel.function.tolerance")) else None
        ),
        max_cg_iterations=int(pop("max.cg.iter", "20")),
        reg_weights=tuple(
            float(w) for w in pop("reg.weights", "0").split(LIST_SEP) if w
        ),
        reg_alpha=float(pop("reg.alpha", "0")),
        down_sampling_rate=float(pop("down.sampling.rate", "1")),
        compute_variance=_bool(pop("variance", "false")),
        variance_mode=validate_variance_mode(pop("variance.mode", "auto").lower()),
        random_effect_type=pop("random.effect.type"),
        active_data_lower_bound=(
            int(v) if (v := pop("active.data.lower.bound")) else None
        ),
        active_data_upper_bound=(
            int(v) if (v := pop("active.data.upper.bound")) else None
        ),
        projector=ProjectorType(pop("projector", "IDENTITY").upper()),
        projected_dim=(int(v) if (v := pop("projected.dim")) else None),
        features_to_samples_ratio=(
            float(v) if (v := pop("features.to.samples.ratio")) else None
        ),
        scheduler=_bool(pop("scheduler", "false")),
        scheduler_probe_iterations=int(pop("scheduler.probe.iter", "2")),
        scheduler_freeze_tolerance=float(pop("scheduler.freeze.tolerance", "0")),
        scheduler_freeze_gradient=float(pop("scheduler.freeze.gradient", "0")),
        mf_row_effect_type=pop("mf.row.effect.type"),
        mf_col_effect_type=pop("mf.col.effect.type"),
        mf_latent_factors=int(pop("mf.latent.factors", "0")),
        mf_alternations=int(pop("mf.alternations", "2")),
    )
    if kv:
        raise ValueError(f"unknown coordinate config keys {sorted(kv)} in {spec!r}")
    if not cfg.reg_weights:
        raise ValueError(f"coordinate {name!r} has an empty reg.weights grid")
    # Any mf.* key makes this an MF coordinate; partial specs (e.g. col+factors
    # without row) must fail loudly, not silently train a fixed effect.
    if mf_keys_given and (
        cfg.mf_row_effect_type is None
        or cfg.mf_col_effect_type is None
        or cfg.mf_latent_factors <= 0
    ):
        raise ValueError(
            f"coordinate {name!r} sets {mf_keys_given} but a matrix-"
            "factorization coordinate requires all of mf.row.effect.type, "
            "mf.col.effect.type, and mf.latent.factors > 0"
        )
    if cfg.features_to_samples_ratio is not None and not cfg.is_random_effect:
        raise ValueError(
            f"coordinate {name!r}: features.to.samples.ratio is per-entity "
            "Pearson selection and only applies to random-effect coordinates"
        )
    if cfg.scheduler and not cfg.is_random_effect:
        raise ValueError(
            f"coordinate {name!r}: scheduler=true is probe/rescue lane "
            "scheduling for VMAPPED per-entity solves and only applies to "
            "random-effect coordinates (fixed effects are a single "
            "un-vmapped solve; use rel.function.tolerance there)"
        )
    if cfg.is_matrix_factorization and cfg.is_random_effect:
        raise ValueError(
            f"coordinate {name!r} sets both random.effect.type and mf.* keys; "
            "a coordinate is either a random effect or a matrix factorization"
        )
    if cfg.is_matrix_factorization and cfg.reg_alpha > 0.0:
        raise ValueError(
            f"MF coordinate {name!r}: L1 (reg.alpha > 0) is not supported on "
            "latent factors; use pure L2"
        )
    return cfg


def expand_reg_weight_grid(
    configs: Mapping[str, CoordinateCliConfig],
) -> list[dict[str, float]]:
    """Cartesian product of each coordinate's λ grid (reference
    GameTrainingDriver.prepareGameOptConfigs:612-621)."""
    names = list(configs.keys())
    grids = [configs[n].reg_weights for n in names]
    return [dict(zip(names, combo)) for combo in itertools.product(*grids)]


def estimator_coordinate_configs(
    configs: Mapping[str, CoordinateCliConfig], reg_weights: Mapping[str, float]
) -> dict:
    return {
        name: cfg.estimator_config(reg_weights[name]) for name, cfg in configs.items()
    }


def evaluation_id_columns(evaluator_specs: Sequence[str]) -> tuple[str, ...]:
    """Id columns needed by per-query evaluator specs ("AUC:queryId")."""
    cols = []
    for spec in evaluator_specs:
        if ":" in spec:
            col = spec.split(":", 1)[1].strip()
            if col and col not in cols:
                cols.append(col)
    return tuple(cols)
