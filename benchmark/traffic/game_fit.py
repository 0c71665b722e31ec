"""Kind ``game_fit``: GLMix through ``photon_ml_torch.estimators.GameEstimator.fit``,
again and again, on one card: the GAME training driver's own path.

A unit is one whole fit from a cold start (the configuration's sweeps of
fixed effect, per-user and per-item random effects, each fit building its
random-effect buckets as users' fits do), then the fitted model scoring the
held-out rows. The mix names the random effects' solver (``re_optimizer``).
End to end: ``game_sweep_s``, the window's seconds over the sweeps completed
in it.

Every coordinate update of a fit is recorded as it returns (its new
coefficients; the fixed effect's reported value and the first gradient
norm its solver saw): what the reference judges, step by step.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from harness import hooks, inputs


def end_to_end(wall_s: float, counts: dict) -> dict:
    return {"game_sweep_s": wall_s / counts["sweeps"]}


def setup(torch, config: dict, traffic: dict, seed: int, device, stack) -> dict:
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.data.game_data import build_game_dataset
    from photon_ml_torch.estimators import (
        FixedEffectCoordinateConfig,
        GameEstimator,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    data = getattr(inputs, config["inputs"])(torch, config, seed, device)

    def dataset(part, vocabs=None):
        def host(t):
            return t.cpu().numpy()

        return build_game_dataset(
            labels=host(part["y"]),
            feature_shards={"global": host(part["x_fe"]), "per_entity": host(part["x_re"])},
            entity_keys={"user": host(part["user"]), "item": host(part["item"])},
            entity_vocabs=vocabs, device=device)

    train = dataset(data["train"])
    a = config["assumed"]

    def opt(kind, iterations):
        return CoordinateOptimizationConfig(
            optimizer=OptimizerConfig(OptimizerType[kind], max_iterations=iterations),
            l2_weight=a["l2_weight"])

    buckets = tuple(a["bucket_sizes"])
    re_opt = opt(traffic["re_optimizer"], a["re_max_iterations"])
    estimator = GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_configs={
            "fixed": FixedEffectCoordinateConfig(
                "global", opt(a["fe_optimizer"], a["fe_max_iterations"])),
            "per_user": RandomEffectCoordinateConfig("user", "per_entity", re_opt,
                                                     bucket_sizes=buckets),
            "per_item": RandomEffectCoordinateConfig("item", "per_entity", re_opt,
                                                     bucket_sizes=buckets),
        },
        num_iterations=a["sweeps"], kernel_unit=traffic.get("kernel_unit", "fma"))
    updates: list = []
    _record(stack, updates)
    state = {
        "inputs": data,
        "shapes": {},
        "dataset": train, "held_out": dataset(data["held_out"], train.entity_vocabs),
        "estimator": estimator, "updates": updates, "sweeps": a["sweeps"],
        "cuda": torch.device(device).type == "cuda",
    }
    run_unit(torch, state)  # warm-up: every bucket's and the scorer's shapes
    return state


def _record(stack, updates: list) -> None:
    """Record each coordinate update's result as the coordinate returns it."""
    from photon_ml_torch.algorithm.coordinates import (
        FixedEffectCoordinate,
        RandomEffectCoordinate,
    )

    def fixed(update_model):
        def call(self, model, extra_offsets=None):
            new, info = update_model(self, model, extra_offsets)
            updates.append({"cid": self.coordinate_id, "kind": "fixed",
                            "w": new.glm.coefficients.means.detach().clone(),
                            "value": info.value, "grad0": info.grad_norm_history[0]})
            return new, info
        return call

    def random(update_model):
        def call(self, model, extra_offsets=None):
            new, info = update_model(self, model, extra_offsets)
            updates.append({"cid": self.coordinate_id, "kind": new.random_effect_type,
                            "w": new.coefficients.detach().clone(), "keys": new.entity_keys})
            return new, info
        return call

    stack.enter_context(hooks.wrapped(FixedEffectCoordinate, "update_model", fixed))
    stack.enter_context(hooks.wrapped(RandomEffectCoordinate, "update_model", random))


def run_unit(torch, state: dict) -> dict:
    from photon_ml_torch.optim import common

    reads = common.lane_host_reads
    state["updates"].clear()
    result = state["estimator"].fit(state["dataset"])
    scores = result.model.score_dataset(state["held_out"])
    if state["cuda"]:
        torch.cuda.synchronize()
    state["last"] = {"updates": list(state["updates"]), "scores": scores}
    return {"fits": 1, "sweeps": state["sweeps"],
            "lane_host_reads": common.lane_host_reads - reads}


def answers(torch, state: dict) -> dict:
    """The last fit's coordinate updates in order (coefficients; the fixed
    effect's reported value and first gradient norm; a random effect's
    entity ids by table row) and
    its scores of the held-out rows."""
    out = []
    for u in state["last"]["updates"]:
        a = {"kind": u["kind"], "w": u["w"].double().cpu()}
        if "value" in u:
            a["value"], a["grad0"] = float(u["value"]), float(u["grad0"])
        if "keys" in u:
            a["ids"] = np.asarray(u["keys"]).astype(np.int64)
        out.append(a)
    return {"updates": out, "scores": state["last"]["scores"].double().cpu()}


def release(state: dict) -> None:
    for key in ("dataset", "held_out", "estimator", "last", "updates"):
        state.pop(key, None)


def _unchanged(torch):
    """Every coordinate update returns the model it was given."""
    import contextlib

    from photon_ml_torch.algorithm.coordinates import (
        FixedEffectCoordinate,
        RandomEffectCoordinate,
    )

    def make(update_model):
        def call(self, model, extra_offsets=None):
            return model, update_model(self, model, extra_offsets)[1]
        return call

    stack = contextlib.ExitStack()
    stack.enter_context(hooks.wrapped(FixedEffectCoordinate, "update_model", make))
    stack.enter_context(hooks.wrapped(RandomEffectCoordinate, "update_model", make))
    return stack


def _half_batch(torch):
    """The fixed effect's batch keeps its first half of rows, weighted twice."""
    from photon_ml_torch.data.game_data import GameDataset

    def make(fixed_effect_batch):
        def call(self, shard_id, extra_offsets=None):
            batch = fixed_effect_batch(self, shard_id, extra_offsets)
            w = batch.weights.clone()
            w[: len(w) // 2] *= 2.0
            w[len(w) // 2:] = 0.0
            return dataclasses.replace(batch, weights=w)
        return call

    return hooks.wrapped(GameDataset, "fixed_effect_batch", make)


def _altered(torch):
    """Each random-effect update comes out with its first entity's
    coefficients negated, and each scoring with its first score moved by 1."""
    import contextlib

    from photon_ml_torch.algorithm.coordinates import RandomEffectCoordinate
    from photon_ml_torch.models.game import GameModel

    def update(update_model):
        def call(self, model, extra_offsets=None):
            new, info = update_model(self, model, extra_offsets)
            table = new.coefficients.clone()
            table[0] = -table[0]
            return dataclasses.replace(new, coefficients=table), info
        return call

    def score(score_dataset):
        def call(self, dataset):
            scores = score_dataset(self, dataset).clone()
            scores[0] += 1.0
            return scores
        return call

    stack = contextlib.ExitStack()
    stack.enter_context(hooks.wrapped(RandomEffectCoordinate, "update_model", update))
    stack.enter_context(hooks.wrapped(GameModel, "score_dataset", score))
    return stack


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}
