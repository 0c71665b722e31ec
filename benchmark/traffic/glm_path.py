"""Kind ``glm_path``: the configuration's λ path through
``photon_ml_torch.estimators.train_glm``, again and again.

A unit is one whole path: it starts cold, and within it each λ warm-starts
from the one before (``train_glm``'s own path). The mix names the solver
(``optimizer``); the solver keeps ``train_glm``'s default tolerance and
iteration cap. End to end: ``glm_lambda_s``, the window's seconds over the
λ solves completed in it.
"""

from __future__ import annotations

import dataclasses

from harness import hooks, inputs


def end_to_end(wall_s: float, counts: dict) -> dict:
    return {"glm_lambda_s": wall_s / counts["solves"]}


def setup(torch, config: dict, traffic: dict, seed: int, device, stack) -> dict:
    from photon_ml_torch.data.batch import LabeledPointBatch
    from photon_ml_torch.ops import fused_glm
    from photon_ml_torch.ops.objective import BoundObjective
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType

    data = getattr(inputs, config["inputs"])(torch, config, seed, device)
    counts: dict = {}
    for name, key in (("value_and_grad", "evaluations"), ("value", "values"),
                      ("hessian_vector", "hvps")):
        stack.enter_context(hooks.counting(BoundObjective, name, counts, key))
    state = {
        "inputs": data,
        "shapes": {"n": config["rows"], "d": config["features"]},
        "batch": LabeledPointBatch.create(data["x"], data["y"], device=device),
        "optimizer": OptimizerConfig(OptimizerType[traffic["optimizer"]]),
        "lambdas": list(config["regularization_weights"]),
        "calls": counts, "launches": fused_glm,
        "cuda": torch.device(device).type == "cuda",
    }
    run_unit(torch, state)  # warm-up: every shape of the path
    return state


def run_unit(torch, state: dict) -> dict:
    from photon_ml_torch.estimators import train_glm
    from photon_ml_torch.types import TaskType

    calls = dict(state["calls"])
    b1 = state["launches"].launches
    solves = []

    def on_solve(lam, result):
        solves.append({"lambda": lam, "iterations": result.iterations, "value": result.value,
                       "grad0": result.grad_norm_history[0]})

    models = train_glm(state["batch"], TaskType.LOGISTIC_REGRESSION,
                       optimizer=state["optimizer"], regularization_weights=state["lambdas"],
                       on_solve=on_solve)
    if state["cuda"]:
        torch.cuda.synchronize()
    for s in solves:
        s["w"] = models[s["lambda"]].coefficients.means
    state["last"] = solves
    counts = {k: v - calls[k] for k, v in state["calls"].items()}
    return {"paths": 1, "solves": len(solves), "iterations": sum(s["iterations"] for s in solves),
            "b1_launches": state["launches"].launches - b1, **counts}


def answers(torch, state: dict) -> list:
    """Each λ of the last path: its coefficients, the value the solver
    reported at them, the first gradient norm it saw, and where it started
    (zero for the first λ, the previous λ's coefficients after)."""
    out, start = [], None
    for s in state["last"]:
        w = s["w"].detach().double().cpu()
        out.append({"lambda": s["lambda"], "w": w, "value": float(s["value"]),
                    "grad0": float(s["grad0"]),
                    "start": torch.zeros_like(w) if start is None else start})
        start = w
    return out


def release(state: dict) -> None:
    for key in ("batch", "last", "launches"):
        state.pop(key, None)


def _unchanged(torch):
    """Each solve returns the point it started from."""
    import photon_ml_torch.estimators as est

    def make(solve):
        def call(opt, bound, w0, **kw):
            return dataclasses.replace(solve(opt, bound, w0, **kw), coefficients=w0.clone())
        return call

    return hooks.wrapped(est, "solve", make)


def _half_batch(torch):
    """Every evaluation sees the first half of the rows, weighted twice."""
    from photon_ml_torch.ops.objective import GLMObjective

    cache: dict = {}

    def make(value_and_gradient):
        def call(self, coefficients, batch):
            key = id(batch)
            if key not in cache:
                w = batch.weights.clone()
                w[: len(w) // 2] *= 2.0
                w[len(w) // 2:] = 0.0
                cache[key] = (batch, dataclasses.replace(batch, weights=w))
            return value_and_gradient(self, coefficients, cache[key][1])
        return call

    return hooks.wrapped(GLMObjective, "value_and_gradient", make)


def _altered(torch):
    """Each solve's answer comes out with its largest coefficient negated."""
    import photon_ml_torch.estimators as est

    def make(solve):
        def call(opt, bound, w0, **kw):
            result = solve(opt, bound, w0, **kw)
            w = result.coefficients.clone()
            j = int(torch.argmax(w.abs()))
            w[j] = -w[j]
            return dataclasses.replace(result, coefficients=w)
        return call

    return hooks.wrapped(est, "solve", make)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}
