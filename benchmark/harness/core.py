"""One run of one cell: set-up, the measured (or traced) window, the peak
memory, the program's answers, then the plain reference's comparison.

A kind of traffic (``traffic/<kind>.py``) provides:

- ``setup(torch, config, traffic, seed, device, stack)`` -> state: makes the
  inputs from the seed (``state["inputs"]``, all the reference gets), builds
  the program's objects and warms up every shape the window uses;
- ``run_unit(torch, state)`` -> counts: one whole unit of work (a λ path, a
  GAME fit), synchronized at its end;
- ``end_to_end(wall_s, counts)`` -> {metric: value}: the window's wall time
  over the units' counts;
- ``answers(torch, state)``: host copies of what the last unit produced;
- ``release(state)``: drops the program's objects;
- ``FAULTS``: name -> ``(torch) -> context`` planting a fault in the
  program, for the tests and for reading the limits' upper ends.

Its reference (``reference/<kind>.py``) provides ``check(torch, config,
traffic, inputs, answers)`` -> one dict of numbers per answer compared.
"""

from __future__ import annotations

import contextlib
import gc
import time

from harness import device as card
from harness import registry, trace


def _add(totals: dict, counts: dict) -> None:
    for key, value in counts.items():
        totals[key] = totals.get(key, 0) + value


def window(torch, kind, state, seconds: float, synchronize) -> tuple[dict, float]:
    """Whole units until ``seconds`` have passed: no unit starts after that,
    and the window closes at the end of the last one."""
    totals: dict = {}
    synchronize()
    t0 = time.perf_counter()
    while True:
        _add(totals, kind.run_unit(torch, state))
        if time.perf_counter() - t0 >= seconds:
            break
    return totals, time.perf_counter() - t0


def judge(per_answer: list, limits: dict) -> tuple[dict, int]:
    """The widest reading of each number over the answers, beside its limit,
    and how many answers read above a limit. A number without a limit is an
    error: every number compared has one."""
    numbers: dict = {}
    failed = 0
    for answer in per_answer:
        over = False
        for name, value in answer.items():
            if name not in limits:
                raise KeyError(f"the number {name!r} has no limit in the cell's file")
            numbers[name] = max(numbers.get(name, value), value)
            over |= not value <= limits[name]
        failed += over
    checks = {name: {"value": numbers[name], "limit": limits[name]} for name in sorted(numbers)}
    return checks, failed


def run(cell_name: str, seed: int, seconds: float, traced: bool, *, t_start: float,
        on_card: bool = True, device=None, config_overrides=None, traffic_overrides=None,
        faults=()) -> dict:
    """One run; returns the result line (a dict). ``on_card=False`` skips the
    look for a card and runs on ``device`` (the tests, on the CPU, at the
    sizes their overrides give)."""
    import torch

    cell = registry.cell(cell_name)
    config = _merged(registry.config(cell["config"]), config_overrides)
    traffic = _merged(registry.traffic(cell["traffic"]), traffic_overrides)
    kind = registry.kind(traffic["kind"])
    reference = registry.reference(traffic["kind"])
    if on_card:
        card.require(torch, cell["chips"])
        device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device).type == "cuda"

    def synchronize():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        from photon_ml_torch import build

        build.build_all()
    out: dict = {}
    with contextlib.ExitStack() as stack:
        for fault in faults:
            stack.enter_context(kind.FAULTS[fault](torch))
        state = kind.setup(torch, config, traffic, seed, device, stack)
        synchronize()
        setup_s = time.time() - t_start
        if traced:
            counts, tr = trace.profile(torch, lambda: kind.run_unit(torch, state))
            wall = tr.window_s
        else:
            counts, wall = window(torch, kind, state, seconds, synchronize)
        if cuda:
            out["device"] = card.info(torch, cell["chips"])
        answers = kind.answers(torch, state)
        inputs = state["inputs"]
        shapes = state["shapes"]
        kind.release(state)
        del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    per_answer = reference.check(torch, config, traffic, inputs, answers)
    checks, failed = judge(per_answer, cell["limits"])
    metrics = {}
    if traced:
        ctx = {"trace": tr, "counts": counts, "wall_s": wall, "shapes": shapes,
               "traffic": traffic}
        for entry in registry.metrics_of(cell_name, "per_layer"):
            value = registry.metric(entry["name"]).read(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        out.setdefault("device", {}).update(busy_s=tr.busy_s(), window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    else:
        values = dict(kind.end_to_end(wall, counts), setup_s=setup_s)
        for entry in registry.metrics_of(cell_name, "end_to_end"):
            metrics[entry["name"]] = {"value": values[entry["name"]], "unit": entry["unit"]}
    return {"correct": failed == 0, "attempted": len(per_answer), "failed": failed,
            "metrics": metrics, "device": out.get("device", {}), "counts": counts,
            **({"breakdown": out["breakdown"]} if "breakdown" in out else {}),
            "checks": checks}


def _merged(base: dict, overrides: dict | None) -> dict:
    """``base`` with ``overrides`` laid over it, one level into nested dicts."""
    out = dict(base)
    for key, value in (overrides or {}).items():
        out[key] = {**out[key], **value} if isinstance(value, dict) and key in out else value
    return out
