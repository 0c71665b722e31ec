"""Plain reference of kind ``game_fit``: every coordinate update of the
program's last fit, and its held-out scores, worked out again in float64
from the benchmark's own inputs. Imports torch and numpy alone; nothing of
the program.

Block coordinate descent's answer after a fixed number of sweeps and
solver iterations is defined by the path it took, so the reference follows
the fit update by update from the program's own state: each update is held
against the exact minimizer of its block (``reference/logistic.py``) with
the other blocks as the program left them before it. What the program
derives is derived here again: the rows each random effect trains on (every
row of an entity, or, past the largest bucket, the ones the stable
reservoir keeps), the offsets of each block, the scores.

Numbers: ``fe_loss_gap`` (the fixed effect's reported value against f at
its answer, relative), ``fe_grad0_gap`` (the first gradient norm its solver
saw against ‖∇f‖ where it started: zero, then its previous answer, under
the offsets the random effects give it), ``fe_gap`` and ``re_gap`` (an answer against its
block's minimizer, by the worst coefficient over the largest; for a random
effect per entity, over the larger of its own largest and the median
entity's), ``score_gap`` (each held-out score against the reference's, over
the larger of its own size and the median score's).
"""

from __future__ import annotations

import numpy as np

from reference import logistic

_MASK = 0xFFFFFFFFFFFFFFFF


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(_MASK)
        x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(_MASK)
        x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(_MASK)
        return x ^ (x >> np.uint64(31))


def reservoir_rows(entity: np.ndarray, cap: int, seed: int = 0) -> np.ndarray:
    """Rows a random effect trains on: all of an entity's rows, or, for an
    entity with more than ``cap``, the ``cap`` rows of smallest priority,
    the priority of row i (its stable id) being splitmix64(i ^ splitmix64(seed))
    (the reference system's stable-id keyed reservoir). Sorted row indices."""
    order = np.argsort(entity, kind="stable")
    ents = entity[order]
    starts = np.flatnonzero(np.r_[True, ents[1:] != ents[:-1]])
    ends = np.r_[starts[1:], len(ents)]
    keep = [order[s:e] for s, e in zip(starts, ends) if e - s <= cap]
    seed_key = _splitmix64(np.asarray([seed], dtype=np.int64).view(np.uint64))[0]
    for s, e in zip(starts, ends):
        if e - s > cap:
            rows = order[s:e]
            prio = _splitmix64(rows.astype(np.int64).view(np.uint64) ^ seed_key) >> np.uint64(11)
            keep.append(rows[np.argsort(prio, kind="stable")[:cap]])
    return np.sort(np.concatenate(keep))


def _dense_scores(torch, x, w):
    return torch.cat([x[lo:lo + logistic.BLOCK].double() @ w
                      for lo in range(0, x.shape[0], logistic.BLOCK)])


def check(torch, config: dict, traffic: dict, inputs: dict, answers: dict) -> list:
    train, held = inputs["train"], inputs["held_out"]
    dev = train["x_fe"].device
    lam = float(config["assumed"]["l2_weight"])
    cap = max(config["assumed"]["bucket_sizes"])
    x_fe, y = train["x_fe"], train["y"].double()
    x_re = train["x_re"].double()
    ids = {"user": train["user"], "item": train["item"]}
    num = {"user": config["users"], "item": config["items"]}
    active = {t: torch.as_tensor(reservoir_rows(ids[t].cpu().numpy(), cap), device=dev)
              for t in ids}
    fe = torch.zeros(x_fe.shape[1], dtype=torch.float64, device=dev)
    tables = {t: torch.zeros(num[t], x_re.shape[1], dtype=torch.float64, device=dev) for t in ids}

    def re_scores(t):
        return (x_re * tables[t][ids[t]]).sum(dim=1)

    out = []
    for u in answers["updates"]:
        w = u["w"].to(dev)
        if u["kind"] == "fixed":
            offsets = re_scores("user") + re_scores("item")
            w_star = logistic.newton(torch, x_fe, y, lam, torch.zeros_like(fe), offsets=offsets)
            f_w = float(logistic.objective(torch, x_fe, y, lam, w, order=0, offsets=offsets)[0])
            g0 = float(torch.linalg.vector_norm(
                logistic.objective(torch, x_fe, y, lam, fe, offsets=offsets)[1]))
            out.append({"fe_loss_gap": abs(u["value"] - f_w) / abs(f_w),
                        "fe_grad0_gap": abs(u["grad0"] - g0) / g0,
                        "fe_gap": float((w - w_star).abs().max() / w_star.abs().max())})
            fe = w
            continue
        t = u["kind"]
        other = "item" if t == "user" else "user"
        rows = active[t]
        offsets = (_dense_scores(torch, x_fe, fe) + re_scores(other))[rows]
        v_star = logistic.newton_entities(torch, x_re[rows], y[rows], offsets,
                                          ids[t][rows].long(), num[t], lam)
        table = torch.zeros_like(tables[t])
        table[torch.as_tensor(u["ids"], device=dev)] = w
        size = v_star.abs().amax(dim=1)
        scale = torch.clamp(torch.maximum(size, size.median()), min=1e-30)
        out.append({"re_gap": float(((table - v_star).abs().amax(dim=1) / scale).max())})
        tables[t] = table
    s_ref = _dense_scores(torch, held["x_fe"], fe)
    for t, key in (("user", "user"), ("item", "item")):
        idx = held[key].long()
        seen = idx < num[t]
        s_ref += torch.where(seen, (held["x_re"].double()
                                    * tables[t][idx.clamp(max=num[t] - 1)]).sum(dim=1), 0.0)
    s = answers["scores"].to(dev)
    scale = torch.clamp(torch.maximum(s_ref.abs(), s_ref.abs().median()), min=1e-30)
    out.append({"score_gap": float(((s - s_ref).abs() / scale).max())})
    return out
