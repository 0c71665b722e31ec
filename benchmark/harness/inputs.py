"""The inputs of every cell, made on the device from ``--seed`` with one
``torch.Generator`` in a few large calls. The same seed gives the same
inputs; every seed gives the same sizes (row counts, entity counts and
their per-entity row counts), so a seed changes the values and the order,
never the amount of work.
"""

from __future__ import annotations

import math

import numpy as np


def generator(torch, seed: int, device):
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def epsilon(torch, config: dict, seed: int, device) -> dict:
    """Dense binary rows at the widths of the PASCAL challenge's ``epsilon``.

    Standard-normal rows mixed by a random rotation with singular values
    ``(k+1)^-spectrum_power`` (correlated features, so the solvers meet a
    spread spectrum), then standardized per column and scaled to unit length
    per row, as the LIBSVM page describes ``epsilon``'s preprocessing.
    Labels in {0, 1} are drawn from a planted model whose margins have the
    standard deviation ``margin_std``.
    """
    n, d = config["rows"], config["features"]
    a = config["assumed"]
    gen = generator(torch, seed, device)
    q, _ = torch.linalg.qr(torch.randn(d, d, generator=gen, device=device))
    scale = (torch.arange(d, device=device, dtype=torch.float32) + 1.0) ** -a["spectrum_power"]
    mix = scale[:, None] * q
    x = torch.empty(n, d, device=device)
    block = 1 << 16
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        torch.matmul(torch.randn(hi - lo, d, generator=gen, device=device), mix, out=x[lo:hi])
    x.sub_(x.mean(dim=0)).div_(x.std(dim=0))
    x.div_(torch.linalg.vector_norm(x, dim=1, keepdim=True))
    w = torch.randn(d, generator=gen, device=device)
    margins = x @ w
    w.mul_(a["margin_std"] / margins.std())
    margins = x @ w
    y = (torch.rand(n, generator=gen, device=device) < torch.sigmoid(margins)).float()
    return {"x": x, "y": y}


def zipf_counts(total: int, entities: int, low: int, high: int) -> np.ndarray:
    """Rows per entity by rank, Zipf-shaped: a power law in the rank r =
    1..N, ``low + (high - low)·(r^-a - N^-a)/(1 - N^-a)``, from ``high`` at
    the first rank to ``low`` at the last, with the power a chosen so the
    counts add up to ``total`` (the remainder of the rounding goes one row
    each to ranks 2 on). Depends on its arguments alone, never on a seed."""
    r = np.arange(1, entities + 1, dtype=np.float64)

    def counts(power):
        tail = float(entities) ** -power
        share = np.clip((r ** -power - tail) / (1.0 - tail), 0.0, 1.0)
        return low + np.floor((high - low) * share + 1e-9)

    lo, hi = 1e-6, 8.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if counts(mid).sum() > total else (lo, mid)
    c = counts(hi).astype(np.int64)
    c[1:1 + total - int(c.sum())] += 1
    if c.sum() != total or c.max() != high or c.min() < low:
        raise ValueError(f"no Zipf-shaped counts of {entities} entities in "
                         f"[{low}, {high}] add up to {total}")
    return c


def movielens_game(torch, config: dict, seed: int, device) -> dict:
    """GLMix rows at MovieLens-1M's counts: ``rows`` ratings of ``users``
    users (each at least ``min_rows_per_user``) and ``items`` movies, both
    heavy-tailed (:func:`zipf_counts`), paired at random and in random
    order; a ``global`` shard of ``d_global`` and a ``per_entity`` shard of
    ``d_per_entity`` standard-normal features; logistic labels drawn from a
    planted fixed effect (N(0, 1/d)) plus planted per-user and per-movie
    effects (N(0, 0.25)), as the flagship's generator draws them.

    ``held_out_rows`` more rows of the same model follow: users and movies
    of random training rows, the last ``held_out_unseen_share`` of them with
    users never trained on (ids from ``users`` up).
    """
    a = config["assumed"]
    n, users, items = config["rows"], config["users"], config["items"]
    h = a["held_out_rows"]
    cu = zipf_counts(n, users, config["min_rows_per_user"], a["max_rows_per_user"])
    ci = zipf_counts(n, items, a["min_rows_per_item"], a["max_rows_per_item"])
    gen = generator(torch, seed, device)

    def perm(k):
        return torch.randperm(k, generator=gen, device=device)

    user = torch.repeat_interleave(perm(users), torch.as_tensor(cu, device=device))
    item = torch.repeat_interleave(perm(items), torch.as_tensor(ci, device=device))[perm(n)]
    order = perm(n)
    user, item = user[order], item[order]
    pick = torch.randint(0, n, (h,), generator=gen, device=device)
    user_h, item_h = user[pick].clone(), item[pick].clone()
    unseen = int(round(h * a["held_out_unseen_share"]))
    user_h[h - unseen:] = users + torch.arange(unseen, device=device)
    total = n + h
    d_fe, d_re = a["d_global"], a["d_per_entity"]
    x_fe = torch.randn(total, d_fe, generator=gen, device=device)
    x_re = torch.randn(total, d_re, generator=gen, device=device)
    w_fe = torch.randn(d_fe, generator=gen, device=device) / math.sqrt(d_fe)
    w_user = 0.5 * torch.randn(users + unseen, d_re, generator=gen, device=device)
    w_item = 0.5 * torch.randn(items, d_re, generator=gen, device=device)
    all_user, all_item = torch.cat([user, user_h]), torch.cat([item, item_h])
    z = x_fe @ w_fe + (x_re * (w_user[all_user] + w_item[all_item])).sum(dim=1)
    y = (torch.rand(total, generator=gen, device=device) < torch.sigmoid(z)).float()

    def part(lo, hi):
        return {"x_fe": x_fe[lo:hi], "x_re": x_re[lo:hi], "y": y[lo:hi],
                "user": all_user[lo:hi], "item": all_item[lo:hi]}

    return {"train": part(0, n), "held_out": part(n, total)}
