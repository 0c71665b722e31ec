"""Least times from published peaks: the bytes and operations a call needs,
computed from its shapes, over one NVIDIA H100 SXM's data-sheet rates.

The counts are of what the inputs need, whatever implements them: each
input byte read once, each output byte written once, no scratch (a
kernel's per-block partials are its own choice and are not counted).
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, at its 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def least_seconds(nbytes: float, flops: float) -> tuple[float, str]:
    """The larger of bytes over the memory rate and f32 operations over the
    f32 rate, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def glm_evaluation(n: int, d: int, itemsize: int = 4) -> tuple[float, float]:
    """(bytes, operations) of one value-and-gradient evaluation of a dense
    GLM: X, labels, offsets and weights read once, w in, the gradient and
    the value out; a margin and a gradient update a row (4·n·d)."""
    nbytes = n * d * itemsize + 3 * 4 * n + 4 * d + 4 * d + 4
    return float(nbytes), 4.0 * n * d


def glm_value(n: int, d: int, itemsize: int = 4) -> tuple[float, float]:
    """(bytes, operations) of a value alone: X, labels, offsets and weights
    read, w in, the value out; one margin a row (2·n·d)."""
    return float(n * d * itemsize + 3 * 4 * n + 4 * d + 4), 2.0 * n * d


def hessian_vector(n: int, d: int, itemsize: int = 4) -> tuple[float, float]:
    """(bytes, operations) of one Hessian-vector product Xᵀ(D(Xv)): X read
    once (one pass a row serves both products), the rows' curvature D in,
    v in, the product out; 4·n·d operations."""
    return float(n * d * itemsize + 4 * n + 4 * d + 4 * d), 4.0 * n * d


def glm_work_seconds(n: int, d: int, evaluations: int, values: int, hvps: int) -> float:
    """Least seconds of a solve's work: its value-and-gradient evaluations,
    values alone and Hessian-vector products, each at its own bound."""
    total = 0.0
    for count, (nbytes, flops) in ((evaluations, glm_evaluation(n, d)),
                                   (values, glm_value(n, d)),
                                   (hvps, hessian_vector(n, d))):
        total += count * least_seconds(nbytes, flops)[0]
    return total
