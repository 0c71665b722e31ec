"""``b1_roofline.glm``: B1 (``csrc/fused_glm.cu``: ``fused_glm_partials_kernel``
and its ordered reduce) against its least time at the batch's shape, in
percent: the least time of one value-and-gradient evaluation
(``harness/roofline.glm_evaluation``) over the kernel's mean device time a
call (partials plus reduce, by the profiler, over the partials' launches).
Nothing is read where the trace holds no B1 launch. Moves ``glm_lambda_s``."""

from harness import roofline

PARTIALS = "fused_glm_partials"
REDUCE = "reduce_partials"


def read(ctx):
    tr = ctx["trace"]
    calls = tr.matching(PARTIALS)
    if not calls:
        return None
    device_ns = sum(iv[2] for iv in calls) + sum(iv[2] for iv in tr.matching(REDUCE))
    n, d = ctx["shapes"]["n"], ctx["shapes"]["d"]
    least = roofline.least_seconds(*roofline.glm_evaluation(n, d))[0]
    return least / (device_ns / 1e9 / len(calls)) * 100.0
