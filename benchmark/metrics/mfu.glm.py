"""``mfu.glm``: the whole solve's share of the card's peak, in percent: the
least time, at the published peaks, of the work the traced paths' solves
needed (each value-and-gradient evaluation, value alone and Hessian-vector
product reading X once, counted at the calls into the bound objective;
``harness/roofline.glm_work_seconds``) over the traced window's wall time.
Moves ``glm_lambda_s``.

The counts come from wrapping ``ops/objective.BoundObjective`` from outside,
so work that reaches the card by another call would go uncounted and the
share would read low. The reader fails instead where its counts are short
by what it can see: no evaluation counted, fewer evaluations than B1
launches, or a TRON path with no Hessian-vector product counted."""

from harness import roofline


class ShortCount(RuntimeError):
    """The counts at ``BoundObjective`` miss work that the run did."""


def read(ctx):
    c = ctx["counts"]
    if not c.get("solves"):
        return None
    if not c["evaluations"] or c["b1_launches"] > c["evaluations"]:
        raise ShortCount(f"{c['evaluations']} evaluations counted at BoundObjective against "
                         f"{c['b1_launches']} B1 launches")
    if ctx["traffic"].get("optimizer") == "TRON" and not c["hvps"]:
        raise ShortCount("a TRON path with no Hessian-vector product counted at BoundObjective")
    n, d = ctx["shapes"]["n"], ctx["shapes"]["d"]
    least = roofline.glm_work_seconds(n, d, c["evaluations"], c["values"], c["hvps"])
    return least / ctx["wall_s"] * 100.0
