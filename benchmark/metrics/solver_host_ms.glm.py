"""``solver_host_ms.glm``: the traced window's wall time not covered by any
device interval, over the solver iterations in it, in milliseconds: the
solvers' host loop (and the profiler's small share of it) a iteration.
Moves ``glm_lambda_s``."""


def read(ctx):
    iterations = ctx["counts"].get("iterations")
    if not iterations:
        return None
    tr = ctx["trace"]
    return (tr.window_s - tr.busy_s()) / iterations * 1e3
