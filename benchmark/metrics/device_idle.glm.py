"""``device_idle.glm``: the share of the traced window in which no device
interval (kernel, copy or fill) ran, in percent: one minus the union of the
profiler's device intervals over the window's wall time. Moves ``glm_lambda_s``."""


def read(ctx):
    tr = ctx["trace"]
    return (1.0 - tr.busy_s() / tr.window_s) * 100.0
