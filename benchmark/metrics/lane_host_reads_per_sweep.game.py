"""``lane_host_reads_per_sweep.game``: the lane solvers' host reads
(``photon_ml_torch.optim.common.lane_host_reads``, one a read that waits for
the device) in the traced fits over their sweeps. Moves ``game_sweep_s``."""


def read(ctx):
    c = ctx["counts"]
    return c["lane_host_reads"] / c["sweeps"] if c.get("sweeps") else None
