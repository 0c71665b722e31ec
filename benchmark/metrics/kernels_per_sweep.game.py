"""``kernels_per_sweep.game``: device kernels in the traced fits (copies and
fills left out) over their sweeps: mostly the random effects' lane loops
(``optim/lanes.py``, ``optim/newton.py``, ``ops/lane_objective.py``). Moves
``game_sweep_s``."""


def read(ctx):
    sweeps = ctx["counts"].get("sweeps")
    return len(ctx["trace"].kernels) / sweeps if sweeps else None
