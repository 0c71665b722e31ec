"""Run one cell of the benchmark of ``photon_ml_torch`` once, on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's files are found by its name
(``benchmark/cells/<cell>.json``, see ``harness/registry.py``). With
``--trace 0`` the last line of standard output reports the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics from a profiler trace; in
both, ``correct`` comes from the plain reference's comparison, whose numbers
and limits are also the last lines of standard error. Exits 3 without a
result where there is no card (it never runs on the CPU), and 4 where the
process loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_ENTRY = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
#: host threads of each numeric library (set before any of them loads)
HOST_THREADS = 4


def _process_start() -> float:
    """Wall time at which this process started (from /proc; the entry time
    where that cannot be read)."""
    try:
        stat = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return min(T_ENTRY, time.time() - (uptime - int(stat[19]) / ticks))
    except (OSError, ValueError, IndexError):
        return T_ENTRY


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's own nvcc builds already go to ``build/torch_kernels/`` there), and
    a fixed, small number of host threads for steady runs."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton_cache")
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[name] = str(HOST_THREADS)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    t_start = _process_start()
    _environment()
    for path in (str(HERE), str(CHECKOUT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    from harness import core, imports
    from harness.device import NoCard

    try:
        result = core.run(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
    except NoCard as err:
        print(f"no result: {err}", file=sys.stderr)
        return 3
    loaded = imports.forbidden_loaded()
    if loaded:
        print(f"no result: the process loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
