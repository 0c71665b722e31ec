"""Readings from which a cell's limits are set, on the card, at the cell's size.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--out readings.jsonl]

For each seed, one run of the program as the configuration states it
(``harness/core.run``: set-up, one unit, the reference's comparison); for
each control seed, the control (the program's own lower-precision path
where the mix names one as ``control_traffic``, else the reference put in
the program's place by ``control_answers``); for each fault seed, one run
per fault of the kind, planted in the program underneath. Each reading is
one JSON line: every number compared, with no limit applied. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _numbers(result: dict) -> dict:
    return {name: check["value"] for name, check in result["checks"].items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    for path in (str(HERE), str(HERE.parent)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    from harness import core, device, inputs, registry

    device.require(torch, 1)
    cell = registry.cell(args.workload)
    config, traffic = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    kind = registry.kind(traffic["kind"])
    reference = registry.reference(traffic["kind"])
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def program(seed, **kw):
        t0 = time.time()
        r = core.run(args.workload, seed, 0.0, False, t_start=t0, **kw)
        return _numbers(r), time.time() - t0

    for seed in seeds(args.seeds):
        numbers, seconds = program(seed)
        emit({"cell": args.workload, "seed": seed, "run": "program", "numbers": numbers,
              "seconds": seconds})
    for seed in seeds(args.control_seeds):
        t0 = time.time()
        if "control_traffic" in traffic:
            numbers, _ = program(seed, traffic_overrides=traffic["control_traffic"])
        else:
            make = getattr(inputs, config["inputs"])
            data = make(torch, config, seed, torch.device("cuda"))
            answers = reference.control_answers(torch, config, traffic, data)
            checks, _ = core.judge(reference.check(torch, config, traffic, data, answers),
                                   cell["limits"])
            numbers = {k: v["value"] for k, v in checks.items()}
            del data
            torch.cuda.empty_cache()
        emit({"cell": args.workload, "seed": seed, "run": "control", "numbers": numbers,
              "seconds": time.time() - t0})
    for seed in seeds(args.fault_seeds):
        for fault in kind.FAULTS:
            numbers, seconds = program(seed, faults=[fault])
            emit({"cell": args.workload, "seed": seed, "run": f"fault:{fault}",
                  "numbers": numbers, "seconds": seconds})
    return 0


if __name__ == "__main__":
    sys.exit(main())
