"""The readings that the limits of ``correct`` are set from, at a cell's own
size, for several seeds in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds <n> [<n> ...] \\
        [--out readings.jsonl]

For each seed: the program's set-up and its first calls, then the numbers
a run's check of ``correct`` computes (every one, compared or not), read three ways:
the program's (the lower reading); for the first ``--control-seeds``
seeds also the control's (the reference in the configuration's
``control`` precision in the program's place) and each planted fault's
that the driver declares (``Driver.FAULTS``: the reference with the fault
in the program's place). One JSON line a seed and way, with the check's
seconds and the verdict that a run would give under the cell's limits.
The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench import run


def readings(cell, seed: int, device, controls: bool = True) -> list:
    from portbench import harness, spec

    drv = spec.driver_module(cell).Driver(cell.config, cell.traffic, seed,
                                         device)
    drv.setup()
    # a short window at the cell's own load, as many requests as a run checks
    for _ in range(cell.traffic.get("checked_requests", 0) + 1):
        drv.call()
    drv.release()
    ways = [("program", {})]
    if controls:
        ways.append(("control", {"precision": cell.config["control"]}))
        ways.extend(getattr(drv, "FAULTS", {}).items())
    out = []
    for way, kw in ways:
        t0 = time.perf_counter()
        values = drv.check(**kw)
        correct, _ = harness.verdict(values, cell.limits)
        out.append({"cell": cell.name, "seed": seed, "way": way,
                    "check_s": time.perf_counter() - t0,
                    "correct": correct, **values})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="the first seeds that also read the control and "
                         "the planted faults")
    args = ap.parse_args(argv)
    run.set_cache_env()
    import torch

    from portbench import spec

    cell = spec.resolve(args.workload)
    device = torch.device("cuda")
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    for n, seed in enumerate(args.seeds):
        for line in readings(cell, seed, device, n < args.control_seeds):
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(text + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
