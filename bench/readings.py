"""The readings the check's limits are set from. Not part of a benchmark
run; run when a cell is defined or a limit is questioned:

    python3 bench/readings.py --workload <cell> --seconds <s> \
        --seeds 1 2 3 --control-seeds 4 5 6

One process. For each of ``--seeds`` it makes a whole run of the cell
(at its own load, with a window of ``--seconds``) and prints the numbers
the check compared; for each of ``--control-seeds`` the same, with the
reference computed in bfloat16 put in the program's place (the control,
which has to come out not correct).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402,F401  (paths and caches, as a benchmark run)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    import torch
    from bench import harness
    runs = ([(s, None) for s in args.seeds]
            + [(s, torch.bfloat16) for s in args.control_seeds])
    for seed, control in runs:
        t0 = time.perf_counter()
        line = harness.run_cell(args.workload, seed, args.seconds, False,
                                device="cuda", control_dtype=control,
                                log=lambda s: None)
        print(json.dumps({"seed": seed, "control": str(control),
                          "correct": line["correct"],
                          "checks": line["checks"],
                          "metrics": line["metrics"],
                          "attempted": line["attempted"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
