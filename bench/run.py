"""Run one cell of the port's benchmark on the card and print its line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With ``--trace 0`` the line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics (read from
the service's trace events and a profiled part of the window). Without a
CUDA device, or with fewer than the cell asks for, it exits 2 and prints
no line. The numbers the check compared go last, on standard error and
in the line.

A cell whose ``chips`` is above 1 runs as one rank a card
(``bench/ranks.py``), on a host with that many cards and the same
command: this process is rank 0, on the card a one-chip cell uses, and
starts ranks 1 .. chips-1 on ``cuda:1`` .. with the same arguments; the
ranks form one NCCL group. Only rank 0 prints the line; its ``device``
block reads the fullest card's peak, lists each card's, and counts the
ranks. The rank machinery runs on the CPU over gloo in the tests'
four-rank small cell: ``python -m pytest bench/tests/test_bench_ranks.py``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Caches at fixed paths inside the checkout: the first run of a cell
# there builds, every later one finds what it built. The port's own
# kernels build under build/repro_torch/.
CACHE = ROOT / "build" / "bench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness
    spec = harness.cell(args.workload)
    import torch
    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the system under test)
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda",
                            t_start=T_START, spec=spec)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
