"""A rank of the four-rank small cell with a fault planted in its process:

    python3 bench/tests/_rank_fault.py <fault> <the rank's arguments>

``exit_in_setup``: rank 2 exits 1 while it makes its graph.
``stuck_in_window``: rank 2 stops answering at its third call of the shard
engine (the warm-up is its first, so the window has begun).
``exchange_left_out``: on every rank the allgather exchange drops what the
other shards sent (rank 0 plants it in its own process with :func:`plant`).

A fault that strikes writes ``FAULT <rank> <time.time()>`` to standard
error first.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FAULTS = ("exit_in_setup", "stuck_in_window", "exchange_left_out")


def _strike(rank: int) -> None:
    print(f"FAULT {rank} {time.time()!r}", file=sys.stderr, flush=True)


def plant(fault: str, rank: int) -> None:
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "exit_in_setup" and rank == 2:
        from bench.gen import graphs

        def make(*args, **kwargs):
            _strike(rank)
            sys.exit(1)
        graphs.make = make
    elif fault == "stuck_in_window" and rank == 2:
        from repro_torch.core.engine_shardmap import ShardEngine
        orig, calls = ShardEngine.run, [0]

        def run(self, *args, **kwargs):
            calls[0] += 1
            if calls[0] == 3:
                _strike(rank)
                time.sleep(3600)
            return orig(self, *args, **kwargs)
        ShardEngine.run = run
    elif fault == "exchange_left_out":
        from repro_torch.core.engine_shardmap import ShardEngine

        def deliver(self, d, payload, active):
            B = payload.shape[0]
            upd = self.mesh.all_gather(payload).reshape(B, -1)
            act = self.mesh.all_gather(active).clone()
            act[:, [p for p in range(act.shape[1])
                    if p != self.mesh.rank]] = False
            acc, got, carry, n_msgs = self._consume(d, upd,
                                                    act.reshape(B, -1))
            return acc, got, carry, {"n_msgs": n_msgs, "words": self._words}
        ShardEngine._deliver_allgather = deliver


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    fault, argv = sys.argv[1], sys.argv[2:]
    plant(fault, int(argv[argv.index("--rank") + 1]))
    from bench import ranks
    sys.exit(ranks.main(argv))
