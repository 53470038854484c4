"""A cell on more than one card: one rank a card, rank 0 the harness's own
process.

For a cell whose ``chips`` is above 1, ``harness.run_cell`` (rank 0, on
the card the one-chip path uses) opens a :class:`Launch`: it writes the
cell's spec into a temporary directory and starts ranks 1 .. chips-1 as
processes of its own (``python3 bench/ranks.py``), each on ``cuda:<rank>``
(or on the CPU, for the tests) and each running the same cell, seed,
window and trace flag. The ranks meet through a ``file://`` store in that
directory and form one process group: NCCL on the card, gloo on the CPU.
The loop closes its window on rank 0's decision (:meth:`Group.agree`).
After the window every other rank frees the program's state, reports its
card's peak, the busy seconds of its traced part and any forbidden module
it loaded (:meth:`Group.report`), and exits; rank 0 alone judges and
prints the line.

No hang:

- rank 0 watches its ranks: one that exits non-zero ends the run within
  ``POLL_S`` and a kill, rank 0 killing the others and exiting 1;
- a rank watches rank 0 and exits when it has gone;
- a collective that never completes raises (gloo) or aborts its process
  (NCCL's watchdog) once the group's timeout passes, and rank 0 ends the
  run itself if, while the group forms or from the set-up's meeting
  until the group closes, it goes ``timeout_s + POLL_GRACE_S`` without a
  collective completing.

The group's timeout covers one call of the loop and the ranks' skew after
the set-up's meeting, never the set-up itself: that meeting goes through
the store, which waits up to ``SETUP_S`` for the slowest rank's build.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = ["Group", "Launch", "fold", "main", "TIMEOUT_S", "SETUP_S"]

BENCH = Path(__file__).resolve().parent
# a collective's timeout: the harness's GRACE_S (bench/harness.py), the
# longest the check waits past the window for an answer
TIMEOUT_S = 60.0
# the set-up's meetings: the slowest rank's start and build, the first
# run in a checkout (which compiles) included
SETUP_S = 1200.0
POLL_S = 0.2
# past the group's timeout, how long rank 0 waits for the collective's
# own error before it ends the run itself
POLL_GRACE_S = 10.0


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Group:
    """This process's rank of the cell's process group, on ``cuda:<rank>``
    (``device="cuda"``) or the CPU, once :meth:`join` has returned: each
    rank joins once it has made the cell's graph, so the ranks' start
    overlaps the generator."""

    def __init__(self, torch, store_path: str, rank: int, world: int,
                 device: str, timeout_s: float):
        import torch.distributed as dist
        self._torch, self._dist = torch, dist
        self._store_path, self._timeout_s = store_path, timeout_s
        self.rank, self.world = rank, world
        self.cuda = torch.device(device).type == "cuda"
        self.device = (torch.device("cuda", rank) if self.cuda
                       else torch.device(device))
        self.rendezvous_s: Optional[float] = None
        self.built_wait_s: Optional[float] = None
        # rank 0's watch: armed while the group forms and from the set-up's
        # meeting until the group closes, ``beat`` the end of the last
        # collective
        self.armed, self.beat = False, time.monotonic()

    def join(self) -> None:
        """Wait for every rank through the store, form the group, and make
        its first collective, which on NCCL makes the communicator;
        ``rendezvous_s`` is the time all this took."""
        torch, dist = self._torch, self._dist
        t0 = time.perf_counter()
        if self.cuda:
            torch.cuda.set_device(self.device)
        # the host's cores shared out: each rank's host build as many
        # threads as a one-card machine gives it
        torch.set_num_threads(
            max(1, len(os.sched_getaffinity(0)) // self.world))
        timeout = datetime.timedelta(seconds=self._timeout_s)
        self.store = dist.FileStore(self._store_path, self.world)
        self.store.set_timeout(timeout)
        self.meet("joined")
        self.armed, self.beat = True, time.monotonic()
        dist.init_process_group("nccl" if self.cuda else "gloo",
                                store=self.store, rank=self.rank,
                                world_size=self.world, timeout=timeout)
        self._flag = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.agree(False)
        self.armed = False
        self.rendezvous_s = time.perf_counter() - t0

    def meet(self, name: str) -> float:
        """Wait, through the store and for up to ``SETUP_S``, until every
        rank has reached ``name``; returns the seconds waited."""
        t0 = time.perf_counter()
        self.store.set(f"{name}/{self.rank}", "1")
        self.store.wait([f"{name}/{r}" for r in range(self.world)],
                        datetime.timedelta(seconds=SETUP_S))
        return time.perf_counter() - t0

    def built(self) -> None:
        """This rank's program is built: wait for every rank's, then arm
        the watch on the loop. ``built_wait_s`` is rank 0's wait here, the
        ranks' skew in set-up."""
        self.built_wait_s = self.meet("built")
        self.armed, self.beat = True, time.monotonic()

    def agree(self, stop: bool) -> bool:
        """Rank 0's ``stop``, on every rank: one broadcast of one word."""
        self._flag.fill_(int(stop))
        self._dist.broadcast(self._flag, src=0)
        out = bool(self._flag.item())
        self.beat = time.monotonic()
        return out

    def report(self, reading: Dict[str, Any]) -> None:
        """A rank's readings after the window, for rank 0."""
        self.store.set(f"report/{self.rank}", json.dumps(reading))

    def reports(self) -> List[Dict[str, Any]]:
        """Ranks 1 .. world-1's readings, each waited for up to the
        group's timeout."""
        return [json.loads(self.store.get(f"report/{r}"))
                for r in range(1, self.world)]

    def close(self) -> None:
        """Leave the group. On NCCL this waits for the other ranks to
        leave too, so every rank closes once the reports are in."""
        self._dist.destroy_process_group()
        self.armed = False


def fold(cards: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Each card's readings (rank 0 first: ``peak`` bytes, ``busy_s`` of
    its traced part or None, ``forbidden`` modules) as the line's device
    numbers: the fullest card's peak, the busy seconds averaged over the
    cards, and the forbidden modules by rank. A one-card run gets the
    keys it always had."""
    peaks = [int(c["peak"]) for c in cards]
    out: Dict[str, Any] = {"count": len(cards), "memory_peak_bytes": max(peaks)}
    if len(cards) > 1:
        out["memory_peak_bytes_by_card"] = peaks
    busy = [c["busy_s"] for c in cards if c.get("busy_s") is not None]
    if busy:
        out["busy_s"] = sum(busy) / len(busy)
    out["forbidden"] = [m if r == 0 else f"rank {r}: {m}"
                        for r, c in enumerate(cards) for m in c["forbidden"]]
    return out


class Launch:
    """Rank 0's side: ranks 1 .. world-1 started, watched and joined. A
    context manager: leaving it on an error kills every rank. ``entry``
    is the command a rank runs (the tests plant faults through it),
    ``timeout_s`` the group's timeout."""

    def __init__(self, torch, spec: Dict[str, Any], seed: int,
                 seconds: float, trace: bool, device: str, *,
                 entry: Optional[List[str]] = None,
                 timeout_s: float = TIMEOUT_S):
        world = int(spec["entry"]["chips"])
        self.timeout_s = timeout_s
        self._tmp = tempfile.mkdtemp(prefix="bench-ranks-")
        spec_path = os.path.join(self._tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        store = os.path.join(self._tmp, "store")
        args = ["--spec", spec_path, "--store", store, "--seed", str(seed),
                "--seconds", repr(float(seconds)), "--trace", str(int(trace)),
                "--device", device, "--world", str(world),
                "--timeout", repr(float(timeout_s)),
                "--parent", str(os.getpid())]
        entry = entry or [sys.executable, str(BENCH / "ranks.py")]
        # a rank's standard output goes to rank 0's standard error: the
        # line is the last of rank 0's output alone
        self.procs = {r: subprocess.Popen(entry + args + ["--rank", str(r)],
                                          stdin=subprocess.DEVNULL, stdout=2)
                      for r in range(1, world)}
        _log("ranks started: " + ", ".join(
            f"rank {r} pid {p.pid}" for r, p in self.procs.items()))
        self._stop = threading.Event()
        self.group = Group(torch, store, 0, world, device, timeout_s)
        self._watch = threading.Thread(target=self._watch_ranks, daemon=True)
        self._watch.start()

    def _watch_ranks(self) -> None:
        while not self._stop.wait(POLL_S):
            for r, p in self.procs.items():
                code = p.poll()
                if code not in (None, 0) and not self._stop.is_set():
                    self._end(f"rank {r} exited with code {code}")
            g = self.group
            if g.armed and (time.monotonic() - g.beat
                            > self.timeout_s + POLL_GRACE_S):
                self._end(f"no collective completed in "
                          f"{self.timeout_s + POLL_GRACE_S:.0f} s")

    def _end(self, why: str) -> None:
        """End the run from the watch: every rank killed, rank 0 exits 1
        (its main thread may be waiting in a collective)."""
        _log(f"ending the run: {why}")
        self._kill()
        os._exit(1)

    def _kill(self) -> None:
        self._stop.set()
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            p.wait()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def collect(self) -> List[Dict[str, Any]]:
        """Every other rank's readings, once it has freed the program's
        state; then the group is closed, on every rank at once, and each
        rank has exited."""
        reports = self.group.reports()
        self.group.close()
        deadline = time.monotonic() + self.timeout_s
        for r, p in self.procs.items():
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {r} did not exit after its "
                                   f"report") from None
        self._stop.set()
        self._watch.join()
        shutil.rmtree(self._tmp, ignore_errors=True)
        return reports

    def __enter__(self) -> "Launch":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self._kill()


def _watch_parent(parent: int) -> None:
    while True:
        time.sleep(POLL_S)
        if os.getppid() != parent:
            _log("rank 0 has gone; exiting")
            os._exit(1)


def main(argv=None) -> int:
    """One rank above 0 of a cell: the window in lockstep with rank 0,
    then its readings; prints nothing to standard output."""
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    for name, kind in (("spec", str), ("store", str), ("seed", int),
                       ("seconds", float), ("trace", int), ("device", str),
                       ("world", int), ("timeout", float), ("parent", int),
                       ("rank", int)):
        ap.add_argument(f"--{name}", type=kind, required=True)
    args = ap.parse_args(argv)
    threading.Thread(target=_watch_parent, args=(args.parent,),
                     daemon=True).start()
    import gc

    import torch

    from bench import devtrace, harness
    with open(args.spec) as f:
        spec = json.load(f)
    group = Group(torch, args.store, args.rank, args.world, args.device,
                  args.timeout)
    ctx, win = harness.window(torch, spec, args.seed, args.seconds,
                              bool(args.trace), group.device, t_start, group)
    cuda = group.device.type == "cuda"
    reading = {"peak": torch.cuda.max_memory_allocated(group.device)
               if cuda else 0,
               "busy_s": (devtrace.busy_s(win.trace)
                          if win.trace is not None else None)}
    del ctx, win
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reading["forbidden"] = harness.forbidden_modules()
    group.report(reading)
    group.close()
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(BENCH.parent), str(BENCH.parent / "src")]
    from bench import ranks
    sys.exit(ranks.main())
