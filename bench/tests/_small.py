"""The cells at sizes a CPU test run holds: the same loops, checks and
readers, a tiny graph and a short window."""
from __future__ import annotations

import copy

from bench import harness

# graph parameters and traffic overrides of each cell's small version
SMALL = {
    "g500-s20-bfs-sssp-open": ({"scale": 8}, {"rate_qps": 120.0}),
    "roadpa-sssp8-closed": ({"side": 16}, {}),
    "g500-s20-pagerank-closed": ({"scale": 8}, {}),
}
SECONDS = 1.0

# A cell whose files are in bench/ but whose entry BENCHMARK.json does not
# hold yet (its latency spreads past what a bound allows; PERF.md, Open
# questions): its entry and metrics as they would go there, so that its
# loop, checks and readers stay tested.
PENDING = {
    "g500-s20-bfs-sssp-open": {
        "entry": {"name": "g500-s20-bfs-sssp-open", "config": "graph500-rmat20",
                  "traffic": "bfs3-sssp1-poisson", "chips": 1},
        "end_to_end": {"latency_p50_ms": "ms", "latency_p95_ms": "ms",
                       "device_mem_peak_gib": "GiB", "setup_s": "s"},
        "per_layer": {"service.queue_ms.p95": "ms",
                      "service.lanes_per_superstep": "lanes",
                      "device.idle_share.serve": "share"},
    },
}


def cell(workload: str) -> dict:
    """``harness.cell``, or the pending cell's entry read the same way."""
    if any(w["name"] == workload for w in harness.manifest()["workloads"]):
        return harness.cell(workload)
    out = copy.deepcopy(PENDING[workload])
    entry = out["entry"]
    out["config"] = harness._json(
        harness.BENCH / "configs" / f"{entry['config']}.json")
    out["traffic"] = harness._json(
        harness.BENCH / "traffic" / f"{entry['traffic']}.json")
    return out


def spec(workload: str) -> dict:
    out = copy.deepcopy(cell(workload))
    graph, traffic = SMALL[workload]
    out["config"]["graph"]["params"].update(graph)
    out["traffic"].update(traffic)
    return out


def run(workload: str, seed: int = 7, trace: bool = False, **kw) -> dict:
    return harness.run_cell(workload, seed, SECONDS, trace, device="cpu",
                            spec=spec(workload), log=lambda s: None, **kw)


# The four-rank small cell: the paper's four-node deployment as the next
# configuration would state it (PERF.md, Open questions), one partition a
# rank, the allgather exchange, PageRank-30 by ``closed_shard``; over gloo,
# each rank a CPU process.
RANKS = 4


def shard_spec() -> dict:
    out = copy.deepcopy(cell("g500-s20-pagerank-closed"))
    out["entry"] = {"name": "g500-s10-shard4-pagerank-closed",
                    "config": "graph500-rmat10-shard4",
                    "traffic": "pagerank30-closed-shard", "chips": RANKS}
    out["config"]["graph"]["params"]["scale"] = 10
    out["config"]["deployment"] = {"parts": RANKS, "partition": "greedy",
                                   "exchange": "allgather"}
    out["traffic"]["loop"] = "closed_shard"
    return out


def run_ranks(seed: int = 7, trace: bool = False, device: str = "cpu",
              **kw) -> dict:
    """The four-rank small cell through ``run_cell``, this process rank 0
    (the tests run it in a process of its own)."""
    return harness.run_cell(shard_spec()["entry"]["name"], seed, SECONDS,
                            trace, device=device, spec=shard_spec(), **kw)
