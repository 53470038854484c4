"""K1 (``segment_combine_kernel``) against its memory roofline: the least
time its launches need over their measured device time, in percent.

Bytes come from the benchmark's graph, not the port's padded layout:
each edge's destination index read once (4 B), and for each of the
launch's B queries each message value read once (4 B an edge) and each
vertex's output written once (4 B a vertex), at the card's published
HBM rate. B is the cell's batch (1 for a call of ``Engine.run``).

K1 is the one-card engine's kernel: on more than one rank the launches of
``segment_combine_kernel`` are K2's, each over one shard, which these
bytes do not count, so there is nothing to read."""
from bench.metrics._common import hbm_bytes_per_s

KERNEL = "segment_combine_kernel"


def launch_bytes(num_vertices: int, num_edges: int, batch: int) -> int:
    return 4 * num_edges + batch * (4 * num_edges + 4 * num_vertices)


def read(run):
    trace, rate = run["trace"], hbm_bytes_per_s(run)
    if trace is None or rate is None or run["ctx"].world > 1:
        return None
    k1 = [(a, b) for name, a, b in trace.in_window() if KERNEL in name]
    if not k1:
        return None
    g = run["ctx"].graph
    batch = max(1, int(run["ctx"].traffic.get("batch", 0)))
    least_s = len(k1) * launch_bytes(g.num_vertices, g.num_edges,
                                     batch) / rate
    return 100.0 * least_s / (sum(b - a for a, b in k1) / 1e6)
