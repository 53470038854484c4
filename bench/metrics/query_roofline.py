"""A whole PageRank iteration against the memory roofline, over the
measured window: the least bytes an iteration needs, counted from the
graph's shapes (CSR column indices and offsets read once, ranks and
out-degrees read once, ranks written once, 4 B each) times the
iterations completed, over the published HBM rate of every card the cell
uses times the window, in percent. The count depends on the work alone,
so no implementation reads above 100 %."""
from bench.metrics._common import hbm_bytes_per_s



def iteration_bytes(num_vertices: int, num_edges: int) -> int:
    return 4 * num_edges + 4 * (num_vertices + 1) + 3 * 4 * num_vertices


def read(run):
    rate = hbm_bytes_per_s(run)
    win = run["window"]
    iters = sum(int(q.params.get("num_supersteps", 0)) for q in win.queries
                if q.kernel == "pagerank" and q.done is not None
                and not q.traced)
    quiet_s = win.window_s - run["counters"].get("profiled_s", 0.0)
    if rate is None or not iters or quiet_s <= 0:
        return None
    g = run["ctx"].graph
    return (100.0 * iters * iteration_bytes(g.num_vertices, g.num_edges)
            / (rate * run["ctx"].world * quiet_s))
