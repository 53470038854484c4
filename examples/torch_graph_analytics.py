"""Graph-analytics suite on the PyTorch port: BFS, WCC, PageRank, SSSP on
several datasets — the paper's §6 benchmark set end-to-end, printing
per-algorithm stats.

The twin of ``examples/graph_analytics.py`` over ``repro_torch``: the
same datasets, seeds and printed lines. The engines run their kernel
path (the CUDA segment-combine on the card, its plain version on the
CPU); ``wall`` ends when the device has finished.

  PYTHONPATH=src python examples/torch_graph_analytics.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import time

import torch

from repro_torch.core import algorithms as ALG
from repro_torch.core import graph as G
from repro_torch.core import partition as PT
from repro_torch.core.engine import Engine, resolve_device

DATASETS = {
    "uniform-16": lambda: G.uniform(4096, 16.0, seed=0).symmetrized(),
    "rmat-8": lambda: G.rmat(12, 8, seed=1).symmetrized(),
    "road": lambda: G.road(64, seed=2),
}

ALGOS = {
    "bfs": lambda: ALG.bfs(0),
    "wcc": ALG.wcc,
    "pagerank": lambda: ALG.pagerank(20),
    "sssp": lambda: ALG.sssp(0),
}


def main(device=None):
    """Print the suite's lines; return {(dataset, algorithm): (supersteps,
    traversed edges)}."""
    device = resolve_device(device)
    out = {}
    for dname, gfn in DATASETS.items():
        g = gfn()
        if "sssp" in ALGOS and g.weights is None:
            g = g.with_unit_weights()
        pg = PT.partition_graph(g, 4, method="greedy")
        print(f"== {dname}: |V|={g.num_vertices} |E|={g.num_edges}")
        for aname, kfn in ALGOS.items():
            eng = Engine(kfn(), pg, mode="gravfm", device=device)
            t0 = time.perf_counter()
            res = eng.run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            out[(dname, aname)] = (res.supersteps, res.messages)
            print(f"   {aname:9s} supersteps={res.supersteps:4d} "
                  f"edges_traversed={res.messages:9d} "
                  f"wall={dt*1e3:7.1f}ms")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
