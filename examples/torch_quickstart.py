"""Quickstart on the PyTorch port: weakly connected components on an RMAT
graph with GraVF-M, on an NVIDIA GPU.

The twin of ``examples/quickstart.py`` over ``repro_torch``: the same
graph, partition and printed lines. The user-facing algorithm definition
lives in repro_torch/core/algorithms.py (the same WCC the paper uses as
its worked example); here we generate a graph, partition it, run both
architectures, and print the measured communication the §4.1
optimization saves. The engines run their kernel path: the hand-written
CUDA segment-combine on the card, its plain PyTorch version on the CPU.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np

from repro_torch.core import algorithms as ALG
from repro_torch.core import graph as G
from repro_torch.core import partition as PT
from repro_torch.core.engine import Engine


def main(device=None):
    """Print the quickstart's lines; return each mode's (components,
    supersteps, traversed edges) and the GraVF-M run's comm dict."""
    g = G.rmat(12, 16, seed=0).symmetrized()
    print(f"graph: |V|={g.num_vertices} |E|={g.num_edges} "
          f"avg_degree={g.avg_degree:.1f}")
    pg = PT.partition_graph(g, num_parts=4, method="greedy")
    print(f"partitioned into {pg.num_parts} shards; "
          f"balance={PT.edge_balance(pg)}")

    out = {}
    for mode in ("gravf", "gravfm"):
        res = Engine(ALG.wcc(), pg, mode=mode, device=device).run()
        n_comp = len(np.unique(res.state["label"]))
        out[mode] = (n_comp, res.supersteps, res.messages)
        print(f"[{mode:6s}] components={n_comp} supersteps={res.supersteps}"
              f" traversed_edges={res.messages}")
        if mode == "gravfm":
            c = res.comm
            out["comm"] = dict(c)
            print(f"         network words: unicast(GraVF)="
                  f"{c['unicast_words']:.0f} "
                  f"broadcast+filter(GraVF-M)="
                  f"{c['bcast_filtered_words']:.0f} "
                  f"-> {c['unicast_words']/max(c['bcast_filtered_words'],1):.1f}x less traffic")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
