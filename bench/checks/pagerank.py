"""PageRank: the port sums in float32 in its own order; the reference
sums in float64. The largest relative gap of a rank is held to a limit
set from both sides' readings (PERF.md)."""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import graph_algorithms as R

LIMITS = {"rank_gap": 2e-4}


def reference(g, params, *, dtype=torch.float64):
    """The reference's ranks for each query (all queries of one run of
    PageRank ask the same thing, so it is computed once)."""
    out, done = [], {}
    for p in params:
        key = (p["num_supersteps"], p["damping"])
        if key not in done:
            rank = R.pagerank(g.num_vertices, g.src, g.dst, *key, dtype=dtype)
            done[key] = {"score": rank.double().cpu().numpy()}
        out.append(done[key])
    return out


def compare(got, want) -> dict:
    gap = max((float(np.max(np.abs(a["score"].astype(np.float64) - b["score"])
                            / b["score"])) for a, b in zip(got, want)),
              default=0.0)
    return {"rank_gap": gap}
