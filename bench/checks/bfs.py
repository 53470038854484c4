"""BFS: every parent must equal the reference's (the rule is exact)."""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import graph_algorithms as R

LIMITS = {"mismatch": 0}
BATCH = 4


def reference(g, params, *, dtype=None):
    """The reference's parents for each query's ``root``."""
    out = []
    for i in range(0, len(params), BATCH):
        roots = torch.tensor([p["root"] for p in params[i:i + BATCH]],
                             device=g.src.device)
        out += [{"parent": p} for p in
                R.bfs(g.num_vertices, g.src, g.dst, roots).cpu().numpy()]
    return out


def compare(got, want) -> dict:
    return {"mismatch": int(sum(np.count_nonzero(a["parent"] != b["parent"])
                                for a, b in zip(got, want)))}
