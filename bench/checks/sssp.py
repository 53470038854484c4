"""SSSP: distances are float32 sums along a path, and the reference forms
the same sums, so every distance and parent must be equal; the largest
relative gap of a distance is held to its limit as well."""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import graph_algorithms as R

LIMITS = {"mismatch": 0, "dist_gap": 0.0}
BATCH = 8


def reference(g, params, *, dtype=torch.float32):
    """The reference's distances and parents, each sum rounded to
    ``dtype``."""
    out = []
    for i in range(0, len(params), BATCH):
        roots = torch.tensor([p["root"] for p in params[i:i + BATCH]],
                             device=g.src.device)
        dist, parent = R.sssp(g.num_vertices, g.src, g.dst, g.w, roots,
                              dtype=dtype)
        out += [{"dist": d, "parent": p} for d, p in
                zip(dist.cpu().numpy(), parent.cpu().numpy())]
    return out


def dist_gap(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| / want over vertices both reach (want > 0)."""
    both = np.isfinite(got) & np.isfinite(want) & (want > 0)
    if not both.any():
        return 0.0
    g, w = got[both].astype(np.float64), want[both].astype(np.float64)
    return float(np.max(np.abs(g - w) / w))


def compare(got, want) -> dict:
    mismatch = sum(np.count_nonzero((a["dist"] != b["dist"])
                                    | (a["parent"] != b["parent"]))
                   for a, b in zip(got, want))
    gap = max((dist_gap(a["dist"], b["dist"]) for a, b in zip(got, want)),
              default=0.0)
    return {"mismatch": int(mismatch), "dist_gap": gap}
