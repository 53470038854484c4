"""Multi-tenant serving on the PyTorch port: versioned graphs under a
device-memory budget, with per-tenant quotas and fair-share weights.

The twin of ``examples/multi_tenant.py`` over ``repro_torch``: the same
graphs, budget, tenant policy, seeds and printed lines.

  PYTHONPATH=src python examples/torch_multi_tenant.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np

from repro_torch.core import graph as G
from repro_torch.core import partition as PT
from repro_torch.service import AdmissionError, GraphQueryService, QueryRequest


def main(device=None):
    """Print the demo's lines; return its answers: each round's (served,
    shed) per tenant, every served query's (supersteps, messages) by
    (round, tenant, index, root), the tenants' (completed, shed), the
    store's counters, and the version published with its fresh query's
    supersteps."""
    # three tenants, each with their own graph
    graphs = {f"tenant-{c}": G.uniform(1024, 8.0, seed=s).symmetrized()
              for c, s in (("a", 1), ("b", 2), ("c", 3))}

    # a budget that fits TWO of the three layouts: the store LRU-evicts
    # the coldest tenant into the HOST-SPILL tier and transparently
    # faults it back on its next query — a device re-upload, not a
    # re-partition (Platform.m_board is the real-deployment analogue;
    # spill_budget= caps the host tier, 0 disables spilling)
    per_graph = PT.partition_graph(graphs["tenant-a"], 4).device_nbytes
    svc = GraphQueryService(device=device, num_shards=4, max_batch=16,
                            slots=16, scheduling="continuous",
                            memory_budget=2.5 * per_graph)
    for gid, g in graphs.items():
        svc.add_graph(gid, g)

    # tenant policy: "a" gets 2x the slot share of "b"; "c" is rate-capped
    svc.set_tenant("tenant-a", weight=2.0)
    svc.set_tenant("tenant-b", weight=1.0)
    svc.set_tenant("tenant-c", weight=1.0, rate_qps=50, burst=5)

    out = {"rounds": [], "answers": {}}
    rng = np.random.default_rng(0)
    for round_ in range(2):
        for gid in graphs:
            roots = rng.integers(0, 1024, size=8)
            futs = [svc.submit(QueryRequest(
                gid, "bfs", {"root": int(r)}, tenant=gid,
                deadline_ms=60_000))
                for r in roots]
            svc.flush()
            shed = sum(1 for f in futs if isinstance(f.exception(),
                                                     AdmissionError))
            out["rounds"].append((round_, gid, len(futs) - shed, shed))
            for i, (r, f) in enumerate(zip(roots, futs)):
                if f.exception() is None:
                    out["answers"][round_, gid, i, int(r)] = (
                        f.result().supersteps, f.result().messages)
            print(f"round {round_} {gid}: {len(futs) - shed} served, "
                  f"{shed} shed by quota")

    snap = svc.stats_snapshot()
    out["store"] = {k: snap[k] for k in (
        "store_resident_graphs", "store_graphs", "store_spilled_graphs",
        "store_evictions", "store_faults", "store_discards",
        "store_spills")}
    out["tenants"] = {name: (t["completed"], t["shed"])
                      for name, t in snap["tenants"].items()}
    print(f"\nstore: {snap['store_resident_graphs']} of "
          f"{snap['store_graphs']} graphs resident "
          f"({snap['store_resident_bytes'] / 1e6:.2f} MB / "
          f"{snap['store_budget_bytes'] / 1e6:.2f} MB budget), "
          f"{snap['store_spilled_graphs']:.0f} spilled "
          f"({snap['store_spilled_bytes'] / 1e6:.2f} MB host), "
          f"{snap['store_evictions']:.0f} evictions, "
          f"{snap['store_faults']:.0f} faults "
          f"({snap['store_refault_upload_ms']:.1f} ms re-uploading), "
          f"{snap['store_discards']:.0f} discards")
    for name, t in snap["tenants"].items():
        print(f"  {name}: completed={t['completed']} shed={t['shed']} "
              f"p50={t['latency_p50_ms']:.1f}ms")

    # --- atomic version publish ----------------------------------------
    # re-publishing an id swaps in version N+1: in-flight queries drain
    # on N, new arrivals bind N+1, N's plans drop after the drain
    v2 = svc.publish("tenant-a", G.uniform(1024, 8.0, seed=99).symmetrized())
    res = svc.query("tenant-a", "bfs", root=0, tenant="tenant-a",
                    deadline_ms=60_000)
    out["published"] = (v2, res.supersteps)
    print(f"\npublished tenant-a v{v2}; fresh query ran "
          f"{res.supersteps} supersteps on the new graph")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
