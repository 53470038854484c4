"""95th percentile of a query's wait in the service's queue: from its
``submit`` event to its ``admit`` (or, answered from the result cache,
its ``retire``), over every query of the traced window."""
import numpy as np



def read(run):
    events = run["counters"].get("events")
    if not events:
        return None
    submit, left = {}, {}
    for e in sorted(events, key=lambda e: e.ts):
        if e.qid is None:
            continue
        if e.kind == "submit":
            submit[e.qid] = e.ts
        elif e.kind in ("admit", "retire", "shed") and e.qid not in left:
            left[e.qid] = e.ts
    waits = [1e3 * (left[q] - t) for q, t in submit.items() if q in left]
    return float(np.percentile(waits, 95)) if waits else None
