"""Lanes the continuous slot array kept busy a device superstep: the
supersteps of every query retired in the window (from its ``retire``
event) over the device supersteps the service ran (``supersteps_total``
over the window and its drain)."""


def read(run):
    events = run["counters"].get("events")
    steps = run["counters"].get("supersteps")
    if not events or not steps:
        return None
    lane_steps = sum(int(e.attrs.get("supersteps", 0)) for e in events
                     if e.kind == "retire"
                     and e.attrs.get("reason", "retired") == "retired")
    return lane_steps / steps
