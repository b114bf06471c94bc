"""Host time inside one slot-prefill call (placement, graph replay,
copies, credit wait), the mean over the untraced window's prefill calls."""


def read(run):
    calls, _, _ = run.clean()
    ts = [c.t1 - c.t0 for c in calls if c.kind == "prefill"]
    return sum(ts) / len(ts) * 1e3 if ts else None
