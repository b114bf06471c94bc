"""Host time inside one decode call, the mean over the untraced window's
decode calls."""


def read(run):
    calls, _, _ = run.clean()
    ts = [c.t1 - c.t0 for c in calls if c.kind == "decode"]
    return sum(ts) / len(ts) * 1e3 if ts else None
