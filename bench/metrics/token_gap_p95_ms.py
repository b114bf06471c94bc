"""95th percentile, over every interval in the window, of the host time
between two consecutive decode-step returns: the gap each running request
sees between two of its tokens, a refill prefill queued between them
included."""

from bench.harness import p95


def read(run):
    ends = [c.t1 for c in run.calls if c.kind == "decode"]
    gaps = [b - a for a, b in zip(ends, ends[1:])]
    return p95(gaps) * 1e3 if len(gaps) >= 20 else None
