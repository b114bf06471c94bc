"""Share of the untraced window in which no device activity ran.

The profiler slows the host inside every call it traces, so the traced
span's own idle share is partly the profiler's.  The trace gives only the
device's time: each traced call's device seconds, and those between calls.
They are carried over to the untraced part of the window, whose calls and
seconds keep the host's own pace: a decode call takes the traced decode
calls' mean; a prefill call the traced prefills' device seconds per FLOP
of the batch each ran (every row, at the call's prompt length;
``bench/counts``); each host gap between calls the traced gaps' mean.
Their sum against the untraced seconds leaves the idle share."""


def work(run, call) -> float:
    """What a call's device time scales with."""
    if call.kind != "prefill":
        return 1.0
    rows, length = call.tokens.shape
    return float(rows * run.counts.prefill_flops(run.model, length))


def read(run):
    trace = run.trace
    traced = run.traced_calls()
    if trace is None or not trace.device or len(traced) < 2:
        return None
    rate, inside = {}, 0.0
    for t, _, call in traced:
        busy = trace.busy_s(call=t)
        inside += busy
        b, w = rate.get(call.kind, (0.0, 0.0))
        rate[call.kind] = (b + busy, w + work(run, call))
    between = (trace.busy_s() - inside) / (len(traced) - 1)
    calls, gaps, seconds = run.clean()
    busy = between * len(gaps)
    for call in calls:
        if call.kind not in rate:
            return None
        b, w = rate[call.kind]
        busy += b / w * work(run, call)
    return 100.0 * (1.0 - busy / seconds)
