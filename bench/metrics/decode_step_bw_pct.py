"""Bytes one decode step needs, counted once (``bench/counts``: the
weights its tokens use, for an MoE the experts the benchmark's own router
picked for them, the occupied rows' live cache read and their new keys and
values written), over the HBM rate, as a share of the step's device time
(every device activity inside the traced decode calls)."""


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    moe = run.model.get("num_experts", 0) > 0
    need = busy = 0.0
    for t, i, call in run.traced_calls():
        if call.kind != "decode" or not call.rows:
            continue
        experts = run.experts.get(i) if moe else None
        step = run.trace.busy_s(call=t)
        if (moe and experts is None) or step <= 0:
            continue
        need += run.counts.decode_step_bytes(
            run.model, [pos for _, _, pos in call.rows], experts) \
            / run.peaks["hbm_bytes_s"]
        busy += step
    return 100.0 * need / busy if busy else None
