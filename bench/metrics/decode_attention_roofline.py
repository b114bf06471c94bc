"""The fused decode-attention kernels' share of their roofline: the least
time their work takes (bytes counted once from the per-slot lengths each
decode call was given, over the HBM rate, or operations over the bf16
peak, whichever is longer) over the device time in which one of them ran,
in the traced decode calls.  The kernels of
``kernels/csrc/decode_attention.cu``: one call runs ``scores``, at times
``stats``, then ``pv``."""

KERNELS = ("decode_attention_scores", "decode_attention_stats",
           "decode_attention_pv")


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    least = spent = 0.0
    for t, _, call in run.traced_calls():
        if call.kind != "decode":
            continue
        dev_s = run.trace.busy_s(names=KERNELS, call=t)
        if dev_s <= 0:
            continue
        nbytes, ops = run.counts.decode_attention_bytes_ops(
            run.model, call.lens.tolist(), run.max_len)
        least += max(nbytes / run.peaks["hbm_bytes_s"],
                     ops / run.peaks["bf16_flops"])
        spent += dev_s
    return 100.0 * least / spent if spent else None
