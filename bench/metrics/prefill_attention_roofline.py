"""The prefill-attention kernel's share of its roofline: the least time its
work takes over the device time in which it ran, in the traced part.  The
kernel of ``kernels/csrc/prefill_attention.cu`` (every function there is
named ``prefill_attention_*``) runs once per attention layer of a prefill
call, in every prefill of the one-card bf16 path, and computes every row of
the call's (B, L) tokens, the rows it throws away too.  Its work is the
family's count (``prefill_attention_bytes_ops``) of every traced prefill
call: operations over the bf16 peak, or bytes over the HBM rate, whichever
takes longer.  Its time is every launch in the profile, wherever the
profile's clock puts it: that clock can run tenths of a second apart from
the host's within one traced part, which moves a call's kernels into later
calls, while the traced part starts and stops between engine calls, which
block until their work is done.  A program without the kernel reads None."""

from bench.trace import union_s

KERNELS = ("prefill_attention",)


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    spent = union_s([(a, b) for name, a, b in run.trace.device
                     if any(k in name for k in KERNELS)])
    if spent <= 0:
        return None
    least = 0.0
    for _, _, call in run.traced_calls():
        if call.kind != "prefill" or call.tokens is None:
            continue
        b, length = call.tokens.shape
        nbytes, ops = run.counts.prefill_attention_bytes_ops(
            run.model, b, length)
        least += max(nbytes / run.peaks["hbm_bytes_s"],
                     ops / run.peaks["bf16_flops"])
    return 100.0 * least / spent if least else None
