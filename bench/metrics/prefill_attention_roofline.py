"""The prefill-attention kernel's share of its roofline: the least time its
work takes over the device time in which it ran, in the traced prefill
calls.  The kernel of ``kernels/csrc/prefill_attention.cu`` (every function
there is named ``prefill_attention_*``) runs once per attention layer of a
prefill call and computes every row of the call's (B, L) tokens, the rows it
throws away too.  Per layer its work is the causal q.K^T and p@V,
4*B*H*D*L*(L+1)/2 operations over the bf16 peak, or q, k and v read and the
output written once, B*L*(2H + 2K)*D bytes of the model's dtype over the HBM
rate, whichever takes longer.  A program without the kernel reads None."""

KERNELS = ("prefill_attention",)
ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_s(model: dict, batch: int, length: int, peaks: dict) -> float:
    """Least time of one prefill call's attention, every layer."""
    h, kh, d = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    ops = 4 * batch * h * d * length * (length + 1) // 2
    nbytes = batch * length * (2 * h + 2 * kh) * d * ELEM[model["dtype"]]
    return model["num_layers"] * max(ops / peaks["bf16_flops"],
                                     nbytes / peaks["hbm_bytes_s"])


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    least = spent = 0.0
    for t, _, call in run.traced_calls():
        if call.kind != "prefill" or call.tokens is None:
            continue
        dev_s = run.trace.busy_s(names=KERNELS, call=t)
        if dev_s <= 0:
            continue
        b, length = call.tokens.shape
        least += least_s(run.model, b, length, run.peaks)
        spent += dev_s
    return 100.0 * least / spent if spent else None
