"""Model FLOPs of the untraced window's tokens over its seconds, as a
share of the card's bf16 peak: the prompts of the rows each prefill
refilled and each decode token of an occupied row, attention included
(``bench/counts/<family>.py``); rows the program computes and throws away
do not count."""


def read(run):
    if run.peaks is None:
        return None
    calls, _, seconds = run.clean()
    c, m = run.counts, run.model
    flops = 0
    for call in calls:
        for _, r, pos in call.rows:
            flops += (c.prefill_flops(m, pos) if call.kind == "prefill"
                      else c.decode_flops(m, pos))
    return 100.0 * flops / (seconds * run.peaks["bf16_flops"])
