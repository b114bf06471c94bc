"""Per-slot state one decode call reads and writes, the mean MB (10^6
bytes) over the window's decode calls: each stepped row's SSM state and
conv window of every Mamba layer, read and written, and the keys and values
of every attention layer below the row's length, read, with the new
position's written.  Counted from the family's counts (``bench/counts``:
``state_bytes_per_row`` where the family has Mamba layers,
``kv_bytes_per_slot``) and each recorded decode call's per-slot lengths; a
decode call steps every slot.  None without a decode call."""

import numpy as np

from bench.counts import dense


def read(run):
    decodes = [c for c in run.calls if c.kind == "decode"
               and c.lens is not None]
    if not decodes:
        return None
    m, slots, max_len = run.model, run.mix["slots"], run.max_len
    per_row = getattr(run.counts, "state_bytes_per_row", None)
    ssm = 2 * per_row(m) if per_row is not None else 0
    kv = getattr(run.counts, "kv_bytes_per_slot", dense.kv_bytes_per_slot)(m)
    keys = sum(int(np.minimum(np.broadcast_to(c.lens, (slots,)),
                              max_len).sum()) for c in decodes)
    return (slots * (ssm + kv) + kv * keys / len(decodes)) / 1e6
