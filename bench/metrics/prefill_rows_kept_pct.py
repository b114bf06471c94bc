"""Share of the rows the window's prefills computed that placed a request:
the rows set in each prefill call's slot mask over the rows of the masks
(every prefill computes all the slots' rows), over the whole window.
Silent for a window without a prefill."""


def read(run):
    masks = [c.mask for c in run.calls if c.kind == "prefill"]
    computed = sum(len(m) for m in masks)
    if not computed:
        return None
    return 100.0 * sum(int(m.sum()) for m in masks) / computed
