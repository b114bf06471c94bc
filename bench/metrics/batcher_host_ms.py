"""Host time of the batcher (scheduler, calibrator, queue, slots) per
engine call: the untraced window's time outside engine calls over the
gaps it holds."""


def read(run):
    _, gaps, _ = run.clean()
    return sum(gaps) / len(gaps) * 1e3 if gaps else None
