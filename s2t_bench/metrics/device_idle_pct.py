"""Share of the traced window in which no operation ran on the card
(the trace records CUDA activity only)."""


def read(r):
    w = r.traced
    if w is None or w.trace is None or not w.trace.ops:
        return None
    return 100.0 * max(0.0, 1.0 - w.trace.busy_s / w.seconds)
