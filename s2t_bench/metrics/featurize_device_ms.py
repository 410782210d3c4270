"""Device ms per step of the operations launched inside the program's
`featurize` span, in the traced window."""

SPAN = "featurize"


def read(r):
    w = r.traced
    if w is None or w.trace is None or not w.steps:
        return None
    s = w.trace.span_device_s(SPAN)
    return None if s is None else 1e3 * s / len(w.steps)
