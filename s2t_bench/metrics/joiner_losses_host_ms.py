"""Host ms per step inside the program's `joiner_losses` spans (the
predictor, the joiner with the simple loss and prune ranges, the pruned
loss), their intervals merged, by the span clock over the untraced
window."""

from s2t_bench.spans import merged_s

SPAN = "joiner_losses"


def read(r):
    w = r.timed
    iv = w.spans.get(SPAN)
    if not iv or not w.steps:
        return None
    return 1e3 * merged_s(iv) / len(w.steps)
