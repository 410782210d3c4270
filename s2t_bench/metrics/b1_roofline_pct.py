"""Kernel B1's share of its roofline: the mean least time of a call
(counts.kernels.b1_least_s over the window's calls, one per Zipformer2
layer, shapes from the batches) over the mean device time of the B1
records in the trace. Means per call keep the share right when the
profiler drops a record; the calls themselves are counted by the port's
launch counter."""

from s2t_bench.counts.frames import fbank_frames
from s2t_bench.counts.kernels import b1_calls, b1_least_s

KERNELS = ("attn_weights_mma_kernel", "attn_weights_fma_kernel")


def read(r):
    w = r.traced
    if w is None or w.trace is None or \
            not w.launches.get("attn_weights"):
        return None
    enc = r.cell.train_config["encoder"]
    if enc["model"] != "Zipformer":
        return None
    durs = [o.dur for o in w.trace.ops if any(k in o.name for k in KERNELS)]
    if not durs:
        return None
    c = enc["config"]
    nbytes = 2 if c.get("dtype") == "bfloat16" else 4
    least = [b1_least_s(B, T, H, c["query_head_dim"], c["pos_head_dim"],
                        nbytes)
             for s in w.steps
             for B, T, H in b1_calls(c, s.batch, fbank_frames(s.pcm_len))]
    mean_least = sum(least) / len(least)
    mean_dur = sum(durs) / len(durs) / 1e9
    return 100.0 * mean_least / mean_dur
