"""Kernel B2's share of its roofline: the mean least time of a call
(counts.kernels.b2_least_s over the window's featurize calls, as
`b2_calls` of the counts module that the cell's configuration file
names gives them: for the flagship the speech batch and, with
mix_feats, the noise batch) over the mean device time of the B2 records
in the trace. Means per call keep the share right when the profiler
drops a record; the calls themselves are counted by the port's launch
counter."""

from s2t_bench.counts.kernels import b2_least_s

KERNELS = ("fbank_fft_kernel",)


def read(r):
    w = r.traced
    if w is None or w.trace is None or not w.launches.get("fbank"):
        return None
    durs = [o.dur for o in w.trace.ops if any(k in o.name for k in KERNELS)]
    if not durs:
        return None
    cfg = r.cell.train_config
    counts = r.cell.part("counts")
    feat = cfg["dataset"].get("feat_config") or {}
    least = [b2_least_s(B, N, n_mels=feat.get("num_mel_bins", 80))
             for s in w.steps
             for B, N in counts.b2_calls(cfg, s.batch, s.pcm_len,
                                         s.noise_len)]
    mean_least = sum(least) / len(least)
    mean_dur = sum(durs) / len(durs) / 1e9
    return 100.0 * mean_least / mean_dur
