"""Model FLOPs of the untraced window's steps (`step_flops` of the
counts module that the cell's configuration file names) over its length
and the card's published dense peak for the precision the model's
products run in (bf16 989 TFLOP/s; f32 67 TFLOP/s with TF32 off, 495
with it on, as torch.get_float32_matmul_precision() says)."""

from s2t_bench.counts.peaks import matmul_peak


def read(r):
    w = r.timed
    if not w.steps:
        return None
    cfg = r.cell.train_config
    counts = r.cell.part("counts")
    flops = sum(counts.step_flops(cfg, s.batch, s.pcm_len, s.label_len)
                for s in w.steps)
    peak = matmul_peak(r.cell.meta["peak_dtype"], r.float32_matmul_precision)
    return 100.0 * flops / w.seconds / peak
