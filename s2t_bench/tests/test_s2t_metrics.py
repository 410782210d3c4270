"""The per-layer readers on hand-made windows: spans tie device time to
the host calls that launched it, host time and the FLOP rate come from
the untraced window, idle time and rooflines from the traced one, as
worked by hand, and a reader with nothing to read returns None."""

from s2t_bench.bench import Readings, StepInfo, Window, reader
from s2t_bench.counts.kernels import b1_calls, b1_least_s, b2_least_s
from s2t_bench.counts.frames import fbank_frames
from s2t_bench.spans import merged_s
from s2t_bench.tests.tiny import ZIP
from s2t_bench.cell import load_cell
from s2t_bench.trace import DeviceOp, Intervals, Trace

MS = 1_000_000   # ns


def trace_of(ops, spans):
    opened = sorted((a, b, n) for n, iv in spans.items() for a, b in iv)
    return Trace([DeviceOp(*o) for o in ops],
                 {n: Intervals(iv) for n, iv in spans.items()}, opened,
                 (0, 100 * MS), 0)


def window(cell, trace, steps=2, launches=None, spans=None):
    s = [StepInfo(0, 4, 48000, 16, 16000, 6.0) for _ in range(steps)]
    launches = launches or {"attn_weights": 12, "fbank": 2}
    timed = Window(s, 0.1, spans or {}, launches, 3 * 2 ** 30)
    traced = Window(s, 0.1, {}, launches, 2 ** 30, trace)
    return Readings(cell, timed, traced, "highest")


def test_spans_idle_and_memory():
    spans = {"featurize": [(0, 10 * MS)], "backward": [(50 * MS, 90 * MS)],
             "encoder": [(10 * MS, 50 * MS)]}
    ops = [("fbank_fft_kernel", 1 * MS, 2 * MS, 1 * MS),
           ("gemm", 20 * MS, 10 * MS, 12 * MS),
           ("gemm", 60 * MS, 20 * MS, 55 * MS),
           ("gemm", 70 * MS, 5 * MS, 56 * MS)]     # overlaps the last
    host = {"joiner_losses": [(0, 3 * MS), (2 * MS, 4 * MS),
                              (10 * MS, 11 * MS)]}
    w = window(load_cell(ZIP), trace_of(ops, spans), spans=host)
    assert reader("featurize_device_ms")(w) == 1.0        # 2 ms / 2 steps
    assert reader("encoder_device_ms")(w) == 5.0
    assert reader("backward_device_ms")(w) == 12.5        # 25 ms / 2
    assert reader("optimizer_device_ms")(w) is None       # no such span
    # 0-4 ms merged and 10-11 ms: 5 ms over 2 untraced steps
    assert reader("joiner_losses_host_ms")(w) == 2.5
    assert merged_s(host["joiner_losses"]) == 0.005
    # busy 2 + 10 + 20 = 32 ms of 100 ms
    assert abs(reader("device_idle_pct")(w) - 68.0) < 1e-9
    assert reader("peak_mem_gib")(w) == 3.0
    # gaps 0-1, 3-20, 30-60 and 80-100 ms, each named by the span open at
    # its middle: 0.5 featurize, 11.5 and 45 encoder, 90 none
    gaps = dict(w.traced.trace.breakdown()["idle_gaps"])
    assert set(gaps) == {"featurize", "encoder",
                         "outside the program's spans"}
    assert abs(gaps["featurize"] - 0.001) < 1e-12
    assert abs(gaps["encoder"] - 0.047) < 1e-12
    assert abs(gaps["outside the program's spans"] - 0.020) < 1e-12


def test_rooflines_by_hand():
    cell = load_cell(ZIP)
    c = cell.train_config["encoder"]["config"]
    ops = [("attn_weights_mma_kernel", 0, 1 * MS, None)] * 3 + \
        [("fbank_fft_kernel", 0, 2 * MS, None)] * 2
    w = window(cell, trace_of(ops, {}))
    calls = b1_calls(c, 4, fbank_frames(48000))
    want = sum(b1_least_s(B, T, H, 32, 4) for B, T, H in calls) \
        / len(calls) / 1e-3
    assert abs(reader("b1_roofline_pct")(w) - 100 * want) < 1e-9
    b2 = (b2_least_s(4, 48000) + b2_least_s(4, 16000)) / 2 / 2e-3
    assert abs(reader("b2_roofline_pct")(w) - 100 * b2) < 1e-9


def test_silent_without_kernels():
    w = window(load_cell(ZIP), trace_of([("gemm", 0, MS, None)], {}),
               launches={"attn_weights": 0, "fbank": 0})
    assert reader("b1_roofline_pct")(w) is None
    assert reader("b2_roofline_pct")(w) is None
    assert reader("joiner_losses_host_ms")(w) is None     # no spans


def test_silent_without_a_trace():
    w = window(load_cell(ZIP), None)
    w.traced = None
    for name in ("device_idle_pct", "encoder_device_ms", "b1_roofline_pct",
                 "b2_roofline_pct", "backward_device_ms"):
        assert reader(name)(w) is None


def test_mfu_counts_every_untraced_step():
    cell = load_cell(ZIP)
    from s2t_bench.counts.zipformer import step_flops
    w = window(cell, None, steps=3)
    w.traced.steps = w.traced.steps[:1]
    flops = 3 * step_flops(cell.train_config, 4, 48000, 16)
    assert abs(reader("train_mfu_pct")(w) - 100 * flops / 0.1 / 989e12) \
        < 1e-9
