"""The port's measurement tools (speech2text_torch/tools) on the CPU: every
ablation's text substitution still matches its kernel source, and
`device_ms` refuses a trace whose record count does not fit its calls."""

import contextlib

import pytest
import torch

from speech2text_torch.ops import attn_weights as aw
from speech2text_torch.ops import fbank as fb
from speech2text_torch.tools import ablate, timing

KERNELS = {"attn_weights": (aw.KERNEL, ablate.ATTN_VARIANTS),
           "fbank": (fb.KERNEL, ablate.FBANK_VARIANTS)}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_ablation_variants_match_sources(name, tmp_path):
    kernel, variants = KERNELS[name]
    kernels = ablate.variant_kernels(kernel, variants, tmp_path)
    assert set(kernels) == set(variants)
    base = kernel.source.read_text()
    assert kernels["base"].source.read_text() == base
    for v, k in kernels.items():
        assert k.entries == kernel.entries
        if v != "base":
            assert k.source.read_text() != base, v
    stale = {"stale": [("no such line in the source", "")]}
    with pytest.raises(ValueError, match="occurs 0 times"):
        ablate.variant_kernels(kernel, stale, tmp_path)


@pytest.mark.parametrize("records,ok", [(26, False), (27, True), (30, True),
                                        (31, False)])
def test_device_ms_record_count(monkeypatch, records, ok):
    """Up to a tenth of the 30 records may be missing; the median is over
    the records there are."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    # a CPU-only torch build traces no CUDA activity: the trace is stubbed
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: contextlib.nullcontext())
    monkeypatch.setattr(timing, "kernel_durations_ms",
                        lambda prof, name: [0.5] * (records - 1) + [9.0])
    calls = []
    if ok:
        assert timing.device_ms(lambda: calls.append(1), "k") == 0.5
        assert len(calls) == 40
    else:
        with pytest.raises(RuntimeError, match=f"holds {records} kernels"):
            timing.device_ms(lambda: calls.append(1), "k")


@pytest.mark.parametrize("counts,want_calls", [((23, 30), 70),
                                               ((20, 26, 27), 100)])
def test_device_ms_retakes_a_short_trace(monkeypatch, counts, want_calls):
    """A trace short of records is taken again (up to three traces)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: contextlib.nullcontext())
    seq = iter(counts)
    monkeypatch.setattr(timing, "kernel_durations_ms",
                        lambda prof, name: [0.25] * next(seq))
    calls = []
    assert timing.device_ms(lambda: calls.append(1), "k") == 0.25
    assert len(calls) == want_calls
