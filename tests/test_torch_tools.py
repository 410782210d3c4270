"""The port's tools (speech2text_torch/tools) on the CPU: every
ablation's text substitution still matches its kernel source, and
`device_ms` refuses a trace whose record count does not fit its calls;
the model-average CLI writes train/checkpoint.py:average_checkpoints'
average as a checkpoint that RnntServer and inference_weights load;
prepare_manifest writes the JAX tool's manifests (run as a subprocess:
its absl flags would clash with the JAX inference tests' in-process
flags) for a LibriSpeech and a tsv tree; and
optim/scaled_adam.py:dominant_parameter_report gives JAX's rows."""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
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


ROOT = Path(__file__).resolve().parents[1]
TINY = {
    "encoder": {"model": "Conformer", "config": {
        "feats_dim": 80, "subsampling_rate": 4, "input_dim": 32,
        "num_heads": 2, "ffn_dim": 64, "num_layers": 1, "output_dim": 32,
        "dropout": 0.0}},
    "decoder": {"model": "Identity", "config": {"dummy": -1}},
    "predictor": {"model": "Lstm", "config": {
        "num_symbols": 31, "output_dim": 32, "symbol_embedding_dim": 24,
        "num_lstm_layers": 2, "lstm_hidden_dim": 20}},
    "joiner": {"input_dim": 32, "output_dim": 31, "inner_dim": 16,
               "prune_range": 3},
}


def _tiny_model(seed):
    from speech2text_torch.tasks.rnnt import RnntModel
    model = RnntModel.from_config(TINY)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def test_model_average_cli(tmp_path):
    from speech2text_torch.serve import RnntServer
    from speech2text_torch.tools import model_average
    from speech2text_torch.train import checkpoint as ckpt
    ckpt_dir = tmp_path / "checkpoints"
    mgr = ckpt.CheckpointManager(str(ckpt_dir))
    for step, wer in ((1, 0.7), (2, 0.4), (3, 0.5)):
        mgr.save(step, {"model": _tiny_model(step).state_dict()},
                 {"wer": wer})
    path = model_average.main(["--checkpoints_dir", str(ckpt_dir),
                               "--best_k", "2"])
    assert path == str(ckpt_dir / "averaged" / "step_-0000001.pt")
    want = ckpt.average_checkpoints(str(ckpt_dir), best_k=2)
    got = torch.load(path, weights_only=True)["model"]
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    loaded = ckpt.inference_weights(
        {"checkpoints_dir": str(ckpt_dir / "averaged")},
        {"task": {"export_path": "x", "name": "y"}})
    assert all(torch.equal(loaded[k], want[k]) for k in want)
    infer_cfg = {"task": {"type": "rnnt_inference", "chkpt_aver": True,
                          "train_config": {
                              **TINY, "task": {"export_path": "x",
                                               "name": "y"},
                              "tokenizer": {"type": "char", "config": {}},
                              "dataset": {"feat_type": "lhotes_fbank"}}},
                 "decoding": {"type": "rnnt_greedy_search"}}
    server = RnntServer(infer_cfg, device="cpu",
                        checkpoint=str(ckpt_dir / "averaged"))
    state = server.model.state_dict()
    assert all(torch.equal(state[k], want[k]) for k in want)


def _write_tree(root, layout):
    """A synthetic corpus: wavs and transcripts in `layout`; returns the
    extra command-line arguments."""
    from speech2text_torch.data.audio import write_wav
    rng = np.random.default_rng(0)
    texts = {"84-121123-0000": "GO DO YOU HEAR", "84-121123-0001": "BUT IN",
             "174-50561-0002": "HELLO\tTHERE"}
    for utt, text in texts.items():
        spk, chap, _ = utt.split("-")
        d = root / spk / chap if layout == "librispeech" else root
        d.mkdir(parents=True, exist_ok=True)
        n = int(rng.integers(8000, 40000))
        write_wav(str(d / f"{utt}.wav"),
                  (rng.standard_normal(n) * 0.1).astype(np.float32), 16000)
        if layout == "librispeech":
            with open(d / f"{spk}-{chap}.trans.txt", "a") as f:
                f.write(f"{utt} {text}\n")
    (root / "84" / "121123" / "84-121123-0009.flac").parent.mkdir(
        parents=True, exist_ok=True)
    if layout == "librispeech":
        return []
    table = root / "table.tsv"
    table.write_text("".join(f"{u}\t{t}\n" for u, t in texts.items())
                     + "missing-utt\tnothing here\n")
    return ["--tsv", str(table)]


@pytest.mark.parametrize("layout", ["librispeech", "tsv"])
def test_prepare_manifest_equals_jax(tmp_path, layout):
    from speech2text_torch.tools import prepare_manifest
    root = tmp_path / "corpus"
    extra = _write_tree(root, layout)
    args = ["--audio_dir", str(root), "--layout", layout] + extra
    n = prepare_manifest.main(args + ["--output", str(tmp_path / "t.json")])
    subprocess.run([sys.executable, "-m",
                    "speech2text_tpu.tools.prepare_manifest", *args,
                    "--output", str(tmp_path / "j.json")], check=True,
                   cwd=ROOT, capture_output=True, timeout=120)
    got = (tmp_path / "t.json").read_bytes()
    assert got == (tmp_path / "j.json").read_bytes()
    lines = [json.loads(x) for x in got.decode().splitlines()]
    assert n == len(lines) == 3
    assert all(r["duration"] > 0 for r in lines)


def test_dominant_parameter_report_matches_jax():
    from speech2text_tpu.optim.scaled_adam import \
        dominant_parameter_report as jax_report
    from speech2text_torch.convert import to_flax
    from speech2text_torch.optim.scaled_adam import dominant_parameter_report
    model = _tiny_model(5)
    gen = torch.Generator().manual_seed(6)
    grads = {n: torch.randn(p.shape, generator=gen) * (1 + i % 7)
             for i, (n, p) in enumerate(model.named_parameters())
             if p.requires_grad}
    got = dominant_parameter_report(model, grads, top_k=1000)
    want = jax_report(to_flax(model, grads),
                      to_flax(model, dict(model.named_parameters())),
                      top_k=1000)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([f for _, f in got], [f for _, f in want],
                               rtol=0, atol=1e-6)
    assert dominant_parameter_report(model, grads, top_k=12) == got[:12]
    assert "predictor/rnns_1/cell/hg/kernel" in [n for n, _ in got]
