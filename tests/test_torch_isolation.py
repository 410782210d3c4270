"""The port stands alone: it imports neither jax nor speech2text_tpu, its
kernel wrappers never compute a CUDA tensor on the CPU, and its training
and inference entry points run on the card unless the caller asks for the
CPU: with no card and no such request they raise."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from speech2text_torch.data.frontend import Fbank
from speech2text_torch.ops import attn_weights, build, fbank

PKG = Path(__file__).resolve().parents[1] / "speech2text_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
             "speech2text_tpu")


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import speech2text_torch, speech2text_torch.serve, "
        "speech2text_torch.convert, speech2text_torch.train.step, "
        "speech2text_torch.optim, speech2text_torch.losses, "
        "speech2text_torch.build_task, speech2text_torch.train.loop, "
        "speech2text_torch.data.dataset, speech2text_torch.tasks.base, "
        "speech2text_torch.tools.synth_corpus, speech2text_torch.inference, "
        "speech2text_torch.decoding, speech2text_torch.models.rnn_lm, "
        "speech2text_torch.streaming, speech2text_torch.tools.stream_demo, "
        "speech2text_torch.models.conformer, speech2text_torch.models.decoder, "
        "speech2text_torch.models.factories, speech2text_torch.ops.ctc, "
        "speech2text_torch.optim.adam, speech2text_torch.tasks.ctc, "
        "speech2text_torch.tasks.factory, speech2text_torch.ops.regularizers, "
        "speech2text_torch.models.predictor, speech2text_torch.ops.rnnt, "
        "speech2text_torch.optim.setup, speech2text_torch.tasks.rnnt, "
        "speech2text_torch.tasks.cif, speech2text_torch.tasks.ssl, "
        "speech2text_torch.tasks.nnlm, speech2text_torch.models.cif, "
        "speech2text_torch.models.best_rq, speech2text_torch.models.emformer, "
        "speech2text_torch.models.wav2vec2, "
        "speech2text_torch.tools.convert_wav2vec2, "
        "speech2text_torch.optim.setup, speech2text_torch.models.cmvn, "
        "speech2text_torch.quant, speech2text_torch.export, "
        "speech2text_torch.runtime_binding, "
        "speech2text_torch.tools.model_average, "
        "speech2text_torch.tools.prepare_manifest, "
        "speech2text_torch.onnx, speech2text_torch.onnx.convert, "
        "speech2text_torch.onnx.proto, speech2text_torch.onnx.run, "
        "speech2text_torch.onnx.quantize, speech2text_torch.parallel, "
        "speech2text_torch.parallel.mesh\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=PKG.parent, timeout=120)


def test_sources_import_no_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_cuda_tensors_take_the_kernel(monkeypatch, tmp_path):
    """A CUDA tensor is routed to the kernel, never to the plain version;
    with no build and no nvcc the wrapper raises."""
    assert build.use_kernel(torch.device("cuda")) is True
    assert build.use_kernel(torch.device("cpu")) is False
    with pytest.raises(ValueError):
        build.use_kernel(torch.device("meta"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("NVCC", str(tmp_path / "nvcc"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    kernel = build.CudaKernel("attn_weights", "attn_weights.cu")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.lib()
    if torch.cuda.is_available():
        monkeypatch.setattr(attn_weights, "KERNEL", kernel)
        monkeypatch.setattr(fbank, "KERNEL",
                            build.CudaKernel("fbank", "fbank.cu"))
        x = torch.zeros((1, 8, 1, attn_weights.KERNEL_QD), device="cuda")
        p = torch.zeros((15, 1, attn_weights.KERNEL_QD), device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            attn_weights.zip_weights(x, x, x, p, w_dtype=torch.float32)
        fb = Fbank().to("cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            fb(torch.zeros((1, 800), device="cuda"),
               torch.tensor([800], device="cuda"))
    assert kernel.launches == 0


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_trainer_raises_without_card(monkeypatch, tmp_path):
    from speech2text_torch.train.loop import Trainer, resolve_device
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None, {"platform": "cuda"})
    assert resolve_device(None, {"platform": "cpu"}).type == "cpu"
    assert resolve_device("cpu", {"platform": "cuda"}).type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(None, {"trainer": {}}, str(tmp_path / "w"))
    assert not (tmp_path / "w").exists()


def test_build_task_raises_without_card(monkeypatch, tmp_path):
    from speech2text_torch import build_task
    _no_card(monkeypatch)
    cfg = PKG.parent / "configs" / "training" / \
        "zipformer_stateless_pruned_rnnt.yaml"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_task.prepare([f"--training_config={cfg}",
                            f"--override=task.export_path={tmp_path}"])
    assert not any(tmp_path.iterdir())


def test_inference_raises_without_card(monkeypatch, tmp_path):
    from speech2text_torch import inference
    _no_card(monkeypatch)
    cfg = PKG.parent / "configs" / "inference" / \
        "zipformer_stateless_pruned_rnnt_beam_search.yaml"
    for extra in ([], ["--override=task.platform=cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            inference.prepare([f"--inference_config={cfg}",
                               f"--override=task.export_path={tmp_path}/o"]
                              + extra)
    assert not any(tmp_path.iterdir())
