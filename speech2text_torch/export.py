"""Deployment export of the port (port of speech2text_tpu/export.py).

- `export_frontend`: the fbank frontend (B=1, `max_seconds` of PCM) as a
  `torch.export` program, `frontend.pt2`;
- `export_asr_modules`: a transducer task's encoder forward at (1,
  `max_frames`, feat_dim), its predictor step and its joiner step at
  B=1, as `encoder.pt2`, `predictor.pt2` and `joiner.pt2`;
- `load_exported`: a `.pt2` file back as a callable module;
- `quantize_params` / `save_quantized` / `load_quantized`: the int8
  weights artifact `weights.int8.npz`, in numpy, with JAX's keys and
  arithmetic, so a file of either package loads in the other.

Kernels B1 and B2 are the custom ops `speech2text_torch::attn_weights`
and `speech2text_torch::fbank` (ops/attn_weights.py, ops/fbank.py), so a
program traced on the card launches them when it runs, and one traced
on the CPU runs their plain versions. A program keeps the device it was
traced on; `load_exported` imports speech2text_torch.ops, which
registers the ops. The weights are the program's state, not arguments
as in JAX's StableHLO.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .data.frontend import Fbank
from .utils.logging import get_logger

log = get_logger(__name__)


class _Call(nn.Module):
    """The method `method` of `owner` as the forward of a program."""

    def __init__(self, owner: nn.Module, method: str):
        super().__init__()
        self.owner = owner
        self.method = method

    def forward(self, *args):
        return getattr(self.owner, self.method)(*args)


def _export(owner: nn.Module, method: str, args, path: str) -> str:
    with torch.no_grad():
        program = torch.export.export(_Call(owner, method), tuple(args))
    torch.export.save(program, path)
    log.info("exported %s (%d bytes)", path, os.path.getsize(path))
    return path


def load_exported(path: str) -> nn.Module:
    """The program of a `.pt2` file as a module (on the device it was
    traced on)."""
    from . import ops  # noqa: F401  (registers the custom ops)
    return torch.export.load(path).module()


def export_frontend(frontend: nn.Module, export_dir: str,
                    max_seconds: float = 30.0,
                    sample_rate: int = 16000) -> str:
    """The fbank frontend, (pcm (1, N) f32, lengths (1,)) → (feats,
    lengths) at N = max_seconds · sample_rate, on its device."""
    if not isinstance(frontend, Fbank):
        raise NotImplementedError(f"export_frontend exports an fbank "
                                  f"frontend, not {type(frontend).__name__}")
    os.makedirs(export_dir, exist_ok=True)
    n = int(max_seconds * sample_rate)
    dev = frontend.window.device
    pcm = torch.zeros((1, n), dtype=torch.float32, device=dev)
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    return _export(frontend, "forward", (pcm, lens),
                   os.path.join(export_dir, "frontend.pt2"))


def export_asr_modules(task, export_dir: str,
                       max_frames: int = 2000) -> Dict[str, str]:
    """A transducer task's encoder forward ((1, max_frames, feat_dim),
    lengths) → (enc, lengths), predictor step (token (1,), state) →
    (pred_out, state) and joiner step (enc_frame (1, D), pred_out (1, D))
    → log-probs, each a program on the model's device."""
    os.makedirs(export_dir, exist_ok=True)
    model = task.model
    dev = next(model.parameters()).device
    feat_dim = task.frontend.feat_dim
    out: Dict[str, str] = {}
    feats = torch.zeros((1, max_frames, feat_dim), device=dev)
    lens = torch.tensor([max_frames], dtype=torch.int32, device=dev)
    out["encoder"] = _export(model.encoder, "forward", (feats, lens),
                             os.path.join(export_dir, "encoder.pt2"))
    token = torch.zeros((1,), dtype=torch.int64, device=dev)
    state = model.predictor.init_state(1, dev)
    out["predictor"] = _export(model.predictor, "streaming_step",
                               (token, state),
                               os.path.join(export_dir, "predictor.pt2"))
    d = model.joiner.config.input_dim
    frames = (torch.zeros((1, d), device=dev), torch.zeros((1, d), device=dev))
    out["joiner"] = _export(model.joiner, "streaming_step", frames,
                            os.path.join(export_dir, "joiner.pt2"))
    return out


# ---------------------------------------------------------------- int8
def quantize_params(params: Dict[str, Any],
                    min_size: int = 1024) -> Dict[str, np.ndarray]:
    """Symmetric int8 weights per output channel of a flax-layout tree
    (convert.to_flax): a leaf's last axis is its output channel, the
    scale max|w| / 127 over the other axes (at least 1e-12 / 127). A leaf
    that is not f32/f16, has fewer than 2 dims or fewer than `min_size`
    elements stays f32. Returns {path: int8}, {path.scale: f32} and
    {path.fp32: array}, paths joined by '/'."""
    flat: Dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(v, p)
                continue
            arr = np.asarray(v)
            if (arr.dtype not in (np.float32, np.float16)
                    or arr.ndim < 2 or arr.size < min_size):
                flat[p + ".fp32"] = arr
                continue
            red = tuple(range(arr.ndim - 1))
            scale = np.maximum(np.abs(arr).max(axis=red), 1e-12) / 127.0
            flat[p] = np.clip(np.round(arr / scale), -127,
                              127).astype(np.int8)
            flat[p + ".scale"] = scale.astype(np.float32)

    walk(params, "")
    return flat


def save_quantized(params: Dict[str, Any], path: str,
                   min_size: int = 1024) -> str:
    np.savez_compressed(path, **quantize_params(params, min_size))
    log.info("int8 weights written: %s (%d bytes)", path,
             os.path.getsize(path))
    return path


def load_quantized(path: str) -> Dict[str, Any]:
    """An int8 artifact dequantized back into a nested f32 flax tree."""
    flat = dict(np.load(path))
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        if key.endswith(".scale"):
            continue
        if key.endswith(".fp32"):
            p, val = key[:-5], arr
        else:
            p, val = key, arr.astype(np.float32) * flat[key + ".scale"]
        node = tree
        parts = p.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return tree
