"""Deployment export of the port (port of speech2text_tpu/export.py).

- `export_frontend`: the fbank frontend (B=1, `max_seconds` of PCM) as a
  `torch.export` program, `frontend.pt2`;
- `export_asr_modules`: a transducer task's encoder forward at (1,
  `max_frames`, feat_dim), its predictor step and its joiner step at
  B=1, as `encoder.pt2`, `predictor.pt2` and `joiner.pt2`;
- `export_streaming_session`: a StreamingAsrSession's whole chunk path
  (raw PCM → fbank → CMVN → Zipformer2 streaming prime/step → greedy
  continuation) as `stream_prime.pt2` and `stream_step.pt2`, with
  `streaming_spec.json`;
- `export_onnx_modules`: the transducer trio as ONNX graphs
  (`encoder.onnx`, `predictor.onnx`, `joiner.onnx`, a Zipformer2's
  streaming `encoder_stream.onnx` with `encoder_stream_spec.json`, their
  dynamic-int8 `*_int8.onnx` variants and `units.txt`) through the
  port's own emitter (speech2text_torch/onnx);
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

import copy
import json
import os
from typing import Any, Dict, List

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


# --------------------------------------------------------- streaming
class _SessionChunk(nn.Module):
    """A session's prime or step chunk as the forward of a program; the
    task (and so every weight) is a submodule."""

    def __init__(self, session, prime: bool):
        super().__init__()
        self.task = session.task
        self._session = session
        self._prime = prime

    def forward(self, pcm: torch.Tensor, state: Dict[str, Any]):
        return self._session.program_chunk(pcm, state, self._prime)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _spec(tree):
    return _tree_map(lambda t: {"shape": list(t.shape),
                                "dtype": _dtype_name(t.dtype)}, tree)


def export_streaming_session(session, export_dir: str,
                             batch_size: int = 1) -> Dict[str, str]:
    """A StreamingAsrSession's chunk path as two programs, as JAX's
    export_streaming_session writes them: `stream_prime.pt2` (pcm (B,
    prime_samples), state) → state and `stream_step.pt2` (pcm (B,
    step_samples), state) → state, each raw PCM → the session's fbank
    (kernel B2, the custom op speech2text_torch::fbank) → CMVN →
    Zipformer2 streaming_prime / streaming_step → the greedy transducer
    continuation unrolled over the chunk's frames. The state is
    `session.program_state`'s tree, JAX's: the prime program takes
    `pred_out` None and primes the predictor. `streaming_spec.json`
    holds JAX's keys: the chunk arithmetic and the state's shapes and
    dtypes before and after the prime.

    Unlike JAX's StableHLO, whose weights are arguments, a program holds
    the session's weights as its state and keeps the session's device:
    traced on the card, it launches B2 when it runs."""
    os.makedirs(export_dir, exist_ok=True)
    B = batch_size
    dev = session.device
    with torch.no_grad():
        # clones: the session builds its state under inference mode
        state0 = _tree_map(torch.clone, session.program_state(
            batch_size=B))
        pcm = torch.zeros((B, session.prime_samples), device=dev)
        state1 = _tree_map(torch.clone, session.program_chunk(
            pcm, state0, prime=True))
        out: Dict[str, str] = {}
        for key, prime, args in (
                ("prime", True, (pcm, state0)),
                ("step", False, (torch.zeros((B, session.step_samples),
                                             device=dev),
                                 _tree_map(torch.zeros_like, state1)))):
            path = os.path.join(export_dir, f"stream_{key}.pt2")
            program = torch.export.export(_SessionChunk(session, prime),
                                          args)
            torch.export.save(program, path)
            log.info("exported %s (%d bytes)", path, os.path.getsize(path))
            out[key] = path
    spec_path = os.path.join(export_dir, "streaming_spec.json")
    with open(spec_path, "w") as f:
        json.dump({
            "batch_size": B,
            "chunk_size": session.chunk,
            "left_context_chunks": session.left_chunks,
            "prime_samples": session.prime_samples,
            "step_samples": session.step_samples,
            "max_tokens": session.cap,
            "init_state": _spec(state0),
            "state_after_prime": _spec(state1),
        }, f, indent=1, default=str)
    out["spec"] = spec_path
    return out


# -------------------------------------------------------------- ONNX
def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a state tree in jax.tree_util's order: dict keys
    sorted, lists and tuples in order, None holds no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _unflatten(template, leaves: List[torch.Tensor]):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)
    return build(template)


class _OnnxCall(nn.Module):
    """`fn(*args)` with its outputs flattened in jax.tree_util's order and
    integer outputs cast to int32, the dtype of JAX's graph interfaces."""

    def __init__(self, owner: nn.Module, fn):
        super().__init__()
        self.owner = owner
        self._fn = fn

    def forward(self, *args):
        return tuple(t if t.is_floating_point() else t.to(torch.int32)
                     for t in _leaves(self._fn(*args)))


def f32_model(task) -> nn.Module:
    """An f32 copy of the task's model on the CPU: rebuilt from the config
    with every `dtype` and `score_dtype` set to float32 (so no module
    casts to bfloat16 inside), holding the weights cast to f32."""
    from .tasks.rnnt import RnntModel

    def f32(tree):
        if isinstance(tree, dict):
            return {k: ("float32" if k in ("dtype", "score_dtype")
                        else f32(v)) for k, v in tree.items()}
        return tree
    cfg = dict(task.config)
    for section in ("encoder", "decoder", "predictor", "joiner"):
        if cfg.get(section) is not None:
            cfg[section] = f32(copy.deepcopy(cfg[section]))
    model = RnntModel.from_config(cfg)
    model.load_state_dict({k: v.detach().float().cpu()
                           if v.is_floating_point() else v.detach().cpu()
                           for k, v in task.model.state_dict().items()})
    return model.eval()


def export_onnx_modules(task, export_dir: str, max_frames: int = 2000,
                        int8: bool = True,
                        tokenizer=None) -> Dict[str, str]:
    """A transducer task's deployment trio as ONNX graphs, as JAX's
    export_onnx_modules writes them (the same files, graph input and
    output names and dtypes, metadata_props and quantized op sets):

    - `encoder.onnx`: feats (1, max_frames, feat_dim) f32, feat_lens (1,)
      int32 → encoder_out, encoder_out_lens int32;
    - `predictor.onnx`: token (1,) int32 and the predictor state's
      tensors state_{i} → output_0 (pred_out (1, 1, D)) and the new
      state's tensors output_{i};
    - `joiner.onnx`: encoder_frame (1, D), predictor_out (1, D) → logit
      (log-probs);
    - for a Zipformer2 encoder, `encoder_stream.onnx`: feats_chunk (1,
      2·chunk, feat_dim) and the streaming state's tensors state_{i}, in
      jax.tree_util's order (dict keys sorted; `processed` an int32
      scalar) → encoder_out and new_state_{i}, with
      `encoder_stream_spec.json`; chunk and left context from the
      config's `metric.streaming_chunk_size` (16) and
      `streaming_left_chunks` (4);
    - with `int8`, each graph's dynamic-int8 `*_int8.onnx` (MatMul, and
      Gather for the predictor);
    - `units.txt` of the tokenizer (default: the task's).

    The graphs come from an f32 copy of the model on the CPU, its weights
    baked as initializers; kernel B1's custom op is decomposed into its
    plain version, so no graph holds a custom-op node."""
    from .models.zipformer import Zipformer2
    from .onnx import convert, quantize_dynamic
    model = task.model
    if not (hasattr(model, "predictor") and hasattr(model, "joiner")):
        raise ValueError("onnx_export needs a transducer task "
                         "(encoder + predictor + joiner); got "
                         f"{type(model).__name__}")
    os.makedirs(export_dir, exist_ok=True)
    model = f32_model(task)
    feat_dim = task.frontend.feat_dim
    out: Dict[str, str] = {}

    def emit(name, owner, fn, args, input_names, output_names, quant_ops,
             metadata=None):
        with torch.no_grad():
            program = torch.export.export(_OnnxCall(owner, fn), tuple(args))
        data = convert(program, name, input_names=input_names,
                       output_names=output_names,
                       # the contract of JAX's graphs, so that a consumer
                       # reads the same props from either package's files
                       metadata={"framework": "speech2text_tpu",
                                 "module": name, **(metadata or {})})
        path = os.path.join(export_dir, f"{name}.onnx")
        with open(path, "wb") as f:
            f.write(data)
        log.info("exported %s (%d bytes)", path, len(data))
        out[name] = path
        if int8:
            qdata = quantize_dynamic(data, quant_ops)
            qpath = os.path.join(export_dir, f"{name}_int8.onnx")
            with open(qpath, "wb") as f:
                f.write(qdata)
            log.info("exported %s (%d bytes)", qpath, len(qdata))
            out[f"{name}_int8"] = qpath

    enc = model.encoder
    is_zip = isinstance(enc, Zipformer2)
    enc_meta = ({"model_type": "zipformer2", "version": "1",
                 "comment": "non-streaming zipformer2"} if is_zip else {})
    feats = torch.zeros((1, max_frames, feat_dim))
    lens = torch.tensor([max_frames], dtype=torch.int32)
    emit("encoder", enc, enc, (feats, lens), ["feats", "feat_lens"],
         ["encoder_out", "encoder_out_lens"], ("MatMul",),
         metadata=enc_meta)

    pred_cfg = (task.config.get("predictor") or {}).get("config") or {}
    # distinct tensors: torch.export would make aliased inputs (an LSTM
    # state's zero h and c) one graph input
    state = _tree_map(lambda t: t.clone() if t.is_floating_point()
                      else t.to(torch.int32), model.predictor.init_state(1))
    n_state = len(_leaves(state))
    pred_meta = {}
    if "context_size" in pred_cfg:
        pred_meta["context_size"] = str(pred_cfg["context_size"])
    if "num_symbols" in pred_cfg:
        pred_meta["vocab_size"] = str(pred_cfg["num_symbols"])
    emit("predictor", model.predictor,
         lambda t, *s: model.predictor.streaming_step(t, _unflatten(state,
                                                                    s)),
         (torch.zeros((1,), dtype=torch.int32), *_leaves(state)),
         ["token"] + [f"state_{i}" for i in range(n_state)], None,
         ("MatMul", "Gather"), metadata=pred_meta)

    d = model.joiner.config.input_dim
    emit("joiner", model.joiner, model.joiner.streaming_step,
         (torch.zeros((1, d)), torch.zeros((1, d))),
         ["encoder_frame", "predictor_out"], ["logit"], ("MatMul",),
         metadata={"joiner_dim": str(d)})

    if is_zip:
        metric_cfg = task.config.get("metric") or {}
        chunk = int(metric_cfg.get("streaming_chunk_size", 16))
        left = int(metric_cfg.get("streaming_left_chunks", 4))
        state0 = enc.init_streaming_state(1, chunk, left)
        state0.pop("chunk_size")
        state0["processed"] = torch.zeros((), dtype=torch.int32)
        state0 = _tree_map(torch.clone, state0)
        leaves = _leaves(state0)

        def stream_fn(feats_chunk, *state_leaves):
            st = _unflatten(state0, list(state_leaves))
            st["chunk_size"] = chunk
            enc_out, new_state = enc.streaming_step(feats_chunk, st)
            new_state.pop("chunk_size")
            return (enc_out, *_leaves(new_state))

        zcfg = enc.config
        n_stacks = len(zcfg.encoder_dim)

        def join(xs):
            return ",".join(map(str, xs))
        stream_meta = {
            "model_type": "zipformer2",
            "version": "1",
            "comment": "streaming zipformer2",
            "decode_chunk_len": str(2 * chunk),
            "T": str(2 * chunk),
            "num_encoder_layers": join(zcfg.num_encoder_layers),
            "encoder_dims": join(zcfg.encoder_dim),
            "cnn_module_kernels": join(zcfg.cnn_module_kernel),
            "left_context_len": join(
                left * chunk // k for k in zcfg.downsampling_factor),
            "query_head_dims": join([zcfg.query_head_dim] * n_stacks),
            "value_head_dims": join([zcfg.value_head_dim] * n_stacks),
            "num_heads": join(zcfg.num_heads),
        }
        state_names = [f"state_{i}" for i in range(len(leaves))]
        emit("encoder_stream", enc, stream_fn,
             (torch.zeros((1, 2 * chunk, feat_dim)), *leaves),
             ["feats_chunk"] + state_names,
             ["encoder_out"] + [f"new_{n}" for n in state_names],
             ("MatMul",), metadata=stream_meta)
        spec_path = os.path.join(export_dir, "encoder_stream_spec.json")
        with open(spec_path, "w") as f:
            json.dump({
                "chunk_size": chunk,
                "left_context_chunks": left,
                "feats_per_step": 2 * chunk,
                "state": [{"name": n, "shape": list(t.shape),
                           "dtype": _dtype_name(t.dtype)}
                          for n, t in zip(state_names, leaves)],
            }, f, indent=1)
        out["encoder_stream_spec"] = spec_path

    tok = tokenizer if tokenizer is not None else getattr(
        task, "tokenizer", None)
    if tok is not None:
        units = os.path.join(export_dir, "units.txt")
        tok.export_units(units)
        out["units"] = units
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
