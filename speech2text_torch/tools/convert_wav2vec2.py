"""Convert a local HuggingFace Wav2Vec2 checkpoint (safetensors) into the
port's pretrained-encoder file, read through `encoder.config.
pretrained_path` (port of speech2text_tpu/tools/convert_wav2vec2.py).

    python -m speech2text_torch.tools.convert_wav2vec2 \\
        --input /path/model.safetensors --output w2v2.pt

The safetensors container is parsed with numpy (8-byte little-endian
header length, JSON header, raw tensor bytes; BF16 widened to f32). The
HF names map onto the flax tree of the JAX package's `Wav2Vec2Encoder`
(`hf_to_flax`, the JAX converter's map: weight norm composed from either
`weight_g`/`weight_v` or `parametrizations.weight.original0/1`, the
classifier and quantizer heads skipped), then onto the port's module
names by speech2text_torch/convert.py's rules. The output is a torch
file {"encoder": {name: tensor}, "layout": {"num_layers",
"do_stable_layer_norm", "feat_extract_norm" (1 = "layer")}}; the layout
(base post-norm or stable pre-norm, group or layer feature norm) is
detected from the tensor names. The port reads this file, not the JAX
converter's flax msgpack (reading msgpack needs flax).

`write_safetensors` and `synthetic_hf_tensors` make test checkpoints:
HF-named tensors from a seed, in either layout and either weight-norm
naming, written as F32 or, for the names asked, BF16.
"""

from __future__ import annotations

import argparse
import json
import struct
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from ..convert import _entries

_ST_DTYPES = {
    "F64": (np.float64, 8), "F32": (np.float32, 4), "F16": (np.float16, 2),
    "BF16": (None, 2), "I64": (np.int64, 8), "I32": (np.int32, 4),
    "I16": (np.int16, 2), "I8": (np.int8, 1), "U8": (np.uint8, 1),
    "BOOL": (np.bool_, 1),
}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Parse a .safetensors file with numpy only (BF16 → float32)."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dt, _ = _ST_DTYPES[meta["dtype"]]
        lo, hi = meta["data_offsets"]
        raw = data[lo:hi]
        if meta["dtype"] == "BF16":
            u16 = np.frombuffer(raw, dtype=np.uint16)
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype=dt)
        out[name] = arr.reshape(meta["shape"]).copy()
    return out


def write_safetensors(tensors: Dict[str, np.ndarray], path: str,
                      bf16: Iterable[str] = ()) -> None:
    """A minimal safetensors writer (test checkpoints): the f32 arrays
    named in `bf16` are written as BF16 (rounded to nearest even)."""
    rev = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
           np.dtype(np.float64): "F64", np.dtype(np.int64): "I64",
           np.dtype(np.int32): "I32"}
    bf16 = set(bf16)
    header, blobs, off = {}, [], 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if name in bf16:
            u32 = arr.astype(np.float32).view(np.uint32)
            u32 = u32 + np.uint32(0x7FFF) + ((u32 >> np.uint32(16))
                                             & np.uint32(1))
            b, dtype = (u32 >> np.uint32(16)).astype(np.uint16).tobytes(), \
                "BF16"
        else:
            b, dtype = arr.tobytes(), rev[arr.dtype]
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    hj = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for b in blobs:
            f.write(b)


def _compose_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """w = g · v / ‖v‖, the norm over the dims where g is broadcast."""
    dims = tuple(i for i, s in enumerate(g.shape) if s == 1)
    norm = np.sqrt(np.sum(np.square(v), axis=dims, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _lin(t, pre, dst, dst_name):
    dst[dst_name] = {"kernel": t[pre + ".weight"].T.astype(np.float32)}
    if pre + ".bias" in t:
        dst[dst_name]["bias"] = t[pre + ".bias"].astype(np.float32)


def _ln(t, pre, dst, dst_name):
    dst[dst_name] = {"scale": t[pre + ".weight"].astype(np.float32),
                     "bias": t[pre + ".bias"].astype(np.float32)}


def _detect_stable(t: Dict[str, np.ndarray]) -> bool:
    """Base and stable layer norm have the same names; HF pairs a
    layer-norm feature extractor with stable layer norm."""
    return "feature_extractor.conv_layers.1.layer_norm.weight" in t


def hf_to_flax(tensors: Dict[str, np.ndarray]) -> Dict:
    """HF Wav2Vec2Model tensor names → the JAX package's Wav2Vec2Encoder
    param tree, with its `__layout__` record."""
    t = {}
    for k, v in tensors.items():
        k = k.removeprefix("wav2vec2.")
        k = k.replace("parametrizations.weight.original0", "weight_g")
        k = k.replace("parametrizations.weight.original1", "weight_v")
        t[k] = v

    stable = "encoder.layers.0.layer_norm.weight" in t and \
        "encoder.layers.1.feed_forward.intermediate_dense.weight" in t and \
        _detect_stable(t)
    params: Dict = {}
    fe: Dict = {}
    i = 0
    while f"feature_extractor.conv_layers.{i}.conv.weight" in t:
        w = t[f"feature_extractor.conv_layers.{i}.conv.weight"]
        fe[f"conv{i}"] = {"kernel": w.transpose(2, 1, 0).astype(np.float32)}
        b = t.get(f"feature_extractor.conv_layers.{i}.conv.bias")
        if b is not None:
            fe[f"conv{i}"]["bias"] = b.astype(np.float32)
        if f"feature_extractor.conv_layers.{i}.layer_norm.weight" in t:
            _ln(t, f"feature_extractor.conv_layers.{i}.layer_norm", fe,
                f"norm{i}")
        i += 1
    params["feature_extractor"] = fe
    _ln(t, "feature_projection.layer_norm", params, "fp_layer_norm")
    _lin(t, "feature_projection.projection", params, "feature_projection")
    w = _compose_weight_norm(t["encoder.pos_conv_embed.conv.weight_g"],
                             t["encoder.pos_conv_embed.conv.weight_v"])
    params["pos_conv"] = {
        "kernel": w.transpose(2, 1, 0).astype(np.float32),
        "bias": t["encoder.pos_conv_embed.conv.bias"].astype(np.float32),
    }
    _ln(t, "encoder.layer_norm", params, "encoder_layer_norm")
    i = 0
    while f"encoder.layers.{i}.attention.q_proj.weight" in t:
        pre = f"encoder.layers.{i}"
        attn: Dict = {}
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(t, f"{pre}.attention.{p}", attn, p)
        params[f"attn{i}"] = attn
        ffn: Dict = {}
        _lin(t, f"{pre}.feed_forward.intermediate_dense", ffn,
             "intermediate_dense")
        _lin(t, f"{pre}.feed_forward.output_dense", ffn, "output_dense")
        params[f"ffn{i}"] = ffn
        _ln(t, f"{pre}.layer_norm", params, f"layer_norm{i}")
        _ln(t, f"{pre}.final_layer_norm", params, f"final_layer_norm{i}")
        i += 1
    params["__layout__"] = {
        "num_layers": np.asarray(i, np.int32),
        "do_stable_layer_norm": np.asarray(int(stable), np.int32),
        "feat_extract_norm": np.asarray(
            int("feature_extractor.conv_layers.1.layer_norm.weight" in t),
            np.int32),
    }
    return params


def hf_to_encoder_state(tensors: Dict[str, np.ndarray]
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """HF tensors → (the port's Wav2Vec2Encoder state_dict entries, in
    the flax tree's order; the layout record)."""
    params = hf_to_flax(tensors)
    layout = {k: int(v) for k, v in params.pop("__layout__").items()}
    state = {key: torch.tensor(np.asarray(value), dtype=torch.float32)
             for _, key, value in _entries(params)}
    return state, layout


def convert(input_path: str, output_path: str
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """`input_path` (.safetensors, or .npz of HF names) → the port's file
    at `output_path`; returns its (encoder state, layout)."""
    if input_path.endswith(".npz"):
        tensors = dict(np.load(input_path))
    else:
        tensors = read_safetensors(input_path)
    state, layout = hf_to_encoder_state(tensors)
    torch.save({"encoder": state, "layout": layout}, output_path)
    return state, layout


def synthetic_hf_tensors(hidden: int, num_layers: int, ffn: int,
                         pos_kernel: int, pos_groups: int, stable: bool,
                         seed: int, parametrized: bool = False,
                         prefix: str = "") -> Dict[str, np.ndarray]:
    """HF-named Wav2Vec2Model tensors from `np.random.default_rng(seed)`:
    the stable layout (layer-norm extractor with conv biases, pre-norm)
    or the base one (a GroupNorm after conv0, no conv bias, post-norm);
    the positional conv's weight norm as `weight_g`/`weight_v` or, with
    `parametrized`, torch's `parametrizations.weight.original0/1`; with
    `prefix` (such as "wav2vec2.") a ForCTC-style checkpoint. Weights are
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), biases N(0, 0.1²); the
    `masked_spec_embed` and an `lm_head` (with a prefix) are there to be
    skipped."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        fan_in = int(np.prod(shape[1:]))
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def b(n):
        return (0.1 * rng.standard_normal(n)).astype(np.float32)

    out: Dict[str, np.ndarray] = {}

    def norm(name, n):
        out[f"{name}.weight"] = (1.0 + b(n)).astype(np.float32)
        out[f"{name}.bias"] = b(n)

    c_in = 1
    for i, (dim, k, _) in enumerate(((512, 10, 5), (512, 3, 2), (512, 3, 2),
                                     (512, 3, 2), (512, 3, 2), (512, 2, 2),
                                     (512, 2, 2))):
        pre = f"feature_extractor.conv_layers.{i}"
        out[f"{pre}.conv.weight"] = w(dim, c_in, k)
        if stable:
            out[f"{pre}.conv.bias"] = b(dim)
        if stable or i == 0:
            norm(f"{pre}.layer_norm", dim)
        c_in = dim
    norm("feature_projection.layer_norm", 512)
    out["feature_projection.projection.weight"] = w(hidden, 512)
    out["feature_projection.projection.bias"] = b(hidden)
    g_name, v_name = (("parametrizations.weight.original0",
                       "parametrizations.weight.original1") if parametrized
                      else ("weight_g", "weight_v"))
    pos = "encoder.pos_conv_embed.conv"
    out[f"{pos}.{g_name}"] = (1.0 + b(pos_kernel)).reshape(1, 1, pos_kernel)
    out[f"{pos}.{v_name}"] = w(hidden, hidden // pos_groups, pos_kernel)
    out[f"{pos}.bias"] = b(hidden)
    norm("encoder.layer_norm", hidden)
    for i in range(num_layers):
        pre = f"encoder.layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[f"{pre}.attention.{p}.weight"] = w(hidden, hidden)
            out[f"{pre}.attention.{p}.bias"] = b(hidden)
        norm(f"{pre}.layer_norm", hidden)
        out[f"{pre}.feed_forward.intermediate_dense.weight"] = w(ffn, hidden)
        out[f"{pre}.feed_forward.intermediate_dense.bias"] = b(ffn)
        out[f"{pre}.feed_forward.output_dense.weight"] = w(hidden, ffn)
        out[f"{pre}.feed_forward.output_dense.bias"] = b(hidden)
        norm(f"{pre}.final_layer_norm", hidden)
    out["masked_spec_embed"] = b(hidden)
    out = {prefix + k: v for k, v in out.items()}
    if prefix:
        out["lm_head.weight"] = w(32, hidden)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m speech2text_torch.tools.convert_wav2vec2",
        description="Convert a HuggingFace Wav2Vec2 checkpoint into the "
                    "port's pretrained-encoder file.")
    ap.add_argument("--input", required=True,
                    help=".safetensors or .npz HF checkpoint")
    ap.add_argument("--output", required=True,
                    help="the port's file (torch.save)")
    args = ap.parse_args(argv)
    state, layout = convert(args.input, args.output)
    n = sum(t.numel() for t in state.values())
    print(f"wrote {args.output}: {len(state)} tensors, {n} parameters, "
          f"layout {layout}")


if __name__ == "__main__":
    main()
