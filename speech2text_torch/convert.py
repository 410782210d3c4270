"""flax parameter tree → the port's state_dict.

Input: the `params` tree of speech2text_tpu's RnntModel (top-level
`encoder`, `predictor`, `joiner`, and `decoder` when the head has
weights), CtcModel (`encoder`, `decoder`), CifModel (`encoder`, `cif`
with `alpha_conv` and `alpha_proj`, `decoder`), SslModel (`encoder`,
`logits_layer`) or RnnLm, with numpy leaves, e.g.
`jax.tree.map(np.asarray, params)`. Layout rules (the inverse of
tools/convert_zipformer_ref.py's):

| flax                              | torch                      |
|-----------------------------------|----------------------------|
| Dense kernel (in, out)            | weight (out, in)           |
| Conv1d kernel (K, in/g, out)      | weight (out, in/g, K)      |
| Conv2d kernel (kh, kw, in/g, out) | weight (out, in/g, kh, kw) |
| Embed embedding (V, E)            | weight (V, E), unchanged   |
| LayerNorm, GroupNorm scale (D,)   | weight (D,), unchanged     |

A depthwise Conv1d (flax `feature_group_count = D`, such as the
Conformer's conv module and CIF's `alpha_conv`) has the kernel (K, 1,
D), hence the weight (D, 1, K); CIF's `alpha_proj` is a Dense (D, 1) →
(1, D). Module names map one to one, flax's auto-generated names
(`ConformerBlock_3`, `Dense_0`, ...) included, except `stack{i}` →
`stacks.{i}`, `layer{i}` → `layers.{i}` and the feedforward's `in` →
`in_`. A checkpoint written with `scan_layers: true` (each stack's
layers as one `layers` subtree whose leaves have a leading axis of L) is
unstacked first into `layer0` .. `layer{L-1}`, as the JAX package's
`unstack_layer_params` does. Unknown keys, missing keys and shape
mismatches raise, and so does a `layers` subtree whose leaves do not
share a leading axis. The Wav2Vec2
encoder's flat indexed names (`conv{i}`, `norm{i}`, `attn{i}`, `ffn{i}`,
`layer_norm{i}`, `final_layer_norm{i}`) are module names of the port as
they stand.

The LSTM layers of models/rnn_lm.py (flax `rnns_{i}/cell`, an
OptimizedLSTMCell with kernels `ii, if, ig, io` (in, H) without bias and
`hi, hf, hg, ho` (H, H) with bias) go into the `nn.LSTM` named `rnns`:
`weight_ih_l{i}` / `weight_hh_l{i}` stack the gates' kernels transposed,
in the order i, f, g, o; `bias_hh_l{i}` the `h*` biases; `bias_ih_l{i}`
is zero.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(r"(stack|layer)(\d+)$")
_LSTM = re.compile(r"rnns_(\d+)$")
_GATES = "ifgo"


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _unstacked(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """`tree` with every `layers` subtree (the scan_layers layout, leaves
    (L, ...)) split into `layer{i}` subtrees of the leaves' i-th rows."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if not (isinstance(v, dict) or hasattr(v, "items")):
            out[k] = v
        elif k != "layers":
            out[k] = _unstacked(v, f"{prefix}{k}/")
        else:
            leaves = list(_flatten(v))
            lead = {leaf.shape[0] if leaf.ndim else None
                    for _, leaf in leaves}
            if len(lead) != 1 or None in lead:
                raise ValueError(
                    f"{prefix}layers: a scan_layers subtree's leaves must "
                    f"share a leading layer axis, got {sorted(map(str, lead))}")
            for i in range(lead.pop()):
                name = f"layer{i}"
                if name in tree:
                    raise ValueError(f"{prefix}: both {name} and a stacked "
                                     f"scan_layers subtree")
                node = out[name] = {}
                for path, leaf in leaves:
                    sub = node
                    for part in path[:-1]:
                        sub = sub.setdefault(part, {})
                    sub[path[-1]] = leaf[i]
    return out


def _torch_key(path: Tuple[str, ...], leaf: np.ndarray
               ) -> Tuple[str, np.ndarray]:
    parts = []
    for name in path[:-1]:
        m = _INDEXED.match(name)
        if m:
            parts += [m.group(1) + "s", m.group(2)]
        else:
            parts.append("in_" if name == "in" else name)
    last = path[-1]
    if last == "kernel":
        perm = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}.get(leaf.ndim)
        if perm is None:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {leaf.ndim}")
        return ".".join(parts + ["weight"]), np.transpose(leaf, perm)
    if last in ("embedding", "scale"):
        return ".".join(parts + ["weight"]), leaf
    return ".".join(parts + [last]), leaf


def _lstm_entries(lstm: Dict[Tuple[str, str], Dict[str, np.ndarray]]
                  ) -> Iterator[Tuple[str, np.ndarray]]:
    """Each flax LSTM cell's twelve leaves (keyed `ii/kernel`, `hi/bias`,
    ...) → its four nn.LSTM entries."""
    for (prefix, i), leaves in lstm.items():
        want = {f"{s}{g}/kernel" for s in "ih" for g in _GATES} | \
            {f"h{g}/bias" for g in _GATES}
        if set(leaves) != want:
            raise KeyError(f"{prefix}rnns_{i}/cell: unknown "
                           f"{sorted(set(leaves) - want)}, missing "
                           f"{sorted(want - set(leaves))}")
        hb = np.concatenate([leaves[f"h{g}/bias"] for g in _GATES])
        for s, name in (("i", "ih"), ("h", "hh")):
            yield f"{prefix}rnns.weight_{name}_l{i}", np.concatenate(
                [leaves[f"{s}{g}/kernel"].T for g in _GATES])
        yield f"{prefix}rnns.bias_hh_l{i}", hb
        yield f"{prefix}rnns.bias_ih_l{i}", np.zeros_like(hb)


def _entries(params: Dict[str, Any]) -> Iterator[Tuple[str, str,
                                                       np.ndarray]]:
    """(flax path, torch key, value) of every leaf of `params`."""
    lstm: Dict[Tuple[str, str], Dict[str, np.ndarray]] = {}
    for path, leaf in _flatten(_unstacked(params)):
        cell = [j for j, name in enumerate(path) if _LSTM.match(name)]
        if cell:
            j = cell[0]
            prefix = "".join(p + "." for p in path[:j])
            if path[j + 1:j + 2] != ("cell",):
                raise KeyError(f"flax parameter {'/'.join(path)} has no "
                               f"counterpart in the port")
            lstm.setdefault((prefix, _LSTM.match(path[j]).group(1)), {})[
                "/".join(path[j + 2:])] = leaf
            continue
        yield ("/".join(path), *_torch_key(path, leaf))
    for key, value in _lstm_entries(lstm):
        yield key, key, value


def flax_to_state_dict(params: Dict[str, Any],
                       model: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert `params` for `model` (an RnntModel, a CtcModel, an RnnLm or
    any module whose names follow the flax tree). The result loads with
    `model.load_state_dict(..., strict=True)`."""
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for name, key, value in _entries(params):
        if key not in expected:
            raise KeyError(f"flax parameter {name} has no counterpart "
                           f"{key!r} in the port")
        if tuple(expected[key].shape) != value.shape:
            raise ValueError(f"{name}: shape {value.shape} does not fit "
                             f"{key} {tuple(expected[key].shape)}")
        out[key] = torch.tensor(value, dtype=torch.float32)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"flax tree lacks port parameters {missing}")
    return out


def to_flax(model: nn.Module,
            tensors: Optional[Dict[str, torch.Tensor]] = None
            ) -> Dict[str, Any]:
    """The inverse: `model`'s parameters as a flax tree of f32 numpy
    arrays, in the layout `flax_to_state_dict` reads (an `nn.LSTM` as
    flax's `rnns_{i}/cell` OptimizedLSTMCell leaves). `tensors` (default:
    the state_dict) are tensors named and shaped as `model`'s, such as
    its gradients, mapped the same way."""
    tree: Dict[str, Any] = {}
    kinds = {name: type(m).__name__ for name, m in model.named_modules()}
    if tensors is None:
        tensors = model.state_dict()
    for key, value in tensors.items():
        parts = key.split(".")
        owner, last = ".".join(parts[:-1]), parts[-1]
        leaf = value.detach().cpu().float().numpy()
        if kinds.get(owner) == "LSTM":
            _lstm_to_flax(tree, parts, leaf)
            continue
        if last == "weight" and kinds.get(owner) == "Embed":
            last = "embedding"
        elif last == "weight" and kinds.get(owner) in ("LayerNorm",
                                                        "GroupNorm"):
            last = "scale"
        elif last == "weight":
            inv = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}[leaf.ndim]
            last, leaf = "kernel", np.transpose(leaf, inv)
        path, i = [], 0
        while i < len(parts) - 1:
            if parts[i] in ("stacks", "layers") and parts[i + 1].isdigit():
                path.append(parts[i][:-1] + parts[i + 1])
                i += 2
            else:
                path.append("in" if parts[i] == "in_" else parts[i])
                i += 1
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[last] = np.array(leaf, dtype=np.float32)
    return tree


def _lstm_to_flax(tree: Dict[str, Any], parts, leaf: np.ndarray) -> None:
    """One nn.LSTM entry (`<owner>.rnns.weight_ih_l{i}`, ...) → its flax
    `rnns_{i}/cell` leaves; `bias_ih_l{i}` must be zero (flax's input
    kernels have no bias)."""
    kind, layer = parts[-1].rsplit("_l", 1)
    node = tree
    for name in parts[:-2]:
        node = node.setdefault(name, {})
    cell = node.setdefault(f"rnns_{layer}", {}).setdefault("cell", {})
    gates = np.split(leaf, 4, axis=0)
    if kind == "bias_ih":
        if np.any(leaf):
            raise ValueError(f"{'.'.join(parts)} is not zero: flax's LSTM "
                             f"input kernels have no bias")
        return
    for g, part in zip(_GATES, gates):
        if kind == "bias_hh":
            cell.setdefault(f"h{g}", {})["bias"] = np.array(part, np.float32)
        else:
            s = "i" if kind == "weight_ih" else "h"
            cell.setdefault(f"{s}{g}", {})["kernel"] = np.array(
                part.T, np.float32)
