"""flax parameter tree → the port's state_dict.

Input: the `params` tree of speech2text_tpu's RnntModel (top-level
`encoder`, `predictor`, `joiner`) with numpy leaves, e.g.
`jax.tree.map(np.asarray, params)`. Layout rules (the inverse of
tools/convert_zipformer_ref.py's):

| flax                              | torch                      |
|-----------------------------------|----------------------------|
| Dense kernel (in, out)            | weight (out, in)           |
| Conv1d kernel (K, in/g, out)      | weight (out, in/g, K)      |
| Conv2d kernel (kh, kw, in/g, out) | weight (out, in/g, kh, kw) |
| Embed embedding (V, E)            | weight (V, E), unchanged   |

Module names map one to one, except `stack{i}` → `stacks.{i}`,
`layer{i}` → `layers.{i}` and the feedforward's `in` → `in_`. Unknown
keys, missing keys, shape mismatches and the `scan_layers` layout (a
stacked `layers` subtree) raise.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(r"(stack|layer)(\d+)$")


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_key(path: Tuple[str, ...], leaf: np.ndarray
               ) -> Tuple[str, np.ndarray]:
    parts = []
    for name in path[:-1]:
        if name == "layers":
            raise ValueError(
                f"{'/'.join(path)}: scan_layers layout; convert with "
                f"speech2text_tpu's unstack_layer_params first")
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
    if last == "embedding":
        return ".".join(parts + ["weight"]), leaf
    return ".".join(parts + [last]), leaf


def flax_to_state_dict(params: Dict[str, Any],
                       model: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert `params` for `model` (an RnntModel or any module whose
    names follow the flax tree). The result loads with
    `model.load_state_dict(..., strict=True)`."""
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        key, value = _torch_key(path, leaf)
        if key not in expected:
            raise KeyError(f"flax parameter {'/'.join(path)} has no "
                           f"counterpart {key!r} in the port")
        if tuple(expected[key].shape) != value.shape:
            raise ValueError(f"{'/'.join(path)}: shape {value.shape} does "
                             f"not fit {key} {tuple(expected[key].shape)}")
        out[key] = torch.tensor(value, dtype=torch.float32)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"flax tree lacks port parameters {missing}")
    return out


def to_flax(model: nn.Module) -> Dict[str, Any]:
    """The inverse: `model`'s parameters as a flax tree of f32 numpy
    arrays, in the layout `flax_to_state_dict` reads."""
    tree: Dict[str, Any] = {}
    kinds = {name: type(m).__name__ for name, m in model.named_modules()}
    for key, value in model.state_dict().items():
        parts = key.split(".")
        owner, last = ".".join(parts[:-1]), parts[-1]
        leaf = value.detach().cpu().float().numpy()
        if last == "weight" and kinds.get(owner) == "Embed":
            last = "embedding"
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
