"""Numpy evaluator of the ONNX graphs the port emits (port of
speech2text_tpu/onnx/run.py).

It executes exactly the opset-17 subset that the JAX package's runner
executes (Abs ... Xor, DynamicQuantizeLinear and MatMulInteger included),
so every graph `convert.py` and `quantize.py` write runs in both runners.
Node semantics follow the public ONNX operator spec. The tests and the
card's smoke check run the exported graphs from their serialized bytes
through it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import proto


def _np_pads(pads: np.ndarray, rank: int):
    pads = np.asarray(pads).reshape(2, rank)
    return [(int(pads[0, i]), int(pads[1, i])) for i in range(rank)]


class OnnxRunner:
    """Executes a parsed ONNX graph with numpy."""

    def __init__(self, model_bytes: bytes):
        self.model = proto.parse_model(model_bytes)
        if self.model.graph is None:
            raise ValueError("model has no graph")
        self.graph = self.model.graph
        self.input_names = [n for n, _, _ in self.graph.inputs]
        self.output_names = [n for n, _, _ in self.graph.outputs]

    def __call__(self, *args: np.ndarray,
                 **kwargs: np.ndarray) -> List[np.ndarray]:
        env: Dict[str, np.ndarray] = dict(self.graph.initializers)
        names = [n for n in self.input_names if n not in kwargs]
        if len(args) != len(names):
            raise ValueError(f"expected {len(names)} args ({names}), "
                             f"got {len(args)}")
        env.update(zip(names, (np.asarray(a) for a in args)))
        env.update({k: np.asarray(v) for k, v in kwargs.items()})
        for node in self.graph.nodes:
            outs = self._exec(node, [env[i] if i else None
                                     for i in node.inputs])
            if not isinstance(outs, (tuple, list)):
                outs = [outs]
            for name, val in zip(node.outputs, outs):
                env[name] = np.asarray(val)
        return [env[n] for n in self.output_names]

    # ------------------------------------------------------------- ops
    def _exec(self, node: proto.Node, x: List[Optional[np.ndarray]]):
        op = node.op_type
        a = node.attrs
        if op == "Add":
            return x[0] + x[1]
        if op == "Sub":
            return x[0] - x[1]
        if op == "Mul":
            return x[0] * x[1]
        if op == "Div":
            if np.issubdtype(x[0].dtype, np.integer):
                q = np.trunc(x[0].astype(np.float64)
                             / x[1].astype(np.float64))
                return q.astype(x[0].dtype)
            return x[0] / x[1]
        if op == "Max":
            return np.maximum(x[0], x[1])
        if op == "Min":
            return np.minimum(x[0], x[1])
        if op == "And":
            return np.logical_and(x[0], x[1])
        if op == "Or":
            return np.logical_or(x[0], x[1])
        if op == "Xor":
            return np.logical_xor(x[0], x[1])
        if op == "Not":
            return np.logical_not(x[0])
        if op == "Neg":
            return -x[0]
        if op == "Abs":
            return np.abs(x[0])
        if op == "Exp":
            return np.exp(x[0])
        if op == "Log":
            return np.log(x[0])
        if op == "Sqrt":
            return np.sqrt(x[0])
        if op == "Reciprocal":
            return 1.0 / x[0]
        if op == "Tanh":
            return np.tanh(x[0])
        if op == "Sigmoid":
            with np.errstate(over="ignore"):
                return (1.0 / (1.0 + np.exp(-x[0]))).astype(x[0].dtype)
        if op == "Sign":
            return np.sign(x[0])
        if op == "Sin":
            return np.sin(x[0])
        if op == "Cos":
            return np.cos(x[0])
        if op == "Floor":
            return np.floor(x[0])
        if op == "Ceil":
            return np.ceil(x[0])
        if op == "Erf":
            try:
                from math import erf
                return np.vectorize(erf, otypes=[x[0].dtype])(x[0])
            except Exception:
                raise NotImplementedError("Erf")
        if op == "Pow":
            return np.power(x[0], x[1]).astype(x[0].dtype)
        if op == "Mod":
            if a.get("fmod", 0):
                return np.fmod(x[0], x[1])
            return np.mod(x[0], x[1])
        if op == "Greater":
            return x[0] > x[1]
        if op == "GreaterOrEqual":
            return x[0] >= x[1]
        if op == "Less":
            return x[0] < x[1]
        if op == "LessOrEqual":
            return x[0] <= x[1]
        if op == "Equal":
            return x[0] == x[1]
        if op == "Where":
            return np.where(x[0], x[1], x[2])
        if op == "Clip":
            lo = x[1] if len(x) > 1 and x[1] is not None else None
            hi = x[2] if len(x) > 2 and x[2] is not None else None
            return np.clip(x[0], lo, hi)
        if op == "Cast":
            return x[0].astype(proto.onnx_to_np_dtype(a["to"]))
        if op == "Identity":
            return x[0]
        if op == "Reshape":
            return x[0].reshape([int(d) for d in x[1]])
        if op == "Transpose":
            return np.transpose(x[0], a.get("perm"))
        if op == "Expand":
            shape = [int(d) for d in x[1]]
            return np.broadcast_to(x[0], np.broadcast_shapes(
                x[0].shape, tuple(shape)))
        if op == "Concat":
            return np.concatenate(x, axis=a["axis"])
        if op == "Slice":
            data, starts, ends = x[0], x[1], x[2]
            axes = (x[3] if len(x) > 3 and x[3] is not None
                    else np.arange(len(starts)))
            steps = (x[4] if len(x) > 4 and x[4] is not None
                     else np.ones(len(starts), np.int64))
            sl = [slice(None)] * data.ndim
            int64_min = -(2 ** 63)
            for s, e, ax, st in zip(starts, ends, axes, steps):
                s, e, ax, st = int(s), int(e), int(ax), int(st)
                # INT64_MIN end with negative step means "through index 0"
                if st < 0 and e == int64_min:
                    e = None
                sl[ax] = slice(s, e, st)
            return data[tuple(sl)]
        if op == "Pad":
            pads = x[1]
            mode = a.get("mode", "constant")
            cval = x[2] if len(x) > 2 and x[2] is not None else 0
            return np.pad(x[0], _np_pads(pads, x[0].ndim), mode=mode,
                          constant_values=np.asarray(cval).item())
        if op == "Split":
            sizes = [int(s) for s in x[1]]
            idx = np.cumsum(sizes)[:-1]
            return np.split(x[0], idx, axis=a.get("axis", 0))
        if op == "ReduceSum":
            axes = (tuple(int(v) for v in x[1])
                    if len(x) > 1 and x[1] is not None else None)
            return np.sum(x[0], axis=axes,
                          keepdims=bool(a.get("keepdims", 1)))
        if op in ("ReduceMax", "ReduceMin", "ReduceProd", "ReduceMean"):
            fn = {"ReduceMax": np.max, "ReduceMin": np.min,
                  "ReduceProd": np.prod, "ReduceMean": np.mean}[op]
            axes = a.get("axes")
            axes = tuple(axes) if axes else None
            return fn(x[0], axis=axes, keepdims=bool(a.get("keepdims", 1)))
        if op in ("ArgMax", "ArgMin"):
            fn = np.argmax if op == "ArgMax" else np.argmin
            r = fn(x[0], axis=a.get("axis", 0))
            if a.get("keepdims", 1):
                r = np.expand_dims(r, a.get("axis", 0))
            return r.astype(np.int64)
        if op == "MatMul":
            return np.matmul(x[0], x[1])
        if op == "Einsum":
            return np.einsum(a["equation"], *x)
        if op == "Gather":
            return np.take(x[0], x[1].astype(np.int64),
                           axis=a.get("axis", 0))
        if op == "Conv":
            return self._conv(x[0], x[1],
                              x[2] if len(x) > 2 else None, a)
        if op == "Softmax":
            ax = a.get("axis", -1)
            e = np.exp(x[0] - np.max(x[0], axis=ax, keepdims=True))
            return e / np.sum(e, axis=ax, keepdims=True)
        if op == "DynamicQuantizeLinear":
            return self._dyn_quant(x[0])
        if op == "MatMulInteger":
            a_zp = x[2] if len(x) > 2 and x[2] is not None else 0
            b_zp = x[3] if len(x) > 3 and x[3] is not None else 0
            ai = x[0].astype(np.int32) - np.asarray(a_zp, np.int32)
            bi = x[1].astype(np.int32) - np.asarray(b_zp, np.int32)
            return np.matmul(ai, bi)
        raise NotImplementedError(f"ONNX op {op}")

    @staticmethod
    def _dyn_quant(x: np.ndarray):
        """DynamicQuantizeLinear: uint8 asymmetric, per-tensor (spec)."""
        xmin = min(float(x.min()), 0.0)
        xmax = max(float(x.max()), 0.0)
        scale = (xmax - xmin) / 255.0 if xmax > xmin else 1.0
        zp = int(np.clip(round(-xmin / scale), 0, 255)) if scale else 0
        q = np.clip(np.round(x / scale) + zp, 0, 255).astype(np.uint8)
        return q, np.float32(scale), np.uint8(zp)

    @staticmethod
    def _conv(x, w, bias, attrs):
        """Conv via im2col (N,C,spatial) / (O, I/g, spatial)."""
        group = attrs.get("group", 1)
        nsp = x.ndim - 2
        strides = attrs.get("strides", [1] * nsp)
        dil = attrs.get("dilations", [1] * nsp)
        pads = attrs.get("pads", [0] * (2 * nsp))
        pad_width = [(0, 0), (0, 0)] + [
            (pads[i], pads[nsp + i]) for i in range(nsp)]
        xp = np.pad(x, pad_width)
        N, C = x.shape[:2]
        O = w.shape[0]
        ksp = w.shape[2:]
        out_sp = [
            (xp.shape[2 + i] - dil[i] * (ksp[i] - 1) - 1) // strides[i] + 1
            for i in range(nsp)]
        cig = C // group
        og = O // group
        out = np.zeros([N, O] + out_sp, np.float64)
        # gather patches: iterate kernel offsets (small kernels)
        for g in range(group):
            xg = xp[:, g * cig:(g + 1) * cig]
            wg = w[g * og:(g + 1) * og]
            acc = np.zeros([N, og] + out_sp, np.float64)
            for kidx in np.ndindex(*ksp):
                sl = [slice(None), slice(None)]
                for i in range(nsp):
                    start = kidx[i] * dil[i]
                    stop = start + strides[i] * (out_sp[i] - 1) + 1
                    sl.append(slice(start, stop, strides[i]))
                patch = xg[tuple(sl)]                     # (N, cig, *out)
                kw = wg[(slice(None), slice(None)) + kidx]  # (og, cig)
                acc += np.einsum("oc,nc...->no...", kw, patch)
            out[:, g * og:(g + 1) * og] = acc
        if bias is not None:
            out += bias.reshape([1, O] + [1] * nsp)
        return out.astype(x.dtype)
