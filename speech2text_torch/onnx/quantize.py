"""Dynamic-int8 quantization of emitted ONNX graphs (port of
speech2text_tpu/onnx/quantize.py), the rewrite of onnxruntime's
`quantize_dynamic(op_types_to_quantize=["MatMul", "Gather"],
weight_type=QInt8)`:

- MatMul(X, W) with a 2-D float initializer W →
    DynamicQuantizeLinear(X) → (Xq u8, x_scale, x_zp)
    W quantized to int8, per tensor, symmetric (zero point 0)
    MatMulInteger(Xq, Wq, x_zp, 0) → int32
    Cast(f32) · (x_scale · w_scale)
- Gather(W, idx) with a float initializer W (embedding tables) →
    W stored as int8; Gather(int8) → Cast(f32) → Mul(w_scale)

Pure numpy over the serialized bytes: on the same input bytes the output
bytes equal the JAX package's. Weights shrink 4× and activations are
quantized at run time; run.py executes the quantized graphs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import proto


def _quantize_weight(arr: np.ndarray) -> Tuple[np.ndarray, np.float32]:
    """Per-tensor symmetric int8, zero-point 0 (onnxruntime QInt8)."""
    amax = float(np.abs(arr).max()) if arr.size else 0.0
    scale = np.float32(max(amax, 1e-12) / 127.0)
    q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_dynamic(model_bytes: bytes,
                     op_types: Sequence[str] = ("MatMul",)) -> bytes:
    """Rewrite a serialized model; returns new serialized bytes."""
    model = proto.parse_model(model_bytes)
    g = model.graph
    assert g is not None

    inits: Dict[str, np.ndarray] = dict(g.initializers)
    new_nodes: List[bytes] = []
    counter = [0]

    def fresh(hint: str) -> str:
        counter[0] += 1
        return f"q_{hint}_{counter[0]}"

    def emit(op, inputs, n_out=1, **attrs):
        outs = [fresh(op.lower()) for _ in range(n_out)]
        new_nodes.append(proto.node_proto(op, inputs, outs,
                                          name=fresh(f"n_{op}"),
                                          attrs=attrs or None))
        return outs

    def reemit(node: proto.Node):
        new_nodes.append(proto.node_proto(
            node.op_type, node.inputs, node.outputs, name=node.name,
            attrs=node.attrs or None))

    quantized: Dict[str, Tuple[str, str]] = {}   # weight → (q_name, s_name)

    def get_quantized(wname: str) -> Tuple[str, str]:
        if wname not in quantized:
            q, scale = _quantize_weight(inits[wname])
            qn, sn = wname + "_q8", wname + "_q8_scale"
            inits[qn] = q
            inits[sn] = np.asarray(scale, np.float32)
            quantized[wname] = (qn, sn)
        return quantized[wname]

    used_float_weights: Dict[str, int] = {}
    for node in g.nodes:
        rewrite = None
        if (node.op_type == "MatMul" and "MatMul" in op_types
                and node.inputs[1] in inits
                and inits[node.inputs[1]].dtype == np.float32
                and inits[node.inputs[1]].ndim == 2):
            rewrite = "matmul"
        elif (node.op_type == "Gather" and "Gather" in op_types
              and node.inputs[0] in inits
              and inits[node.inputs[0]].dtype == np.float32):
            rewrite = "gather"

        if rewrite == "matmul":
            x, wname = node.inputs
            qn, sn = get_quantized(wname)
            xq, xs, xzp = emit("DynamicQuantizeLinear", [x], n_out=3)
            wzp = "q_zero_i8"
            if wzp not in inits:
                inits[wzp] = np.int8(0).reshape(())
            (mi,) = emit("MatMulInteger", [xq, qn, xzp, wzp])
            (mf,) = emit("Cast", [mi], to=proto.FLOAT)
            (sc,) = emit("Mul", [xs, sn])
            new_nodes.append(proto.node_proto(
                "Mul", [mf, sc], node.outputs, name=fresh("n_Mul")))
        elif rewrite == "gather":
            wname, idx = node.inputs
            qn, sn = get_quantized(wname)
            (gq,) = emit("Gather", [qn, idx],
                         axis=node.attrs.get("axis", 0))
            (gf,) = emit("Cast", [gq], to=proto.FLOAT)
            new_nodes.append(proto.node_proto(
                "Mul", [gf, sn], node.outputs, name=fresh("n_Mul")))
        else:
            reemit(node)
            for name in node.inputs:
                if name in inits and inits[name].dtype == np.float32:
                    used_float_weights[name] = 1

    # drop fp32 payloads fully replaced by their int8 twins
    init_pbs = []
    for name, arr in inits.items():
        if (name in quantized and name not in used_float_weights
                and name not in {n for n, *_ in g.outputs}):
            continue
        init_pbs.append(proto.tensor_proto(name, arr))

    def vi(entries):
        return [proto.value_info_proto(
            n, t if t is not None else proto.FLOAT, s)
            for n, t, s in entries]

    graph_pb = proto.graph_proto(g.name + "_int8", new_nodes, init_pbs,
                                 vi(g.inputs), vi(g.outputs))
    meta = dict(model.metadata)
    meta["quantization"] = "dynamic_int8"
    return proto.model_proto(graph_pb, opset=max(model.opset, 17),
                             producer=model.producer or "speech2text_torch",
                             metadata=meta)
