"""The port's ONNX modules (speech2text_torch/onnx/) against the JAX
package's (speech2text_tpu/onnx/), on the CPU at tiny sizes:

- proto: the port's writer's bytes equal JAX's and parse with JAX's
  reader, and JAX's bytes parse with the port's reader, for a tensor, an
  attribute, a node, a graph and a model;
- runner: on graphs JAX's converter emits from tests/test_onnx.py's unit
  functions, the port's runner gives JAX's runner's outputs;
- quantize: the port's quantize_dynamic of JAX's emitted bytes is
  byte-equal to JAX's, for both op sets the export uses;
- emitter: torch modules mirroring those unit functions, exported with
  torch.export and emitted by the port's converter, run through both
  runners within 1e-5 of eager torch.

The task-level graphs (the trio and the streaming encoder of
`inference --override task.onnx_export=true`, against JAX's
export_onnx_modules on the same weights) are in test_torch_export.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from speech2text_tpu import onnx as jonnx
from speech2text_tpu.onnx import proto as jproto
from speech2text_torch import onnx as tonnx
from speech2text_torch.onnx import proto

# ------------------------------------------------------------------ proto
ARR = np.arange(24, dtype=np.float32).reshape(2, 3, 4) / 7.0
ATTRS = {"strides": [1, 2], "group": 3, "alpha": 0.5, "mode": "constant",
         "scales": [0.25, -1.5], "t": np.asarray([[1, -2]], np.int64)}


def _proto_bytes(mod, kind):
    node = mod.node_proto("Conv", ["x", "w"], ["y"], name="c1", attrs=ATTRS)
    graph = mod.graph_proto(
        "g", [node], [mod.tensor_proto("w", ARR)],
        [mod.value_info_proto("x", mod.FLOAT, (1, 2))],
        [mod.value_info_proto("y", mod.INT32, (1, 3))])
    return {"tensor": mod.tensor_proto("w", ARR),
            "attribute": tuple(mod.attribute_proto(k, v)
                               for k, v in ATTRS.items()),
            "node": node, "graph": graph,
            "model": mod.model_proto(graph, opset=17, producer="p",
                                     metadata={"k": "v", "a": "b"})}[kind]


def _parsed(mod, kind, data):
    """What a reader makes of `data`, as plain Python values."""
    def node(n):
        return (n.op_type, n.inputs, n.outputs, n.name,
                {k: np.asarray(v).tolist() for k, v in n.attrs.items()})

    def graph(g):
        return (g.name, [node(n) for n in g.nodes],
                {k: (v.dtype, v.tolist()) for k, v in g.initializers.items()},
                g.inputs, g.outputs)
    if kind == "tensor":
        name, arr = mod.parse_tensor(data)
        return name, arr.dtype, arr.tolist()
    if kind == "attribute":
        return [(k, np.asarray(v).tolist()) for k, v in
                (mod.parse_attribute(a) for a in data)]
    if kind == "node":
        return node(mod.parse_node(data))
    if kind == "graph":
        return graph(mod.parse_graph(data))
    m = mod.parse_model(data)
    return (m.ir_version, m.producer, m.opset, m.metadata, graph(m.graph))


@pytest.mark.parametrize("kind", ["tensor", "attribute", "node", "graph",
                                  "model"])
def test_proto_bytes_and_readers_equal_jax(kind):
    mine, theirs = _proto_bytes(proto, kind), _proto_bytes(jproto, kind)
    assert mine == theirs
    want = _parsed(jproto, kind, theirs)
    assert _parsed(jproto, kind, mine) == want
    assert _parsed(proto, kind, theirs) == want


# ---------------------------------------------------------- unit functions
def _jax_case(name, rng):
    """(function, args) of tests/test_onnx.py's converter unit test
    `name`, with its weights."""
    if name == "mlp":
        W1 = jnp.asarray(rng.standard_normal((16, 32)), jnp.float32)
        W2 = jnp.asarray(rng.standard_normal((32, 8)), jnp.float32)
        b = jnp.asarray(rng.standard_normal((8,)), jnp.float32)

        def fn(x):
            h = jnp.tanh(x @ W1)
            y = jax.nn.softmax(h @ W2 + b, axis=-1)
            return jnp.log(y + 1e-6), jnp.argmax(y, axis=-1)
        return fn, (rng.standard_normal((4, 16)).astype(np.float32),), \
            (W1, W2, b)
    if name == "conv":
        K = jnp.asarray(rng.standard_normal((3, 4, 6)) * 0.3, jnp.float32)

        def fn(x):
            y = jax.lax.conv_general_dilated(
                x, K, (1,), [(1, 1)], dimension_numbers=("NWC", "WIO",
                                                         "NWC"))
            y = jax.nn.relu(y)[:, ::2]
            y = jnp.concatenate([y, -y], axis=-1)
            y = jnp.pad(y, ((0, 0), (1, 0), (0, 0)))
            return y.mean(axis=1), jnp.flip(y, axis=1)
        return fn, (rng.standard_normal((2, 10, 4)).astype(np.float32),), \
            (K,)
    if name == "dwconv":
        Kd = jnp.asarray(rng.standard_normal((5, 1, 6)) * 0.3, jnp.float32)

        def fn(x):
            return jax.lax.conv_general_dilated(
                x, Kd, (2,), [(2, 2)], dimension_numbers=("NWC", "WIO",
                                                          "NWC"),
                feature_group_count=6)
        return fn, (rng.standard_normal((2, 12, 6)).astype(np.float32),), \
            (Kd,)
    if name == "gather":
        E = jnp.asarray(rng.standard_normal((20, 8)), jnp.float32)

        def fn(idx, start):
            v = jnp.take(E, idx, axis=0)
            g2 = E[:, jnp.asarray([1, 3, 5])]
            w = jax.lax.dynamic_slice(
                v, (start, jnp.int32(0), jnp.int32(0)), (2, 2, 8))
            m = jnp.where(v > 0, v, -v)
            return v.sum(-1), w, m.max(), g2
        return fn, (np.asarray([[1, 5], [3, 19], [0, 2]], np.int32),
                    np.asarray(1, np.int32)), (E,)

    def fn(x):
        parts = jnp.split(x, [2, 5], axis=1)
        a = jnp.log1p(jnp.exp(-jnp.abs(x)))
        b = jax.nn.sigmoid(x) * jnp.sqrt(jnp.abs(x) + 1.0)
        c = jnp.clip(x, -0.5, 0.7)
        d = (x > 0).astype(jnp.float32) - (x <= 0.1).astype(jnp.float32)
        e = jnp.minimum(jnp.maximum(x, -1.0), 1.0) ** 3
        f = jnp.sign(x) * jax.lax.rem(x, jnp.full_like(x, 0.3))
        return parts[0], parts[2], a, b, c, d, e, f, x.T
    return fn, (rng.standard_normal((4, 7)).astype(np.float32),), ()


class _Mlp(nn.Module):
    def __init__(self, W1, W2, b):
        super().__init__()
        self.W1, self.W2, self.b = (nn.Parameter(torch.tensor(
            np.asarray(w))) for w in (W1, W2, b))

    def forward(self, x):
        h = torch.tanh(x @ self.W1)
        y = torch.softmax(h @ self.W2 + self.b, dim=-1)
        return torch.log(y + 1e-6), torch.argmax(y, dim=-1)


class _Conv(nn.Module):
    def __init__(self, K):                         # K (W, I, O)
        super().__init__()
        self.K = nn.Parameter(torch.tensor(np.asarray(K)).permute(
            2, 1, 0).contiguous())

    def forward(self, x):
        y = F.conv1d(x.transpose(1, 2), self.K, padding=1).transpose(1, 2)
        y = torch.relu(y)[:, ::2]
        y = torch.cat([y, -y], dim=-1)
        y = F.pad(y, (0, 0, 1, 0))
        return y.mean(dim=1), torch.flip(y, dims=[1])


class _DwConv(nn.Module):
    def __init__(self, Kd):                        # Kd (W, 1, C)
        super().__init__()
        self.K = nn.Parameter(torch.tensor(np.asarray(Kd)).permute(
            2, 1, 0).contiguous())

    def forward(self, x):
        return F.conv1d(x.transpose(1, 2), self.K, stride=2, padding=2,
                        groups=6).transpose(1, 2)


class _Gather(nn.Module):
    def __init__(self, E):
        super().__init__()
        self.E = nn.Parameter(torch.tensor(np.asarray(E)))

    def forward(self, idx, start):
        v = F.embedding(idx, self.E)
        g2 = self.E[:, torch.tensor([1, 3, 5])]
        rows = torch.clamp(start, 0, v.shape[0] - 2) + torch.arange(2)
        w = torch.index_select(v, 0, rows)
        m = torch.where(v > 0, v, -v)
        return v.sum(-1), w, m.max(), g2


class _Misc(nn.Module):
    def forward(self, x):
        parts = torch.split(x, [2, 3, 2], dim=1)
        a = torch.log1p(torch.exp(-torch.abs(x)))
        b = torch.sigmoid(x) * torch.sqrt(torch.abs(x) + 1.0)
        c = torch.clamp(x, -0.5, 0.7)
        d = (x > 0).float() - (x <= 0.1).float()
        e = torch.minimum(torch.maximum(x, torch.tensor(-1.0)),
                          torch.tensor(1.0)) ** 3
        f = torch.sign(x) * torch.fmod(x, 0.3)
        return parts[0], parts[2], a, b, c, d, e, f, x.T


TORCH_MODULES = {"mlp": _Mlp, "conv": _Conv, "dwconv": _DwConv,
                 "gather": _Gather, "misc": _Misc}
CASES = list(TORCH_MODULES)


def _jax_graph(name):
    fn, args, _ = _jax_case(name, np.random.default_rng(CASES.index(name)))
    return jonnx.convert(fn, tuple(jnp.asarray(a) for a in args), name), \
        args


@pytest.mark.parametrize("name", CASES)
def test_runner_matches_jax_runner(name):
    data, args = _jax_graph(name)
    got = tonnx.OnnxRunner(data)(*args)
    want = jonnx.OnnxRunner(data)(*args)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ops", [("MatMul",), ("MatMul", "Gather")])
def test_quantize_dynamic_byte_equal_to_jax(ops):
    for name in ("mlp", "gather"):
        data, _ = _jax_graph(name)
        q = tonnx.quantize_dynamic(data, ops)
        assert q == jonnx.quantize_dynamic(data, ops)
        assert q != data


@pytest.mark.parametrize("name", CASES)
def test_emitter_matches_eager_in_both_runners(name):
    _, args, weights = _jax_case(name, np.random.default_rng(
        CASES.index(name)))
    module = TORCH_MODULES[name](*weights).eval()
    t_args = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    with torch.no_grad():
        program = torch.export.export(module, t_args)
        out = module(*t_args)
        want = [w.numpy() for w in (out if isinstance(out, tuple)
                                    else (out,))]
    data = tonnx.convert(program, name)
    model = proto.parse_model(data)
    assert [n for n, _, _ in model.graph.inputs] == [
        f"input_{i}" for i in range(len(args))]
    for runner in (tonnx.OnnxRunner(data), jonnx.OnnxRunner(data)):
        got = runner(*args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g.astype(w.dtype), w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_emitter_refuses_unknown_ops_and_bf16():
    class Cumsum(nn.Module):
        def forward(self, x):
            return torch.cumsum(x, dim=0)

    class Half(nn.Module):
        def forward(self, x):
            return x.to(torch.bfloat16) * 2

    x = torch.ones(3)
    with pytest.raises(NotImplementedError, match="aten.cumsum"):
        tonnx.convert(torch.export.export(Cumsum(), (x,)))
    with pytest.raises(ValueError, match="bfloat16"):
        tonnx.convert(torch.export.export(Half(), (x,)))


def test_emitter_keeps_select_and_scalar_shapes():
    """A select drops its axis and a scalar stays 0-dim, though the proto
    writer stores a 0-dim constant as shape (1,)."""
    class Pick(nn.Module):
        def forward(self, x, h, count):
            return x[:, 0] + h, count + 1

    args = (np.ones((2, 3, 4), np.float32), np.full((2, 4), 0.5, np.float32),
            np.asarray(3, np.int32))
    data = tonnx.convert(torch.export.export(
        Pick(), tuple(torch.from_numpy(a) for a in args)))
    for runner in (tonnx.OnnxRunner(data), jonnx.OnnxRunner(data)):
        row, count = runner(*args)
        assert row.shape == (2, 4) and count.shape == () and int(count) == 4
