"""`torch.export` program → ONNX graph (opset 17).

The port's counterpart of speech2text_tpu/onnx/convert.py, which lowers
a jaxpr. Here the input is an `ExportedProgram`:

- its graph is decomposed to core ATen (`run_decompositions`), with
  kernel B1's custom op `speech2text_torch::attn_weights` decomposed into
  its plain version (ops/attn_weights.py:attn_weights_plain), as the JAX
  package exports the materialized attention path: ONNX has no node for
  the kernel;
- parameters, buffers and constants (read through the graph signature)
  are baked as initializers, and every subexpression whose inputs are all
  constants is folded at export by running it in torch on the CPU, as the
  JAX converter folds with `_fold`; a linear layer's transposed weight so
  becomes a 2-D (in, out) initializer, which `quantize_dynamic` rewrites;
- shapes are static (the program's example shapes);
- each ATen op maps into the op subset that both packages' runners
  execute (run.py). An op outside it raises NotImplementedError with the
  op's name; so does a gather whose index is computed at run time.

bfloat16 values are refused: export from a float32 model.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import proto

# -------------------------------------------------------- graph writer


class _GraphWriter:
    """Accumulates ONNX nodes and initializers with unique names."""

    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self._init_names: set = set()
        self._counter = 0
        self._small: Dict[Tuple, str] = {}     # small constants by value
        self._views: Dict[Tuple, Tuple] = {}   # constants by storage view

    def fresh(self, hint: str) -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def add_node(self, op: str, inputs: Sequence[str], n_out: int = 1,
                 **attrs) -> List[str]:
        outs = [self.fresh(op.lower()) for _ in range(n_out)]
        self.nodes.append(proto.node_proto(
            op, list(inputs), outs, name=self.fresh(f"n_{op}"),
            attrs=attrs or None))
        return outs

    def node(self, op: str, inputs: Sequence[str], **attrs) -> str:
        return self.add_node(op, inputs, **attrs)[0]

    def add_initializer(self, name: str, arr: np.ndarray) -> str:
        if name in self._init_names:
            name = self.fresh(name)
        self._init_names.add(name)
        self.initializers.append(proto.tensor_proto(name, arr))
        return name

    def const(self, arr: np.ndarray, hint: str = "const") -> str:
        arr = np.asarray(arr)
        key: Tuple = ()
        if arr.size <= 64:
            key = (str(arr.dtype), arr.shape, arr.tobytes())
            if key in self._small:
                return self._small[key]
        name = self.add_initializer(self.fresh(hint), arr)
        if key:
            self._small[key] = name
        return name

    def i64(self, values: Sequence[int], hint: str = "i64") -> str:
        return self.const(np.asarray(list(values), np.int64), hint)


_NP_OF = {torch.float32: np.float32, torch.float64: np.float64,
          torch.float16: np.float16, torch.int64: np.int64,
          torch.int32: np.int32, torch.int16: np.int16, torch.int8: np.int8,
          torch.uint8: np.uint8, torch.bool: np.bool_}


def _np_dtype(dt: torch.dtype) -> np.dtype:
    if dt == torch.bfloat16:
        raise ValueError("bfloat16 graphs are not exportable to ONNX here; "
                         "export a float32 copy of the model")
    if dt not in _NP_OF:
        raise ValueError(f"dtype {dt} has no ONNX mapping")
    return np.dtype(_NP_OF[dt])


def _onnx_dtype(dt: torch.dtype) -> int:
    return proto.np_to_onnx_dtype(_np_dtype(dt))


class _Val:
    """A value of the graph: an ONNX tensor name, or a constant (a CPU
    tensor, folded at export), with its static shape and torch dtype."""

    __slots__ = ("name", "const", "shape", "dtype")

    def __init__(self, shape, dtype: torch.dtype, name: Optional[str] = None,
                 const: Optional[torch.Tensor] = None):
        self.name = name
        self.const = const
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    @property
    def is_const(self) -> bool:
        return self.const is not None

    @classmethod
    def of_const(cls, t: torch.Tensor) -> "_Val":
        return cls(t.shape, t.dtype, const=t)


class _Ctx:
    def __init__(self, writer: _GraphWriter):
        self.b = writer

    def name_of(self, v: "_Val") -> str:
        """The ONNX name of `v`, emitting a folded constant as an
        initializer: a broadcast view (a stride-0 dim, as `expand` leaves)
        is stored compact and expanded by a node."""
        if v.name is not None:
            return v.name
        t = v.const
        key = (t.untyped_storage().data_ptr(), t.storage_offset(),
               tuple(t.shape), tuple(t.stride()), t.dtype)
        if key in self.b._views:
            v.name = self.b._views[key][1]
            return v.name
        bcast = [d for d in range(t.dim())
                 if t.stride(d) == 0 and t.shape[d] > 1]
        if bcast:
            compact = t
            for d in bcast:
                compact = compact.narrow(d, 0, 1)
            name = self.b.const(self._array(compact))
            name = self.b.node("Expand", [name, self.b.i64(t.shape, "shape")])
        else:
            name = self.b.const(self._array(t))
        # the entry holds the tensor, so that its storage is not freed
        # and reused by another constant under the same key
        self.b._views[key] = (t, name)
        v.name = name
        return name

    @staticmethod
    def _array(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().contiguous().numpy().astype(
            _np_dtype(t.dtype), copy=False)

    def scalar(self, value, dtype: torch.dtype) -> str:
        return self.b.const(np.asarray(value, _np_dtype(dtype)))

    def cast(self, v: "_Val", dtype: torch.dtype) -> str:
        if v.dtype == dtype:
            return self.name_of(v)
        if v.is_const:
            return self.name_of(_Val.of_const(v.const.to(dtype)))
        return self.b.node("Cast", [self.name_of(v)], to=_onnx_dtype(dtype))

    def operand(self, x, dtype: torch.dtype) -> str:
        """A tensor value or a Python scalar as `dtype`."""
        if isinstance(x, _Val):
            return self.cast(x, dtype)
        return self.scalar(x, dtype)


# ----------------------------------------------------------- op handlers

_HANDLERS: Dict[str, Callable] = {}


def _register(*names):
    def deco(fn):
        for n in names:
            _HANDLERS[n] = fn
        return fn
    return deco


def _out(node):
    return node.meta["val"]


def _proxy(x):
    """A stand-in for type promotion: a tensor value keeps its dtype and
    whether it is 0-dim; a Python scalar stays as it is."""
    if isinstance(x, _Val):
        return torch.empty(() if x.shape == () else (1,), dtype=x.dtype)
    return x


def _common(a, b) -> torch.dtype:
    return torch.result_type(_proxy(a), _proxy(b))


_UNARY = {
    "aten.abs.default": "Abs", "aten.neg.default": "Neg",
    "aten.exp.default": "Exp", "aten.log.default": "Log",
    "aten.sqrt.default": "Sqrt", "aten.tanh.default": "Tanh",
    "aten.sigmoid.default": "Sigmoid", "aten.sign.default": "Sign",
    "aten.sin.default": "Sin", "aten.cos.default": "Cos",
    "aten.floor.default": "Floor", "aten.ceil.default": "Ceil",
    "aten.erf.default": "Erf", "aten.reciprocal.default": "Reciprocal",
    "aten.logical_not.default": "Not", "aten.bitwise_not.default": "Not",
}


@_register(*_UNARY)
def _h_unary(ctx, node, x):
    op = _UNARY[str(node.target)]
    if op == "Not" and x.dtype != torch.bool:
        raise NotImplementedError(f"{node.target} on {x.dtype}")
    return ctx.b.node(op, [ctx.cast(x, _out(node).dtype)])


@_register("aten.rsqrt.default")
def _h_rsqrt(ctx, node, x):
    return ctx.b.node("Reciprocal", [ctx.b.node("Sqrt", [ctx.name_of(x)])])


@_register("aten.log1p.default")
def _h_log1p(ctx, node, x):
    """log(1 + x) without the rounding of 1 + x (ONNX has no Log1p):
    log(u)·x/(u − 1) with u = 1 + x, x itself where u − 1 is 0, log(u)
    where u − 1 equals x (large or infinite x)."""
    xn = ctx.name_of(x)
    one, zero = ctx.scalar(1, x.dtype), ctx.scalar(0, x.dtype)
    u = ctx.b.node("Add", [xn, one])
    d = ctx.b.node("Sub", [u, one])
    tiny = ctx.b.node("Equal", [d, zero])
    ratio = ctx.b.node("Where", [
        ctx.b.node("Equal", [d, xn]), one,
        ctx.b.node("Div", [xn, ctx.b.node("Where", [tiny, one, d])])])
    return ctx.b.node("Where", [tiny, xn, ctx.b.node(
        "Mul", [ctx.b.node("Log", [u]), ratio])])


@_register("aten.expm1.default")
def _h_expm1(ctx, node, x):
    e = ctx.b.node("Exp", [ctx.name_of(x)])
    return ctx.b.node("Sub", [e, ctx.scalar(1, x.dtype)])


@_register("aten.relu.default")
def _h_relu(ctx, node, x):
    return ctx.b.node("Max", [ctx.name_of(x), ctx.scalar(0, x.dtype)])


@_register("aten.silu.default")
def _h_silu(ctx, node, x):
    return ctx.b.node("Mul", [ctx.name_of(x),
                              ctx.b.node("Sigmoid", [ctx.name_of(x)])])


_ARITH = {"add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div",
          "maximum": "Max", "minimum": "Min", "pow": "Pow",
          "remainder": "Mod", "fmod": "Mod", "logical_and": "And",
          "logical_or": "Or", "logical_xor": "Xor", "bitwise_and": "And",
          "bitwise_or": "Or", "bitwise_xor": "Xor"}
_ARITH_NAMES = (
    [f"aten.{op}.{ov}" for op in ("add", "sub", "mul", "div", "remainder",
                                  "fmod", "bitwise_and", "bitwise_or",
                                  "bitwise_xor")
     for ov in ("Tensor", "Scalar")]
    + [f"aten.{op}.default" for op in ("maximum", "minimum", "logical_and",
                                       "logical_or", "logical_xor")]
    + ["aten.pow.Tensor_Scalar", "aten.pow.Tensor_Tensor"])


@_register(*_ARITH_NAMES)
def _h_arith(ctx, node, a, b, alpha=1):
    op_name = str(node.target).split(".")[1]
    op = _ARITH[op_name]
    dt = _out(node).dtype
    if op in ("And", "Or", "Xor") and dt != torch.bool:
        raise NotImplementedError(f"{node.target} on {dt}")
    an, bn = ctx.operand(a, dt), ctx.operand(b, dt)
    if alpha != 1:
        bn = ctx.b.node("Mul", [bn, ctx.scalar(alpha, dt)])
    if op == "Mod":
        return ctx.b.node(op, [an, bn], fmod=int(op_name == "fmod"))
    return ctx.b.node(op, [an, bn])


@_register("aten.pow.Scalar")
def _h_pow_scalar(ctx, node, base, exponent):
    dt = _out(node).dtype
    return ctx.b.node("Pow", [ctx.operand(base, dt),
                              ctx.operand(exponent, dt)])


@_register("aten.div.Tensor_mode", "aten.div.Scalar_mode")
def _h_div_mode(ctx, node, a, b, rounding_mode=None):
    dt = _out(node).dtype
    an, bn = ctx.operand(a, dt), ctx.operand(b, dt)
    q = ctx.b.node("Div", [an, bn])
    if rounding_mode is None:
        return q
    if dt.is_floating_point:
        if rounding_mode == "floor":
            return ctx.b.node("Floor", [q])
        return ctx.b.node("Mul", [ctx.b.node("Sign", [q]), ctx.b.node(
            "Floor", [ctx.b.node("Abs", [q])])])
    if rounding_mode == "trunc":        # integer Div truncates
        return q
    # floor of an integer quotient: truncate, then step down where the
    # remainder is non-zero and its sign differs from the divisor's
    r = ctx.b.node("Sub", [an, ctx.b.node("Mul", [q, bn])])
    zero = ctx.scalar(0, dt)
    nonzero = ctx.b.node("Not", [ctx.b.node("Equal", [r, zero])])
    differ = ctx.b.node("Xor", [ctx.b.node("Less", [r, zero]),
                                ctx.b.node("Less", [bn, zero])])
    step = ctx.b.node("Cast", [ctx.b.node("And", [nonzero, differ])],
                      to=_onnx_dtype(dt))
    return ctx.b.node("Sub", [q, step])


_COMPARE = {"eq": "Equal", "lt": "Less", "le": "LessOrEqual",
            "gt": "Greater", "ge": "GreaterOrEqual", "ne": "Equal"}


@_register(*[f"aten.{c}.{ov}" for c in _COMPARE
             for ov in ("Tensor", "Scalar")])
def _h_compare(ctx, node, a, b):
    c = str(node.target).split(".")[1]
    dt = _common(a, b)
    out = ctx.b.node(_COMPARE[c], [ctx.operand(a, dt), ctx.operand(b, dt)])
    return ctx.b.node("Not", [out]) if c == "ne" else out


@_register("aten.where.self", "aten.where.ScalarSelf",
           "aten.where.ScalarOther", "aten.where.Scalar")
def _h_where(ctx, node, cond, a, b):
    dt = _out(node).dtype
    return ctx.b.node("Where", [ctx.name_of(cond), ctx.operand(a, dt),
                                ctx.operand(b, dt)])


@_register("aten.masked_fill.Scalar", "aten.masked_fill.Tensor")
def _h_masked_fill(ctx, node, x, mask, value):
    dt = _out(node).dtype
    return ctx.b.node("Where", [ctx.name_of(mask), ctx.operand(value, dt),
                                ctx.cast(x, dt)])


@_register("aten.clamp.default", "aten.clamp.Tensor")
def _h_clamp(ctx, node, x, min=None, max=None):
    dt = _out(node).dtype
    xn = ctx.cast(x, dt)
    scalar = all(v is None or not isinstance(v, _Val) or v.shape == ()
                 for v in (min, max))
    if scalar:
        lo = "" if min is None else ctx.operand(min, dt)
        hi = "" if max is None else ctx.operand(max, dt)
        return ctx.b.node("Clip", [xn, lo, hi])
    if max is not None:
        xn = ctx.b.node("Min", [xn, ctx.operand(max, dt)])
    if min is not None:
        xn = ctx.b.node("Max", [xn, ctx.operand(min, dt)])
    return xn


@_register("aten._to_copy.default")
def _h_to_copy(ctx, node, x, **kwargs):
    return ctx.cast(x, _out(node).dtype)


@_register("aten.clone.default", "aten.alias.default")
def _h_identity(ctx, node, x, *args, **kwargs):
    return x


@_register("aten.view.default", "aten._unsafe_view.default",
           "aten.unsqueeze.default", "aten.squeeze.dim", "aten.squeeze.dims",
           "aten.squeeze.default")
def _h_reshape(ctx, node, x, *args):
    shape = tuple(_out(node).shape)
    if shape == x.shape:
        return x
    return ctx.b.node("Reshape", [ctx.name_of(x), ctx.b.i64(shape, "shape")])


@_register("aten.expand.default")
def _h_expand(ctx, node, x, *args, **kwargs):
    shape = tuple(_out(node).shape)
    if shape == x.shape:
        return x
    return ctx.b.node("Expand", [ctx.name_of(x), ctx.b.i64(shape, "shape")])


@_register("aten.permute.default")
def _h_permute(ctx, node, x, dims):
    perm = [int(d) % len(x.shape) for d in dims]
    if perm == list(range(len(perm))):
        return x
    return ctx.b.node("Transpose", [ctx.name_of(x)], perm=perm)


@_register("aten.cat.default")
def _h_cat(ctx, node, tensors, dim=0):
    dt = _out(node).dtype
    rank = len(_out(node).shape)
    parts = [t for t in tensors
             if not (len(t.shape) == 1 and t.shape[0] == 0 and rank != 1)]
    names = [ctx.cast(t, dt) for t in parts]
    return ctx.b.node("Concat", names, axis=int(dim) % rank)


@_register("aten.slice.Tensor")
def _h_slice(ctx, node, x, dim=0, start=None, end=None, step=1):
    dim = int(dim) % len(x.shape)
    s, e, st = slice(start, end, step).indices(x.shape[dim])
    if tuple(_out(node).shape) == x.shape:
        return x
    return ctx.b.node("Slice", [
        ctx.name_of(x), ctx.b.i64([s], "starts"), ctx.b.i64([e], "ends"),
        ctx.b.i64([dim], "axes"), ctx.b.i64([st], "steps")])


@_register("aten.flip.default")
def _h_flip(ctx, node, x, dims):
    dims = [int(d) % len(x.shape) for d in dims]
    n = len(dims)
    return ctx.b.node("Slice", [
        ctx.name_of(x), ctx.b.i64([-1] * n, "starts"),
        ctx.b.i64([-(2 ** 63)] * n, "ends"), ctx.b.i64(dims, "axes"),
        ctx.b.i64([-1] * n, "steps")])


@_register("aten.select.int")
def _h_select(ctx, node, x, dim, index):
    # a 1-element index and a Reshape: proto.tensor_proto writes a 0-dim
    # array as shape (1,), as the JAX package's writer does
    dim = int(dim) % len(x.shape)
    g = ctx.b.node("Gather", [ctx.name_of(x), ctx.b.i64(
        [int(index) % x.shape[dim]], "index")], axis=dim)
    return ctx.b.node("Reshape", [g, ctx.b.i64(_out(node).shape, "shape")])


@_register("aten.index_select.default")
def _h_index_select(ctx, node, x, dim, index):
    return ctx.b.node("Gather", [ctx.name_of(x), ctx.name_of(index)],
                      axis=int(dim) % len(x.shape))


@_register("aten.embedding.default")
def _h_embedding(ctx, node, weight, indices, *args):
    return ctx.b.node("Gather", [ctx.name_of(weight), ctx.name_of(indices)],
                      axis=0)


@_register("aten.index.Tensor")
def _h_index(ctx, node, x, indices):
    used = [i for i, ix in enumerate(indices) if ix is not None]
    if len(used) != 1:
        raise NotImplementedError("aten.index.Tensor with more than one "
                                  "index tensor")
    ix = indices[used[0]]
    if ix.dtype == torch.bool:
        raise NotImplementedError("aten.index.Tensor with a boolean mask")
    return ctx.b.node("Gather", [ctx.name_of(x), ctx.name_of(ix)],
                      axis=used[0])


@_register("aten.gather.default")
def _h_gather(ctx, node, x, dim, index, sparse_grad=False):
    """torch.gather with an index known at export: out[..., s, ...] =
    x[..., index[..., s, ...], ...] as one `Gather` with constant indices.
    The dims along which the index does not vary (U) stay batch dims; the
    others (V) are folded into the gathered axis, x laid out (U, V, R) and
    flattened to (|U|, |V|·R), the indices v·R + index[v, s]."""
    if not index.is_const:
        raise NotImplementedError("aten.gather.default with an index "
                                  "computed at run time")
    idx = index.const
    rank = idx.dim()
    dim = int(dim) % rank
    others = [d for d in range(rank) if d != dim]
    U = [d for d in others if idx.shape[d] == 1 or idx.stride(d) == 0
         or bool((idx == idx.narrow(d, 0, 1)).all())]
    V = [d for d in others if d not in U]
    R = x.shape[dim]
    xn = ctx.name_of(x)
    ends = [idx.shape[d] if d != dim else R for d in range(rank)]
    if tuple(ends) != x.shape:
        xn = ctx.b.node("Slice", [
            xn, ctx.b.i64([0] * rank, "starts"), ctx.b.i64(ends, "ends"),
            ctx.b.i64(list(range(rank)), "axes"),
            ctx.b.i64([1] * rank, "steps")])
    perm = U + V + [dim]
    if perm != list(range(rank)):
        xn = ctx.b.node("Transpose", [xn], perm=perm)
    pu = int(np.prod([idx.shape[d] for d in U]))
    pv = int(np.prod([idx.shape[d] for d in V]))
    S = idx.shape[dim]
    xn = ctx.b.node("Reshape", [xn, ctx.b.i64([pu, pv * R], "shape")])
    iv = idx
    for d in U:
        iv = iv.narrow(d, 0, 1)
    iv = iv.permute(perm).reshape(pv, S).to(torch.int64)
    flat = torch.arange(pv, dtype=torch.int64)[:, None] * R + iv
    g = ctx.b.node("Gather", [xn, ctx.b.const(flat.numpy(), "gather_idx")],
                   axis=1)
    g = ctx.b.node("Reshape", [g, ctx.b.i64(
        [idx.shape[d] for d in U + V] + [S], "shape")])
    inv = [perm.index(d) for d in range(rank)]
    if inv != list(range(rank)):
        g = ctx.b.node("Transpose", [g], perm=inv)
    return g


@_register("aten.constant_pad_nd.default")
def _h_pad(ctx, node, x, pad, value=0):
    rank = len(x.shape)
    cfg = [(0, 0)] * rank
    for i in range(len(pad) // 2):
        cfg[rank - 1 - i] = (int(pad[2 * i]), int(pad[2 * i + 1]))
    name = ctx.name_of(x)
    pos = [(max(lo, 0), max(hi, 0)) for lo, hi in cfg]
    neg = [(min(lo, 0), min(hi, 0)) for lo, hi in cfg]
    if any(p != (0, 0) for p in pos):
        pads = [p[0] for p in pos] + [p[1] for p in pos]
        name = ctx.b.node("Pad", [name, ctx.b.i64(pads, "pads"),
                                  ctx.scalar(value, x.dtype)],
                          mode="constant")
    if any(v != (0, 0) for v in neg):
        cur = [x.shape[d] + pos[d][0] + pos[d][1] for d in range(rank)]
        name = ctx.b.node("Slice", [
            name, ctx.b.i64([-lo for lo, _ in neg], "starts"),
            ctx.b.i64([cur[d] + neg[d][1] for d in range(rank)], "ends"),
            ctx.b.i64(list(range(rank)), "axes"),
            ctx.b.i64([1] * rank, "steps")])
    return name


@_register("aten.split_with_sizes.default", "aten.split.Tensor")
def _h_split(ctx, node, x, sizes, dim=0):
    dim = int(dim) % len(x.shape)
    sizes = [tuple(o.shape)[dim] for o in _out(node)]
    return ctx.b.add_node("Split", [ctx.name_of(x),
                                    ctx.b.i64(sizes, "split")],
                          n_out=len(sizes), axis=dim)


@_register("aten.unbind.int")
def _h_unbind(ctx, node, x, dim=0):
    dim = int(dim) % len(x.shape)
    n = x.shape[dim]
    parts = ctx.b.add_node("Split", [ctx.name_of(x),
                                     ctx.b.i64([1] * n, "split")],
                           n_out=n, axis=dim)
    return [ctx.b.node("Reshape", [p, ctx.b.i64(o.shape, "shape")])
            for p, o in zip(parts, _out(node))]


def _axes(x, dims) -> List[int]:
    rank = len(x.shape)
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return list(range(rank))
    if isinstance(dims, int):
        dims = [dims]
    return [int(d) % rank for d in dims]


@_register("aten.sum.dim_IntList", "aten.sum.default")
def _h_sum(ctx, node, x, dims=None, keepdim=False, dtype=None):
    xn = ctx.cast(x, _out(node).dtype)
    return ctx.b.node("ReduceSum", [xn, ctx.b.i64(_axes(x, dims), "axes")],
                      keepdims=int(bool(keepdim)))


_REDUCE = {"aten.mean.dim": "ReduceMean", "aten.mean.default": "ReduceMean",
           "aten.amax.default": "ReduceMax", "aten.amin.default": "ReduceMin",
           "aten.max.default": "ReduceMax", "aten.min.default": "ReduceMin"}


@_register(*_REDUCE)
def _h_reduce(ctx, node, x, dims=None, keepdim=False, dtype=None):
    return ctx.b.node(_REDUCE[str(node.target)],
                      [ctx.cast(x, _out(node).dtype)], axes=_axes(x, dims),
                      keepdims=int(bool(keepdim)))


@_register("aten.any.dim", "aten.any.dims", "aten.any.default",
           "aten.all.dim", "aten.all.dims", "aten.all.default")
def _h_any_all(ctx, node, x, dims=None, keepdim=False):
    xi = ctx.b.node("Cast", [ctx.name_of(x)], to=proto.INT32)
    op = "ReduceMax" if ".any." in str(node.target) else "ReduceMin"
    r = ctx.b.node(op, [xi], axes=_axes(x, dims), keepdims=int(bool(keepdim)))
    return ctx.b.node("Cast", [r], to=proto.BOOL)


@_register("aten.argmax.default", "aten.argmin.default")
def _h_argmax(ctx, node, x, dim=None, keepdim=False):
    op = "ArgMax" if "argmax" in str(node.target) else "ArgMin"
    xn = ctx.name_of(x)
    if dim is None:
        xn = ctx.b.node("Reshape", [xn, ctx.b.i64([-1], "shape")])
        dim = 0
    return ctx.b.node(op, [xn], axis=int(dim) % max(len(x.shape), 1),
                      keepdims=int(bool(keepdim)))


@_register("aten.max.dim", "aten.min.dim")
def _h_max_dim(ctx, node, x, dim, keepdim=False):
    big = ".max." in str(node.target)
    axis = int(dim) % len(x.shape)
    val = ctx.b.node("ReduceMax" if big else "ReduceMin", [ctx.name_of(x)],
                     axes=[axis], keepdims=int(bool(keepdim)))
    arg = ctx.b.node("ArgMax" if big else "ArgMin", [ctx.name_of(x)],
                     axis=axis, keepdims=int(bool(keepdim)))
    return [val, arg]


@_register("aten._softmax.default")
def _h_softmax(ctx, node, x, dim, half_to_float=False):
    return ctx.b.node("Softmax", [ctx.name_of(x)],
                      axis=int(dim) % len(x.shape))


@_register("aten._log_softmax.default")
def _h_log_softmax(ctx, node, x, dim, half_to_float=False):
    axis = int(dim) % len(x.shape)
    xn = ctx.name_of(x)
    m = ctx.b.node("ReduceMax", [xn], axes=[axis], keepdims=1)
    s = ctx.b.node("Sub", [xn, m])
    tot = ctx.b.node("ReduceSum", [ctx.b.node("Exp", [s]),
                                   ctx.b.i64([axis], "axes")], keepdims=1)
    return ctx.b.node("Sub", [s, ctx.b.node("Log", [tot])])


@_register("aten.native_layer_norm.default")
def _h_layer_norm(ctx, node, x, shape, weight, bias, eps):
    axes = list(range(len(x.shape) - len(shape), len(x.shape)))
    xn = ctx.name_of(x)
    mean = ctx.b.node("ReduceMean", [xn], axes=axes, keepdims=1)
    d = ctx.b.node("Sub", [xn, mean])
    var = ctx.b.node("ReduceMean", [ctx.b.node("Mul", [d, d])], axes=axes,
                     keepdims=1)
    rstd = ctx.b.node("Reciprocal", [ctx.b.node(
        "Sqrt", [ctx.b.node("Add", [var, ctx.scalar(eps, x.dtype)])])])
    out = ctx.b.node("Mul", [d, rstd])
    if weight is not None:
        out = ctx.b.node("Mul", [out, ctx.name_of(weight)])
    if bias is not None:
        out = ctx.b.node("Add", [out, ctx.name_of(bias)])
    return [out, mean, rstd]


@_register("aten.mm.default", "aten.bmm.default")
def _h_matmul(ctx, node, a, b):
    return ctx.b.node("MatMul", [ctx.name_of(a), ctx.name_of(b)])


@_register("aten.addmm.default")
def _h_addmm(ctx, node, bias, a, b, beta=1, alpha=1):
    dt = _out(node).dtype
    prod = ctx.b.node("MatMul", [ctx.name_of(a), ctx.name_of(b)])
    if alpha != 1:
        prod = ctx.b.node("Mul", [prod, ctx.scalar(alpha, dt)])
    bn = ctx.name_of(bias)
    if beta != 1:
        bn = ctx.b.node("Mul", [bn, ctx.scalar(beta, dt)])
    return ctx.b.node("Add", [prod, bn])


@_register("aten.convolution.default")
def _h_conv(ctx, node, x, w, bias, stride, padding, dilation, transposed,
            output_padding, groups):
    if transposed:
        raise NotImplementedError("aten.convolution.default transposed")
    names = [ctx.name_of(x), ctx.name_of(w)]
    if bias is not None:
        names.append(ctx.name_of(bias))
    pads = [int(p) for p in padding]
    return ctx.b.node("Conv", names, strides=[int(s) for s in stride],
                      pads=pads + pads, dilations=[int(d) for d in dilation],
                      group=int(groups))


_LIKE = ("aten.zeros_like.default", "aten.ones_like.default",
         "aten.full_like.default", "aten.empty_like.default")


@_register(*_LIKE)
def _h_like(ctx, node, x, fill=None, **kwargs):
    out = _out(node)
    value = {"zeros_like": 0, "ones_like": 1, "empty_like": 0}.get(
        str(node.target).split(".")[1], fill)
    return _Val.of_const(torch.full(tuple(out.shape), value,
                                    dtype=out.dtype))


# these only check metadata at run time; they compute nothing
_SKIP = ("aten._assert_tensor_metadata.default", "aten._assert_scalar.default",
         "aten.sym_constrain_range_for_size.default",
         "aten._assert_async.msg")


# ----------------------------------------------------------- conversion

def decompositions() -> Dict[Any, Callable]:
    """The core-ATen decomposition table, with kernel B1's custom op
    decomposed into its plain version."""
    from ..ops.attn_weights import attn_weights_plain
    table = torch.export.default_decompositions()
    table[torch.ops.speech2text_torch.attn_weights.default] = \
        attn_weights_plain
    return table


def _tree_map(fn, x):
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, y) for y in x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return fn(x)


def _leaves(x) -> List[Any]:
    if isinstance(x, (list, tuple)):
        return [y for part in x for y in _leaves(part)]
    if isinstance(x, dict):
        return [y for v in x.values() for y in _leaves(v)]
    return [x]


def _cpu(x):
    if isinstance(x, torch.device):
        return torch.device("cpu")
    return x


def _fold(node, args, kwargs):
    """Run a node whose tensor inputs are all constants on the CPU."""
    def const(v):
        return v.const if isinstance(v, _Val) else v
    cargs = _tree_map(const, args)
    ckwargs = {k: _cpu(_tree_map(const, v)) for k, v in kwargs.items()}
    try:
        with torch.no_grad():
            out = node.target(*cargs, **ckwargs)
    except Exception:                        # left to the op's handler
        return None
    if isinstance(out, torch.Tensor):
        return _Val.of_const(out)
    if isinstance(out, (list, tuple)) and all(
            isinstance(o, torch.Tensor) for o in out):
        return [_Val.of_const(o) for o in out]
    return None


def _wrap(result, meta):
    """A handler's result (ONNX names or values) as values with the
    node's shapes and dtypes."""
    if isinstance(result, (list, tuple)):
        return [_wrap(r, m) for r, m in zip(result, meta)]
    if isinstance(result, _Val):
        return result
    return _Val(tuple(meta.shape), meta.dtype, name=result)


def convert(program: "torch.export.ExportedProgram",
            graph_name: str = "graph",
            input_names: Optional[Sequence[str]] = None,
            output_names: Optional[Sequence[str]] = None,
            metadata: Optional[Dict[str, str]] = None,
            opset: int = 17) -> bytes:
    """Lower `program` to a serialized ModelProto. Its tensor inputs
    become the graph inputs in the program's flattened order (named
    `input_names`, default input_{i}), its outputs the graph outputs
    (`output_names`, default output_{i}); parameters, buffers and
    constants become initializers."""
    from torch.export.graph_signature import InputKind, OutputKind
    ep = program.run_decompositions(decompositions())
    sig = ep.graph_signature
    b = _GraphWriter()
    ctx = _Ctx(b)
    specs = {s.arg.name: s for s in sig.input_specs
             if hasattr(s.arg, "name")}
    user = [s.arg.name for s in sig.input_specs
            if s.kind == InputKind.USER_INPUT and hasattr(s.arg, "name")]
    if input_names is None:
        input_names = [f"input_{i}" for i in range(len(user))]
    if len(input_names) != len(user):
        raise ValueError(f"{len(user)} graph inputs but {len(input_names)} "
                         f"names")
    graph_name_of = dict(zip(user, input_names))
    env: Dict[Any, Any] = {}
    graph_inputs = []
    for node in ep.graph.nodes:
        if node.op == "placeholder":
            spec = specs.get(node.name)
            if spec is None or spec.kind == InputKind.USER_INPUT:
                val = node.meta.get("val")
                if not isinstance(val, torch.Tensor):
                    env[node] = val
                    continue
                name = graph_name_of[node.name]
                env[node] = _Val(val.shape, val.dtype, name=name)
                graph_inputs.append(proto.value_info_proto(
                    name, _onnx_dtype(val.dtype), tuple(val.shape)))
                continue
            if spec.kind in (InputKind.PARAMETER, InputKind.BUFFER,
                             InputKind.CONSTANT_TENSOR):
                t = ep.state_dict.get(spec.target)
                if t is None:
                    t = ep.constants[spec.target]
                env[node] = _Val.of_const(t.detach().cpu())
                continue
            raise NotImplementedError(f"program input of kind {spec.kind}")
        if node.op == "get_attr":
            t = getattr(ep.graph_module, node.target)
            env[node] = _Val.of_const(t.detach().cpu())
            continue
        if node.op == "output":
            outs = node.args[0]
            break
        if node.op != "call_function":
            raise NotImplementedError(f"FX node {node.op}")
        args = _tree_map(lambda a: env[a] if isinstance(a, torch.fx.Node)
                         else a, node.args)
        kwargs = {k: _tree_map(lambda a: env[a]
                               if isinstance(a, torch.fx.Node) else a, v)
                  for k, v in node.kwargs.items()}
        if node.target is operator.getitem:
            env[node] = args[0][args[1]]
            continue
        op = str(node.target)
        if op in _SKIP:
            env[node] = None
            continue
        vals = [v for v in _leaves((args, kwargs)) if isinstance(v, _Val)]
        if all(v.is_const for v in vals):
            folded = _fold(node, args, kwargs)
            if folded is not None:
                env[node] = folded
                continue
        if op not in _HANDLERS:
            raise NotImplementedError(
                f"ATen op '{op}' is not supported by the ONNX emitter")
        result = _HANDLERS[op](ctx, node, *args, **kwargs)
        if isinstance(result, str) and not tuple(_out(node).shape):
            # a 0-dim constant operand is written as shape (1,) (see
            # _h_select), which would widen a scalar result
            result = b.node("Reshape", [result, b.i64([], "shape")])
        env[node] = _wrap(result, _out(node))

    out_specs = sig.output_specs
    if any(s.kind != OutputKind.USER_OUTPUT for s in out_specs):
        raise NotImplementedError("programs that mutate buffers")
    out_vals = [env[o] if isinstance(o, torch.fx.Node) else o for o in outs]
    if output_names is None:
        output_names = [f"output_{i}" for i in range(len(out_vals))]
    graph_outputs = []
    for name, val in zip(output_names, out_vals):
        b.nodes.append(proto.node_proto("Identity", [ctx.name_of(val)],
                                        [name], name=b.fresh("n_out")))
        graph_outputs.append(proto.value_info_proto(
            name, _onnx_dtype(val.dtype), val.shape))
    g = proto.graph_proto(graph_name, b.nodes, b.initializers, graph_inputs,
                          graph_outputs)
    return proto.model_proto(g, opset=opset, metadata=metadata)
