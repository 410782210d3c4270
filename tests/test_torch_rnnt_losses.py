"""Transducer losses of the port (speech2text_torch/ops/rnnt.py,
ops/pruned_rnnt.py, losses.py, the joiner's pruning branch) against the
JAX package on the same numpy inputs.

Tolerances: f32 values rtol 1e-5, gradients and occupancies rtol 1e-4
(both with a small atol for entries near 0); prune ranges exactly equal.
The lattice runs through its autograd.Function's CPU route (the plain
forward loop and the plain walk back), which is also held against
autograd through the plain loop.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_tpu.models.joiner import Joiner as JJoiner
from speech2text_tpu.models.joiner import JoinerConfig as JJoinerConfig
from speech2text_tpu.ops import pruned_rnnt as jp
from speech2text_tpu.ops import rnnt as jr
from speech2text_torch.convert import flax_to_state_dict
from speech2text_torch.losses import CtcLoss, Loss, MaeLoss, MaskedCeLoss, \
    MaskedKlDivLoss, RnntLoss
from speech2text_torch.models.joiner import Joiner, JoinerConfig
from speech2text_torch.ops import pruned_rnnt as tp
from speech2text_torch.ops import rnnt as tr

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
OCC = dict(rtol=1e-4, atol=1e-5)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _lens(rng, B, T, U):
    """Lengths with a full utterance, a one-frame label-free one and
    random others."""
    t = rng.integers(1, T + 1, B)
    u = rng.integers(0, U + 1, B)
    t[0], u[0] = T, U
    t[1], u[1] = 1, 0
    return t.astype(np.int32), u.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_lattice_values_and_occupancies(seed):
    rng = np.random.default_rng(seed)
    B, T, U = 5, 9, 4
    px = rng.standard_normal((B, T, U)).astype(np.float32) - 1.0
    py = rng.standard_normal((B, T, U + 1)).astype(np.float32) - 1.0
    t_lens, u_lens = _lens(rng, B, T, U)
    total, occ = jax.jit(lambda a, b: jp._simple_fwd_impl(
        a, b, jnp.asarray(t_lens), jnp.asarray(u_lens)))(px, py)
    tpx, tpy = _t(px, True), _t(py, True)
    got = tr.lattice_forward(tpx, tpy, _t(t_lens), _t(u_lens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(total), **VAL)
    got.sum().backward()
    np.testing.assert_allclose(tpx.grad.numpy(), np.asarray(occ[0]), **OCC)
    np.testing.assert_allclose(tpy.grad.numpy(), np.asarray(occ[1]), **OCC)


def test_logaddexp_nan_safe():
    a = _t(np.array([tr.NEG_INF, tr.NEG_INF, 0.5, -3.0], np.float32), True)
    b = _t(np.array([tr.NEG_INF, 1.0, tr.NEG_INF, -3.0], np.float32), True)
    out = tr._logaddexp(a, b)
    assert out[0].item() == np.float32(tr.NEG_INF)
    out.sum().backward()
    assert torch.isfinite(a.grad).all() and torch.isfinite(b.grad).all()
    np.testing.assert_allclose(a.grad.numpy(), [0, 0, 1, 0.5], atol=1e-6)


def _smoothed_inputs(seed, B=4, T=8, U=5, C=7):
    rng = np.random.default_rng(seed)
    lm = rng.standard_normal((B, U + 1, C)).astype(np.float32)
    am = rng.standard_normal((B, T, C)).astype(np.float32)
    sym = rng.integers(1, C, (B, U)).astype(np.int32)
    t_lens, u_lens = _lens(rng, B, T, U)
    return lm, am, sym, t_lens, u_lens


@pytest.mark.parametrize("scales", [(0.0, 0.0), (0.25, 0.1)])
def test_smoothed_loss_values_grads_and_ranges(scales):
    lm, am, sym, t_lens, u_lens = _smoothed_inputs(3)
    lm_s, am_s = scales

    def jloss(lm_, am_):
        loss, occ = jp.rnnt_loss_smoothed(
            lm_, am_, sym, t_lens, u_lens, lm_only_scale=lm_s,
            am_only_scale=am_s)
        return loss, occ

    (want, (jopx, jopy)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(lm, am)
    tlm, tam = _t(lm, True), _t(am, True)
    got, (opx, opy) = tp.rnnt_loss_smoothed(
        tlm, tam, _t(sym), _t(t_lens), _t(u_lens), lm_only_scale=lm_s,
        am_only_scale=am_s)
    np.testing.assert_allclose(got.item(), float(want), **VAL)
    np.testing.assert_allclose(opx.numpy(), np.asarray(jopx), **OCC)
    np.testing.assert_allclose(opy.numpy(), np.asarray(jopy), **OCC)
    assert not opx.requires_grad and not opy.requires_grad
    got.backward()
    np.testing.assert_allclose(tlm.grad.numpy(), np.asarray(jgrads[0]),
                               **GRAD)
    np.testing.assert_allclose(tam.grad.numpy(), np.asarray(jgrads[1]),
                               **GRAD)
    for r in (2, 3):
        np.testing.assert_array_equal(
            tp.get_rnnt_prune_ranges(opx, opy, _t(t_lens), _t(u_lens),
                                     r).numpy(),
            np.asarray(jp.get_rnnt_prune_ranges(jopx, jopy, t_lens, u_lens,
                                                s_range=r)))


@pytest.mark.parametrize("seed,U,s_range", [(0, 6, 3), (1, 9, 4), (2, 2, 5),
                                            (3, 0, 2)])
def test_prune_ranges_exactly_equal(seed, U, s_range):
    """Random occupancies and lengths, with t_len = 1, u_len = 0 and (for
    U = 2, 0) U+1 < s_range."""
    rng = np.random.default_rng(seed)
    B, T = 6, 11
    px = rng.uniform(0, 1, (B, T, U)).astype(np.float32)
    py = rng.uniform(0, 1, (B, T, U + 1)).astype(np.float32)
    t_lens, u_lens = _lens(rng, B, T, U)
    want = np.asarray(jp.get_rnnt_prune_ranges(px, py, t_lens, u_lens,
                                               s_range=s_range))
    got = tp.get_rnnt_prune_ranges(_t(px), _t(py), _t(t_lens), _t(u_lens),
                                   s_range)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_do_rnnt_pruning(dtype):
    rng = np.random.default_rng(4)
    B, T, U, E, R = 3, 6, 4, 5, 3
    am = rng.standard_normal((B, T, E)).astype(np.float32)
    lm = rng.standard_normal((B, U + 1, E)).astype(np.float32)
    ranges = np.sort(rng.integers(0, U, (B, T)), axis=1).astype(np.int32)
    ja, jl = jp.do_rnnt_pruning(jnp.asarray(am, dtype),
                                jnp.asarray(lm, dtype), ranges, R)
    tdt = getattr(torch, dtype)
    ta, tl = tp.do_rnnt_pruning(_t(am).to(tdt), _t(lm).to(tdt), _t(ranges),
                                R)
    assert tl.dtype == tdt and tuple(tl.shape) == (B, T, R, E)
    np.testing.assert_array_equal(ta.float().numpy(),
                                  np.asarray(ja, np.float32))
    np.testing.assert_array_equal(tl.float().numpy(),
                                  np.asarray(jl, np.float32))


def test_pruned_loss_values_and_grads():
    """Ranges from the smoothed loss; one utterance with no frame is
    infeasible and gives 0."""
    rng = np.random.default_rng(5)
    B, T, U, V, R = 5, 9, 6, 8, 3
    t_lens, u_lens = _lens(rng, B, T, U)
    t_lens[4] = 0
    px = rng.uniform(0, 1, (B, T, U)).astype(np.float32)
    py = rng.uniform(0, 1, (B, T, U + 1)).astype(np.float32)
    ranges = np.asarray(jp.get_rnnt_prune_ranges(px, py, t_lens, u_lens,
                                                 s_range=R))
    logits = rng.standard_normal((B, T, R, V)).astype(np.float32)
    sym = rng.integers(1, V, (B, U)).astype(np.int32)
    want_nll = np.asarray(jp.rnnt_loss_pruned(logits, sym, ranges, t_lens,
                                              u_lens, reduction="none"))
    want, jg = jax.jit(jax.value_and_grad(lambda x: jp.rnnt_loss_pruned(
        x, sym, ranges, t_lens, u_lens)))(logits)
    assert want_nll[4] == 0.0
    tl = _t(logits, True)
    args = (_t(sym), _t(ranges), _t(t_lens), _t(u_lens))
    nll = tp.rnnt_loss_pruned(tl, *args, reduction="none")
    np.testing.assert_allclose(nll.detach().numpy(), want_nll, **VAL)
    got = tp.rnnt_loss_pruned(tl, *args)
    np.testing.assert_allclose(got.item(), float(want), **VAL)
    got.backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), **GRAD)
    assert (tl.grad[4] == 0).all()


def test_loss_factory():
    loss = Loss({"model": "Pruned_Rnnt",
                 "config": {"termination_symbol": 0, "reduction": "sum",
                            "clamp": 1.0}})
    assert loss.config.reduction == "sum"
    assert isinstance(Loss({"model": "CTC"}), CtcLoss)
    assert isinstance(Loss({"model": "Rnnt"}), RnntLoss)
    # the CIF, SSL and NNLM losses (tests/test_torch_nnlm.py)
    for key, cls in (("MaskedCELoss", MaskedCeLoss),
                     ("MaskedKLDiv", MaskedKlDivLoss), ("MaeLoss", MaeLoss)):
        assert isinstance(Loss({"model": key, "config": {}}), cls)
    with pytest.raises(ValueError):
        Loss({"model": "Nope"})


@pytest.mark.parametrize("prune_range,lm_scale", [(3, 0.0), (2, 0.25),
                                                  (-1, 0.0)])
def test_joiner_forward_and_grads(prune_range, lm_scale):
    """The joiner's training forward, pruned and unpruned: logits, ranges,
    simple loss, and the gradients of simple + pruned loss with respect to
    the encoder and predictor outputs."""
    rng = np.random.default_rng(6)
    B, T, U, D, V = 3, 8, 5, 12, 9
    kw = dict(input_dim=D, output_dim=V, inner_dim=10, prune_range=prune_range,
              lm_scale=lm_scale, am_scale=0.5 * lm_scale,
              use_out_project=True)
    jj = JJoiner(JJoinerConfig(**kw))
    enc = rng.standard_normal((B, T, D)).astype(np.float32)
    pred = rng.standard_normal((B, U + 1, D)).astype(np.float32)
    tgt = rng.integers(1, V, (B, U)).astype(np.int32)
    t_lens, u_lens = _lens(rng, B, T, U)
    params = jj.init(jax.random.PRNGKey(0), enc, t_lens, pred, u_lens,
                     tgt)["params"]
    tj = Joiner(JoinerConfig(**kw))
    tj.load_state_dict(flax_to_state_dict(params, tj))

    def jloss(e, p):
        logits, ranges, simple = jj.apply({"params": params}, e, t_lens, p,
                                          u_lens, tgt)
        if prune_range <= 0:
            return jnp.sum(logits ** 2) * 1e-3, (logits, ranges, simple)
        pruned = jp.rnnt_loss_pruned(logits, tgt, ranges, t_lens, u_lens)
        return 0.5 * simple + 0.5 * pruned, (logits, ranges, simple)

    (_, (jl, jrng, jsim)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(enc, pred)
    te, tpr = _t(enc, True), _t(pred, True)
    logits, ranges, simple = tj(te, _t(t_lens), tpr, _t(u_lens), _t(tgt))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), **VAL)
    if prune_range <= 0:
        assert ranges is None and simple is None
        assert tuple(logits.shape) == (B, T, U + 1, V)
        loss = (logits ** 2).sum() * 1e-3
    else:
        assert tuple(logits.shape) == (B, T, prune_range, V)
        np.testing.assert_array_equal(ranges.numpy(), np.asarray(jrng))
        np.testing.assert_allclose(simple.item(), float(jsim), **VAL)
        loss = 0.5 * simple + 0.5 * tp.rnnt_loss_pruned(
            logits, _t(tgt), ranges, _t(t_lens), _t(u_lens))
    loss.backward()
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jg[0]), **GRAD)
    np.testing.assert_allclose(tpr.grad.numpy(), np.asarray(jg[1]), **GRAD)


def _pruned_band(seed):
    """The arcs `rnnt_loss_pruned` hands the lattice (window log-probs in
    (t, u), NEG_INF off the windows), with its lengths."""
    rng = np.random.default_rng(seed)
    B, T, U, V, R = 5, 9, 6, 8, 3
    t_lens, u_lens = _lens(rng, B, T, U)
    occ = (_t(rng.uniform(0, 1, (B, T, U)).astype(np.float32)),
           _t(rng.uniform(0, 1, (B, T, U + 1)).astype(np.float32)))
    ranges = tp.get_rnnt_prune_ranges(*occ, _t(t_lens), _t(u_lens), R)
    logits = _t(rng.standard_normal((B, T, R, V)).astype(np.float32))
    sym = _t(rng.integers(1, V, (B, U)).astype(np.int32))
    seen = []

    def spy(px, py, tl, ul):
        seen.append((px.numpy(), py.numpy()))
        return tr.lattice_forward(px, py, tl, ul)

    with mock.patch.object(tp, "lattice_forward", spy):
        tp.rnnt_loss_pruned(logits, sym, ranges, _t(t_lens), _t(u_lens))
    return (*seen[0], t_lens, u_lens)


def _lattice_case(kind, seed):
    if kind == "band":
        return _pruned_band(seed)
    rng = np.random.default_rng(seed)
    B, T, U = 5, 9, 4
    px = rng.standard_normal((B, T, U)).astype(np.float32) - 1.0
    py = rng.standard_normal((B, T, U + 1)).astype(np.float32) - 1.0
    return (px, py, *_lens(rng, B, T, U))


@pytest.mark.parametrize("kind,seed", [("lens", 0), ("lens", 1),
                                       ("band", 5), ("band", 6)])
def test_lattice_backward_plain(kind, seed):
    """The walk back (kernel B3's plain backward) against autograd through
    the plain loop and against the JAX package's vjp, for an incoming
    gradient with a 0: the same gradients where the utterance has a path,
    0 where it has none or g = 0, no NaN."""
    px, py, t_lens, u_lens = _lattice_case(kind, seed)
    g = np.random.default_rng(seed + 10).uniform(
        -2, 2, px.shape[0]).astype(np.float32)
    g[2] = 0.0
    args = (_t(t_lens), _t(u_lens))
    total, alpha = tr.lattice_forward_plain(_t(px), _t(py), *args)
    gpx, gpy = tr.lattice_backward_plain(_t(px), _t(py), *args, alpha,
                                         total, _t(g))
    tpx, tpy = _t(px, True), _t(py, True)
    want, _ = tr.lattice_forward_plain(tpx, tpy, *args)
    (want * _t(g)).sum().backward()
    jtotal, vjp = jax.vjp(lambda a, b: jr.lattice_forward(a, b, t_lens,
                                                          u_lens), px, py)
    jpx, jpy = (np.asarray(a) for a in vjp(g))
    path = total.numpy() > tr.NEG_INF / 2
    assert path.sum() >= 3 and not (gpx.isnan().any() or gpy.isnan().any())
    np.testing.assert_array_equal(total.numpy(), want.detach().numpy())
    np.testing.assert_allclose(total.numpy()[path], np.asarray(jtotal)[path],
                               **VAL)
    for got, oracle, jax_grad in ((gpx, tpx.grad, jpx), (gpy, tpy.grad, jpy)):
        got = got.numpy()
        np.testing.assert_allclose(got[path], oracle.numpy()[path], **GRAD)
        np.testing.assert_allclose(got[path], jax_grad[path], **GRAD)
        assert (got[~path] == 0).all() and (got[2] == 0).all()


def _old_occupancies(px, py, t_lens, u_lens):
    """The simple loss's occupancies as autograd through the plain loop
    gives them."""
    with torch.enable_grad():
        a, b = px.detach().requires_grad_(), py.detach().requires_grad_()
        total, _ = tr.lattice_forward_plain(a, b, t_lens, u_lens)
        return (total.detach(), *torch.autograd.grad(total.sum(), (a, b)))


def _loss_run(loss):
    """(value, gradients) of one loss on fixed inputs, through whatever
    lattice the modules hold now."""
    rng = np.random.default_rng(7)
    B, T, U, V, C, R = 4, 8, 5, 6, 7, 3
    t_lens, u_lens = _lens(rng, B, T, U)
    sym = _t(rng.integers(1, V, (B, U)).astype(np.int32))
    lens = (_t(t_lens), _t(u_lens))
    if loss.startswith("rnnt"):
        x = _t(rng.standard_normal((B, T, U + 1, V)).astype(np.float32), True)
        clamp = 0.05 if loss == "rnnt_clamp" else -1.0
        val = tr.rnnt_loss(x, sym, *lens, reduction="sum", clamp=clamp)
        inputs = (x,)
    elif loss == "smoothed":
        lm, am, sym, t_lens, u_lens = _smoothed_inputs(8, B, T, U, C)
        inputs = (_t(lm, True), _t(am, True))
        val, _ = tp.rnnt_loss_smoothed(*inputs, _t(sym), _t(t_lens),
                                       _t(u_lens), lm_only_scale=0.25,
                                       am_only_scale=0.1)
    else:
        ranges = np.sort(rng.integers(0, U - 1, (B, T)), axis=1)
        ranges[:, 0] = 0
        occ = (_t(rng.uniform(0, 1, (B, T, U)).astype(np.float32)),
               _t(rng.uniform(0, 1, (B, T, U + 1)).astype(np.float32)))
        ranges = tp.get_rnnt_prune_ranges(*occ, *lens, R)
        x = _t(rng.standard_normal((B, T, R, V)).astype(np.float32), True)
        val = tp.rnnt_loss_pruned(x, sym, ranges, *lens)
        inputs = (x,)
    val.backward()
    return val.detach().numpy(), [t.grad.numpy() for t in inputs]


@pytest.mark.parametrize("loss", ["rnnt", "rnnt_clamp", "smoothed",
                                  "pruned"])
def test_lattice_function_cpu_route_keeps_values(loss):
    """The losses on the CPU through the lattice Function (plain forward,
    plain walk back) give the values and gradients they gave through
    autograd over the loop."""
    got, got_grads = _loss_run(loss)
    old = lambda px, py, tl, ul: tr.lattice_forward_plain(px, py, tl, ul)[0]
    with mock.patch.object(tr, "lattice_forward", old), \
            mock.patch.object(tp, "lattice_forward", old), \
            mock.patch.object(tp, "lattice_occupancies", _old_occupancies):
        want, want_grads = _loss_run(loss)
    np.testing.assert_allclose(got, want, **VAL)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, w, **GRAD)


def test_pruned_loss_infeasible_utterance():
    """An utterance whose labels do not fit its pruned lattice (more labels
    than frames at R = 2, so its last window cannot hold u_len) gives loss
    0 and gradient 0, the others the JAX package's values, and no NaN.
    (The JAX package reads that utterance's total at a clipped window
    position instead, so its value is not compared.)"""
    rng = np.random.default_rng(9)
    B, T, U, V, R = 3, 4, 6, 5, 2
    t_lens = np.array([4, 4, 3], np.int32)
    u_lens = np.array([6, 3, 2], np.int32)
    occ = (rng.uniform(0, 1, (B, T, U)).astype(np.float32),
           rng.uniform(0, 1, (B, T, U + 1)).astype(np.float32))
    ranges = np.asarray(jp.get_rnnt_prune_ranges(*occ, t_lens, u_lens,
                                                 s_range=R))
    logits = rng.standard_normal((B, T, R, V)).astype(np.float32)
    sym = rng.integers(1, V, (B, U)).astype(np.int32)
    want = np.asarray(jp.rnnt_loss_pruned(logits, sym, ranges, t_lens,
                                          u_lens, reduction="none"))
    tl = _t(logits, True)
    nll = tp.rnnt_loss_pruned(tl, _t(sym), _t(ranges), _t(t_lens),
                              _t(u_lens), reduction="none")
    nll.sum().backward()
    assert nll[0].item() == 0.0
    np.testing.assert_allclose(nll.detach().numpy()[1:], want[1:], **VAL)
    assert (tl.grad[0] == 0).all() and not tl.grad.isnan().any()
    assert (tl.grad[1:] != 0).any()


@pytest.mark.parametrize("case,match", [
    ("shape", "not \\(B,T,U\\)"), ("lens", "lengths"), ("dtype", "f32"),
    ("float_lens", "integers"), ("width", "U\\+1"), ("device", "CUDA")])
def test_lattice_cuda_wrapper_checks(case, match):
    """Kernel B3's wrappers refuse operands it does not take before any
    build or launch (no card needed)."""
    B, T, U = 2, 5, 3
    px, py = torch.zeros(B, T, U), torch.zeros(B, T, U + 1)
    tl, ul = torch.tensor([5, 3]), torch.tensor([3, 1])
    if case == "shape":
        py = torch.zeros(B, T, U)
    elif case == "lens":
        tl = torch.tensor([5])
    elif case == "dtype":
        px, py = px.double(), py.double()
    elif case == "float_lens":
        ul = ul.float()
    elif case == "width":
        px, py = torch.zeros(1, 1, tr.MAX_U1), torch.zeros(1, 1, tr.MAX_U1 + 1)
        tl, ul = torch.tensor([1]), torch.tensor([1])
    launches = tr.KERNEL.launches
    with pytest.raises(ValueError, match=match):
        tr.lattice_forward_cuda(px, py, tl, ul)
    with pytest.raises(ValueError, match=match):
        tr.lattice_backward_cuda(px, py, tl, ul, py, px[:, 0, 0],
                                 px[:, 0, 0])
    assert tr.KERNEL.launches == launches and tr.KERNEL._lib is None
