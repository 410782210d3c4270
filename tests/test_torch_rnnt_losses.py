"""Transducer losses of the port (speech2text_torch/ops/rnnt.py,
ops/pruned_rnnt.py, losses.py, the joiner's pruning branch) against the
JAX package on the same numpy inputs.

Tolerances: f32 values rtol 1e-5, gradients and occupancies rtol 1e-4
(both with a small atol for entries near 0); prune ranges exactly equal.
"""

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
