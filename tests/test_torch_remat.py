"""Zipformer2's activation recompute (`remat`, `remat_policy`) and the
`scan_layers` checkpoint layout in the port, on the CPU.

- A tiny Zipformer2 in training (dropout, the feature mask, and in one
  case the training dynamics, every draw from one seeded generator):
  the output and every gradient with `remat` "full" and "dots" equal the
  run without recompute bit for bit, the generator ends in the same
  state, and kernel B1's plain version runs twice per layer under
  "full" (the recompute) and once under "dots" (its weights kept).
- "full" against the JAX package's `remat=True` (use_flash_attn, the
  Pallas kernel in interpret mode, as tests/test_torch_zipformer_dynamics
  .py runs it), dropout and feature mask off: the output, the input
  gradient and every parameter gradient at that file's tolerances (rtol
  1e-4, atol 1e-4 of the largest output / input-gradient magnitude and
  1e-5 of the largest parameter-gradient entry).
- A policy other than "full" or "dots" raises when `remat` is on.
- A parameter tree in JAX's `scan_layers` layout (`stack_layer_params`
  of the unrolled tree, shaped as JAX's own scan init) converts to the
  same state_dict as the unrolled tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_tpu.models import zipformer as jz
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.models import zipformer as tz
from speech2text_torch.ops import attn_weights as taw
from test_torch_zipformer_dynamics import _close, _grads_close, _perturbed

TINY = dict(
    feature_dim=80, downsampling_factor=(1, 2), num_encoder_layers=(2, 1),
    feedforward_dim=(64, 64), encoder_dim=(32, 64),
    encoder_unmasked_dim=(24, 24), num_heads=(2, 2), query_head_dim=8,
    value_head_dim=8, pos_head_dim=4, pos_dim=16, cnn_module_kernel=(7, 7),
    dropout=0.1, feature_mask_dropout_prob=0.15)
N_LAYERS = 3


def _inputs(seed, B=3, T=48):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, 80)).astype(np.float32)
    lens = np.array([T - 9 * i for i in range(B)], np.int32)
    return x, lens


def _train_pass(model, x, lens, g_out, seed, step):
    """One training forward and backward from a generator seeded `seed`:
    (output, input gradient, parameter gradients, generator state)."""
    model.zero_grad()
    gen = torch.Generator().manual_seed(seed)
    xt = torch.tensor(x, requires_grad=True)
    out, _ = model(xt, torch.from_numpy(lens), training=True,
                   generator=gen, step=step)
    out.backward(g_out)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return out.detach(), xt.grad, grads, gen.get_state()


@pytest.mark.parametrize("dynamics", [False, True])
def test_recompute_is_bitwise(dynamics, monkeypatch):
    base = tz.Zipformer2(tz.Zipformer2Config.from_config(
        dict(TINY, dynamics=dynamics)))
    _perturbed(base, 3)
    x, lens = _inputs(1)
    calls = []
    plain = taw.attn_weights_plain

    def counted(*a):
        calls.append(1)
        return plain(*a)

    monkeypatch.setattr(taw, "attn_weights_plain", counted)
    step = 1000 if dynamics else None
    g_out = None
    runs = {}
    for policy in (None, "full", "dots"):
        cfg = dict(TINY, dynamics=dynamics, remat=policy is not None,
                   remat_policy=policy or "full")
        model = tz.Zipformer2(tz.Zipformer2Config.from_config(cfg))
        model.load_state_dict(base.state_dict())
        if g_out is None:
            with torch.no_grad():
                shape = model(torch.from_numpy(x),
                              torch.from_numpy(lens))[0].shape
            g_out = torch.from_numpy(np.random.default_rng(2).standard_normal(
                shape).astype(np.float32))
        calls.clear()
        runs[policy] = _train_pass(model, x, lens, g_out, 7, step)
        runs[policy] += (len(calls),)
    want = runs[None]
    assert want[4] == N_LAYERS
    assert runs["full"][4] == 2 * N_LAYERS and runs["dots"][4] == N_LAYERS
    for policy in ("full", "dots"):
        out, gx, grads, state, _ = runs[policy]
        assert torch.equal(out, want[0]), policy
        assert torch.equal(gx, want[1]), policy
        assert grads.keys() == want[2].keys()
        for k, g in want[2].items():
            assert torch.equal(grads[k], g), (policy, k)
        assert torch.equal(state, want[3]), policy
    # dropout took part: another seed gives another output
    other = _train_pass(model, x, lens, g_out, 8, step)
    assert not torch.equal(other[0], want[0])


def test_full_matches_jax_remat():
    cfg = dict(TINY, dropout=0.0, feature_mask_dropout_prob=0.0)
    tm = tz.Zipformer2(tz.Zipformer2Config.from_config(
        dict(cfg, remat=True, remat_policy="full")))
    params = _perturbed(tm, 5)
    jm = jz.Zipformer2(jz.Zipformer2Config(**cfg, remat=True,
                                           use_flash_attn=True,
                                           flash_min_batch=0))
    x, lens = _inputs(4)

    def fwd(p, xx):
        out, _ = jm.apply({"params": p}, xx, jnp.asarray(lens),
                          deterministic=False)
        return out

    want, vjp = jax.vjp(jax.jit(fwd), params, jnp.asarray(x))
    g = np.random.default_rng(6).standard_normal(want.shape).astype(
        np.float32)
    jgrads, jgx = jax.jit(vjp)(jnp.asarray(g))
    tm.zero_grad()
    xt = torch.tensor(x, requires_grad=True)
    out, _ = tm(xt, torch.from_numpy(lens), training=True,
                generator=torch.Generator().manual_seed(0))
    _close(out.detach(), want, what="output")
    out.backward(torch.from_numpy(g))
    _close(xt.grad, jgx, what="input grad")
    _grads_close(tm, jgrads, "remat full")


def test_bad_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        tz.Zipformer2(tz.Zipformer2Config.from_config(
            dict(TINY, remat=True, remat_policy="offload")))
    # as in JAX, the policy is read only when remat is on
    tz.Zipformer2(tz.Zipformer2Config.from_config(
        dict(TINY, remat=False, remat_policy="offload")))


def test_scan_layers_tree_converts():
    """JAX scans a stack of more than one layer: two stacks of two."""
    cfg = dict(TINY, num_encoder_layers=(2, 2))
    model = tz.Zipformer2(tz.Zipformer2Config.from_config(cfg))
    _perturbed(model, 9)
    tree = to_flax(model)
    stacked = jax.tree.map(np.asarray, jz.stack_layer_params(tree))
    assert "layers" in stacked["stack0"] and "layer0" not in stacked["stack1"]
    jm = jz.Zipformer2(jz.Zipformer2Config(**cfg, scan_layers=True))
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, 80)),
                        jnp.asarray([40])))["params"]
    assert jax.tree.structure(shapes) == jax.tree.structure(stacked)
    assert jax.tree.leaves(jax.tree.map(lambda s: s.shape, shapes)) == \
        jax.tree.leaves(jax.tree.map(np.shape, stacked))
    got = flax_to_state_dict(stacked, model)
    want = flax_to_state_dict(tree, model)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    bad = jax.tree.map(np.asarray, stacked)
    leaf = bad["stack0"]["layers"]["norm"]
    leaf["bias"] = leaf["bias"][:1]
    with pytest.raises(ValueError, match="leading layer axis"):
        flax_to_state_dict(bad, model)
