"""ScaledAdam + Eden of the port (speech2text_torch/optim) against the
optax version of the JAX package: a 14-step trajectory on a synthetic tree
(a scalar leaf, leaves of one shape, leaves of distinct shapes) that
crosses the size-update boundaries, the end of the no-clip window (step
10), a step with an infinite grad and a clipped step. Tolerance: rtol
1e-5, atol 2e-6, as tests/test_scaled_adam_oracle.py holds the optax
version to icefall's.

Adam and AdamW with the Warmup schedule and global-norm clipping against
the JAX package's OptimSetup chained after optax.clip_by_global_norm,
as its train loop chains them: 5 updates, each clipped, within rtol
1e-6; the four other schedules against JAX's over 10 steps, within
rtol 1e-6 plus 1e-6 of the base lr (JAX's f32 rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech2text_tpu.optim import schedules as jsched
from speech2text_tpu.optim.scaled_adam import scaled_adam
from speech2text_tpu.optim.setup import OptimSetup as JOptimSetup
from speech2text_torch.optim import (Adam, EdenSchedule, OptimSetup,
                                     ScaledAdam, clip_by_global_norm_)
from speech2text_torch.optim.setup import build_schedule

SHAPES = {"a": (4, 3), "b": (4, 3), "c": (6,), "s": (), "w": (2, 3, 4),
          "x": (4, 3), "z": (1,)}
STEPS = 14
INF_STEP, BIG_STEP = 11, 12


def _grads(rng, step):
    g = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in SHAPES.items()}
    if step == INF_STEP:
        g["w"] = g["w"].copy()
        g["w"][0, 1, 2] = np.inf
    if step == BIG_STEP:
        g = {k: v * 50.0 for k, v in g.items()}
    return g


def test_trajectory_matches_optax():
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    init["s"] = np.float32(12.0)          # beyond scalar_max: clamped
    grads = [_grads(rng, i) for i in range(STEPS)]
    sched_kw = dict(lr=0.045, lr_batches=7000.0)

    tx = scaled_adam(jsched.EdenSchedule(**sched_kw))
    params = jax.tree.map(jnp.asarray, init)
    state = tx.init(params)
    want = []
    step_fn = jax.jit(lambda p, s, g: tx.update(g, s, p))
    for g in grads:
        upd, state = step_fn(params, state, jax.tree.map(jnp.asarray, g))
        params = optax.apply_updates(params, upd)
        want.append(jax.tree.map(np.asarray, params))

    # another leaf order than jax.tree's: the result must not depend on it
    order = ["w", "z", "b", "s", "a", "x", "c"]
    tp = {k: torch.tensor(init[k]).requires_grad_() for k in order}
    opt = ScaledAdam([tp[k] for k in order], EdenSchedule(**sched_kw))
    for i, g in enumerate(grads):
        for k in order:
            tp[k].grad = torch.tensor(g[k])
        opt.step()
        for k in order:
            np.testing.assert_allclose(
                tp[k].detach().numpy(), want[i][k], rtol=1e-5, atol=2e-6,
                err_msg=f"step {i} param {k}")
    assert opt.step_count == STEPS
    # the infinite norm stayed out of the median buffer
    assert torch.isfinite(opt.norm_buffer).all()
    np.testing.assert_allclose(opt.norm_buffer[:STEPS].numpy(),
                               np.asarray(state.norm_buffer[:STEPS]),
                               rtol=1e-5)


def test_eden_values():
    j = jsched.EdenSchedule(0.045, lr_batches=7000.0, lr_epochs=6.0,
                            steps_per_epoch=1000, warmup_batches=500.0)
    t = EdenSchedule(0.045, lr_batches=7000.0, lr_epochs=6.0,
                     steps_per_epoch=1000, warmup_batches=500.0)
    for s in (0, 1, 10, 250, 499, 500, 501, 7000, 25000, 10 ** 6):
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6,
                                   err_msg=f"step {s}")


def _setup(**over):
    cfg = {"optimizer": {"type": "ScaledAdam",
                         "config": {"lr": 0.045, "clipping_scale": 2.0}},
           "lr_scheduler": {"type": "Eden", "config": {"lr_batches": 7000}}}
    for k, v in over.items():
        cfg[k] = v
    return cfg


def test_optim_setup():
    p = torch.zeros(3, requires_grad=True)
    opt, sched = OptimSetup(_setup(), [p])
    assert isinstance(opt, ScaledAdam) and opt.lr is sched
    np.testing.assert_allclose(sched(100), float(jsched.EdenSchedule(
        0.045, lr_batches=7000)(100)), rtol=1e-6)


SEPARATE = {"apply": True, "config": {"encoder_lr": 1e-3}}


@pytest.mark.parametrize("over,exc", [
    ({"optimizer": {"type": "SGD", "config": {}}}, ValueError),
    ({"lr_scheduler": {"type": "Step", "config": {}}}, ValueError),
    # per-module learning rates group the parameters by their names
    ({"optimizer": {"type": "AdamW", "config": {}},
      "seperate_lr": SEPARATE}, ValueError),
    ({"seperate_lr": SEPARATE}, ValueError)])
def test_optim_setup_rejects_the_unported(over, exc):
    with pytest.raises(exc):
        OptimSetup(_setup(**over), [torch.zeros(3, requires_grad=True)])


@pytest.mark.parametrize("kind", ["AdamW", "Adam"])
def test_adam_warmup_clipping_matches_optax(kind):
    cfg = {"optimizer": {"type": kind, "config": {"lr": 0.05}},
           "lr_scheduler": {"type": "Warmup",
                            "config": {"warmup_steps": 3}}}
    rng = np.random.default_rng(1)
    shapes = {k: s for k, s in SHAPES.items() if k != "s"}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    tx, jsched_fn = JOptimSetup(cfg)
    tx = optax.chain(optax.clip_by_global_norm(5.0), tx)
    params = jax.tree.map(jnp.asarray, init)
    state = tx.init(params)
    order = sorted(shapes, reverse=True)
    tp = {k: torch.tensor(init[k]).requires_grad_() for k in order}
    opt, sched = OptimSetup(cfg, [tp[k] for k in order])
    assert isinstance(opt, Adam) and opt.weight_decay == (
        1e-2 if kind == "AdamW" else 0.0)
    for i, g in enumerate(grads):
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, upd)
        for k in order:
            tp[k].grad = torch.tensor(g[k])
        gs = [tp[k].grad for k in order]
        norm = torch.nn.utils.get_total_norm(gs)
        assert float(norm) > 5.0                    # the clip is active
        clip_by_global_norm_(gs, 5.0, norm)
        opt.step()
        for k in order:
            np.testing.assert_allclose(
                tp[k].detach().numpy(), np.asarray(params[k]), rtol=1e-6,
                atol=1e-7, err_msg=f"update {i} param {k}")
        assert sched(i) == pytest.approx(float(jsched_fn(i)), rel=1e-6)
    assert opt.count == 5
    # the state round-trips bitwise
    again, _ = OptimSetup(cfg, [tp[k] for k in order])
    again.load_state_dict(opt.state_dict())
    assert again.count == 5 and all(
        torch.equal(a, b) for a, b in zip(again.mu + again.nu,
                                          opt.mu + opt.nu))


@pytest.mark.parametrize("kind,c", [
    ("Warmup", {"warmup_steps": 4}),
    ("Cosine_Warmup", {"warmup_steps": 3, "total_steps": 9,
                       "min_lr": 1e-4}),
    ("Cosine_Annealing", {"T_max": 8, "eta_min": 1e-5}),
    ("Noam_Hold_Annealing", {"warmup_steps": 2, "hold_steps": 3,
                             "total_steps": 9, "decay_rate": 0.7})])
def test_schedules_match_jax(kind, c):
    # JAX computes in f32, the port in float64: within f32 rounding of
    # the base lr (the cosine's 1 + cos(π·p) cancels near its end)
    from speech2text_tpu.optim.setup import _build_schedule
    lr = 0.002
    want = _build_schedule(kind, lr, c)
    got = build_schedule(kind, lr, c)
    for step in range(10):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-6 * lr, err_msg=f"step {step}")


TREE = {"encoder": {"a": (4, 3), "b": (4, 3), "s": ()},
        "joiner": {"w": (3, 5), "b": (5,)},
        "predictor": {"e": (6, 2), "c": (4, 3)}}


@pytest.mark.parametrize("kind", ["ScaledAdam", "AdamW"])
def test_seperate_lr_matches_multi_transform(kind):
    """`seperate_lr` (the heldout recipe's joiner_lr / predictor_lr)
    against JAX's OptimSetup (optax.multi_transform keyed on the top-level
    module): 12 steps, a clipped one among them, every parameter within
    rtol 1e-5, atol 2e-6; each group's schedule has its own base lr."""
    cfg = _setup(seperate_lr={"apply": True, "config": {
        "joiner_lr": 0.02, "predictor_lr": 0.01}})
    if kind == "AdamW":
        cfg["optimizer"] = {"type": "AdamW", "config": {"lr": 1e-3}}
        cfg["lr_scheduler"] = {"type": "Warmup",
                               "config": {"warmup_steps": 5}}
    else:
        cfg["lr_scheduler"]["config"].update(lr_epochs=3.5,
                                             steps_per_epoch=10)
    rng = np.random.default_rng(4)
    init = {m: {k: rng.standard_normal(s).astype(np.float32)
                for k, s in leaves.items()} for m, leaves in TREE.items()}
    grads = [{m: {k: (rng.standard_normal(s) * (30.0 if i == 11 else 0.1))
                  .astype(np.float32) for k, s in leaves.items()}
              for m, leaves in TREE.items()} for i in range(12)]

    tx, _ = JOptimSetup(cfg)
    params = jax.tree.map(jnp.asarray, init)
    state = tx.init(params)
    step_fn = jax.jit(lambda p, s, g: tx.update(g, s, p))
    for g in grads:
        upd, state = step_fn(params, state, jax.tree.map(jnp.asarray, g))
        params = optax.apply_updates(params, upd)

    named = {f"{m}.{k}": torch.tensor(v).requires_grad_()
             for m, leaves in init.items() for k, v in leaves.items()}
    opt, sched = OptimSetup(cfg, named.items())
    assert sorted(opt.optimizers) == ["default", "joiner", "predictor"]
    assert opt.optimizers["joiner"].lr(100) != sched(100)
    for g in grads:
        for name, p in named.items():
            m, k = name.split(".")
            p.grad = torch.tensor(g[m][k])
        opt.step()
    for name, p in named.items():
        m, k = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[m][k]), rtol=1e-5,
                                   atol=2e-6, err_msg=name)
    # the state round-trips through a checkpoint's dict
    again, _ = OptimSetup(cfg, named.items())
    again.load_state_dict(opt.state_dict())
    assert again.state_dict().keys() == opt.state_dict().keys()
