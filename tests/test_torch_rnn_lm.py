"""The port's RNN language model (speech2text_torch/models/rnn_lm.py)
against the JAX package's, with weights converted from the flax tree
(convert.py's LSTM rule): `score` over whole sequences and `score_step`
(log-probs and the (c, h) state of every layer) in f32 at rtol 1e-5 /
atol 1e-6, and in bf16 within 2e-2 of the log-probs (a bf16 ulp of the
logits' scale); the converter raises on an unknown or a missing key."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_tpu.models.rnn_lm import RnnLm as JLm
from speech2text_tpu.models.rnn_lm import RnnLmConfig as JLmConfig
from speech2text_torch.convert import flax_to_state_dict
from speech2text_torch.models.rnn_lm import RnnLm, RnnLmConfig

DIMS = dict(num_symbols=40, embedding_dim=16, hidden_dim=24, num_layers=2)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ATOL = 2e-2


def _pair(dtype="float32", seed=0):
    jm = JLm(JLmConfig(**DIMS, dtype=dtype))
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 3), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    tm = RnnLm(RnnLmConfig(**DIMS, dtype=dtype)).eval()
    tm.load_state_dict(flax_to_state_dict(params, tm))
    return jm, params, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_matches_jax(dtype):
    jm, params, tm = _pair(dtype)
    toks = np.random.default_rng(1).integers(0, 40, (3, 9)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t: jm.apply(
        {"params": p}, t, method=JLm.score))(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm.score(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 8)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


def test_score_step_matches_jax():
    jm, params, tm = _pair(seed=2)
    rng = np.random.default_rng(2)
    step = jax.jit(lambda p, t, s: jm.apply({"params": p}, t, s,
                                            method=JLm.score_step))
    jstate, tstate = jm.init_state(4), tm.init_state(4)
    for _ in range(5):
        tok = rng.integers(0, 40, (4,)).astype(np.int32)
        want, jstate = step(params, jnp.asarray(tok), jstate)
        with torch.no_grad():
            got, tstate = tm.score_step(torch.from_numpy(tok), tstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        for (jc, jh), (tc, th) in zip(jstate, tstate):
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **F32_TOL)
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32_TOL)
    with torch.no_grad():     # the log-probs of the step sum to one
        np.testing.assert_allclose(got.exp().sum(-1).numpy(), 1.0,
                                   rtol=1e-5)


def test_state_dict_layout():
    _, params, tm = _pair()
    sd = tm.state_dict()
    H = DIMS["hidden_dim"]
    cell = params["rnns_1"]["cell"]
    np.testing.assert_array_equal(sd["rnns.weight_ih_l1"][2 * H:3 * H],
                                  cell["ig"]["kernel"].T)
    np.testing.assert_array_equal(sd["rnns.weight_hh_l1"][3 * H:],
                                  cell["ho"]["kernel"].T)
    np.testing.assert_array_equal(sd["rnns.bias_hh_l1"][H:2 * H],
                                  cell["hf"]["bias"])
    assert not sd["rnns.bias_ih_l0"].any()
    assert sd["out.weight"].shape == (DIMS["num_symbols"], H)


def test_converter_raises_on_bad_trees():
    _, params, tm = _pair()
    bad = copy.deepcopy(params)
    bad["rnns_0"]["cell"]["ii"]["bias"] = np.zeros((24,), np.float32)
    with pytest.raises(KeyError, match="ii/bias"):
        flax_to_state_dict(bad, tm)
    bad = copy.deepcopy(params)
    del bad["rnns_1"]["cell"]["hg"]["kernel"]
    with pytest.raises(KeyError, match="hg/kernel"):
        flax_to_state_dict(bad, tm)
    bad = copy.deepcopy(params)
    bad["rnns_2"] = copy.deepcopy(params["rnns_1"])
    with pytest.raises(KeyError, match="weight_ih_l2"):
        flax_to_state_dict(bad, tm)
    bad = copy.deepcopy(params)
    del bad["out"]["bias"]
    with pytest.raises(KeyError, match="out.bias"):
        flax_to_state_dict(bad, tm)
    bad = copy.deepcopy(params)
    bad["rnns_0"]["carry"] = {"c": np.zeros((24,), np.float32)}
    with pytest.raises(KeyError, match="carry"):
        flax_to_state_dict(bad, tm)


def test_seeded_init_is_deterministic():
    a, b = (RnnLm(RnnLmConfig(**DIMS)) for _ in range(2))
    a.init_weights(torch.Generator().manual_seed(4))
    b.init_weights(torch.Generator().manual_seed(4))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                  b.state_dict().values()))
    w = a.rnns.weight_hh_l0[:DIMS["hidden_dim"]]
    np.testing.assert_allclose((w @ w.T).detach().numpy(),
                               np.eye(DIMS["hidden_dim"]), atol=1e-5)
