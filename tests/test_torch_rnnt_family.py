"""The Rnnt and CTC_Hybrid_Rnnt families of the port against the JAX
package's, on the CPU:

- `LstmPredictor` (flax OptimizedLSTMCell arithmetic, weights converted by
  convert.py's `rnns_{i}/cell` rule): the forward on blank ⊕ targets, its
  lengths, and `streaming_step` chained from `init_state` (outputs and the
  (c, h) of every layer) within rtol 1e-5; `to_flax` inverts the
  converter on it.
- `rnnt_loss` on raw (B, T, U+1, V) logits with ragged lengths, in every
  reduction, without and with `clamp` (a bound that clips and one that
  does not): values within rtol 1e-5, logits-gradients within rtol 1e-5
  (atol 1e-6 of the largest).
- Three `RnntTask` and three `CtcHybridRnntTask` steps of a tiny
  Conformer (LSTM predictor, AdamW + Warmup, clipping 5.0) by the port's
  Trainer and by JAX's from the same weights: the logged losses within
  rtol 1e-5 (grad_norm rtol 1e-4), then an evaluation (val_loss, and
  val_rnnt_loss, val_ctc_loss for the hybrid) within rtol 1e-5 and the
  same WER.
- Greedy and beam (W=4, K=4, as rnnt_beam_search.yaml) decoding with the
  LSTM predictor's list-of-(c, h) state on seeded weights: tokens and
  counts equal to JAX's decoders'. The greedy case failed before the
  greedy loop mapped the state (it read `state.ndim` of a list).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_tpu.decoding import RnntBeamDecoding as JBeam
from speech2text_tpu.decoding import RnntGreedyDecoding as JGreedy
from speech2text_tpu.models.joiner import Joiner as JJoiner
from speech2text_tpu.models.joiner import JoinerConfig as JJoinerConfig
from speech2text_tpu.models.predictor import LstmPredictor as JLstm
from speech2text_tpu.models.predictor import LstmPredictorConfig as JCfg
from speech2text_tpu.ops import rnnt as jrnnt
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.decoding import RnntBeamDecoding, RnntGreedyDecoding
from speech2text_torch.losses import Loss, RnntLoss
from speech2text_torch.models.factories import PredictorFactory
from speech2text_torch.models.joiner import Joiner, JoinerConfig
from speech2text_torch.models.predictor import (LstmPredictor,
                                                LstmPredictorConfig)
from speech2text_torch.ops import rnnt as trnnt
from speech2text_torch.tasks.rnnt import CtcHybridRnntTask, RnntTask
from speech2text_torch.train.loop import Trainer

from conformer_task_util import make_corpus, metrics_lines, rnnt_config

PRED = dict(num_symbols=13, output_dim=10, symbol_embedding_dim=8,
            num_lstm_layers=2, lstm_hidden_dim=12)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=1e-6 * (float(np.abs(want).max()) + 1e-12))


@pytest.fixture(scope="module")
def lstm():
    jm = JLstm(JCfg(**PRED))
    targets = jnp.zeros((2, 5), jnp.int32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                              targets)["params"])
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda v: v + 0.1 * rng.standard_normal(
        v.shape).astype(np.float32), params)
    tm = LstmPredictor(LstmPredictorConfig(**PRED)).eval()
    tm.load_state_dict(flax_to_state_dict(params, tm))
    return jm, params, tm


def test_lstm_predictor_forward(lstm):
    jm, params, tm = lstm
    rng = np.random.default_rng(1)
    targets = rng.integers(1, 13, (3, 6)).astype(np.int32)
    lens = np.array([6, 4, 0], np.int32)
    want, want_lens = jm.apply({"params": params}, jnp.asarray(targets),
                               jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = tm(torch.from_numpy(targets).long(),
                           torch.from_numpy(lens))
    assert got.shape == (3, 7, 10) and got.dtype == torch.float32
    _close(got, want)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    # the converter round trip
    back = to_flax(tm)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, params))


def test_lstm_predictor_streaming_step(lstm):
    jm, params, tm = lstm
    tokens = [0, 5, 12, 3]
    jstate = jm.init_state(2)
    tstate = tm.init_state(2)
    assert isinstance(tstate, list) and len(tstate) == 2
    outs = []
    for t in tokens:
        tok = np.array([t, (t + 1) % 13], np.int32)
        jout, jstate = jm.apply({"params": params}, jnp.asarray(tok), jstate,
                                method=JLstm.streaming_step)
        with torch.no_grad():
            tout, tstate = tm.streaming_step(torch.from_numpy(tok).long(),
                                             tstate)
        assert tout.shape == (2, 1, 10)
        _close(tout, jout)
        for (tc, th), (jc, jh) in zip(tstate, jstate):
            _close(tc, jc)
            _close(th, jh)
        outs.append(tout)
    # the forward on blank ⊕ targets chains the same steps
    with torch.no_grad():
        full = tm(torch.tensor([[5, 12, 3], [6, 0, 4]]))
    _close(full[0], torch.cat(outs, dim=1)[0])
    assert isinstance(PredictorFactory({"model": "Lstm", "config": PRED}),
                      LstmPredictor)


# ------------------------------------------------------------------ loss
def _lattice_inputs(seed, B=4, T=9, U=5, V=7):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((B, T, U + 1, V))).astype(np.float32)
    targets = rng.integers(1, V, (B, U)).astype(np.int32)
    t_lens = np.array([T, T - 2, 4, 1][:B], np.int32)
    u_lens = np.array([U, 3, 0, 1][:B], np.int32)
    return logits, targets, t_lens, u_lens


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("clamp", [-1.0, 0.05, 10.0])
def test_rnnt_loss_matches_jax(reduction, clamp):
    logits, targets, t_lens, u_lens = _lattice_inputs(
        {"mean": 0, "sum": 1, "none": 2}[reduction])
    args = (jnp.asarray(targets), jnp.asarray(t_lens), jnp.asarray(u_lens))
    g = np.random.default_rng(9).standard_normal(4).astype(np.float32)

    def jloss(lg):
        return jrnnt.rnnt_loss(lg, *args, reduction=reduction, clamp=clamp)

    want, vjp = jax.vjp(jloss, jnp.asarray(logits))
    cot = jnp.asarray(g) if reduction == "none" else jnp.ones(())
    (want_grad,) = vjp(cot)
    lt = torch.tensor(logits, requires_grad=True)
    got = trnnt.rnnt_loss(lt, torch.from_numpy(targets),
                          torch.from_numpy(t_lens), torch.from_numpy(u_lens),
                          reduction=reduction, clamp=clamp)
    _close(got.detach(), want)
    got.backward(torch.tensor(np.asarray(cot)))
    _close(lt.grad, want_grad)
    if clamp == 0.05:
        assert float(lt.grad.abs().max()) <= 0.05 * (
            float(np.abs(g).max()) if reduction == "none" else 1.0) + 1e-7
    # without a gradient the clamp changes nothing
    with torch.no_grad():
        plain = trnnt.rnnt_loss(torch.from_numpy(logits),
                                torch.from_numpy(targets),
                                torch.from_numpy(t_lens),
                                torch.from_numpy(u_lens),
                                reduction=reduction, clamp=clamp)
    torch.testing.assert_close(plain, got.detach(), rtol=0, atol=0)


def test_rnnt_loss_factory():
    loss = Loss({"model": "Rnnt", "config": {"reduction": "sum",
                                             "clamp": 2.0,
                                             "blank_label": 0}})
    assert isinstance(loss, RnntLoss) and loss.config.clamp == 2.0
    logits, targets, t_lens, u_lens = _lattice_inputs(3)
    got = loss({"logits": torch.from_numpy(logits),
                "label": torch.from_numpy(targets),
                "logits_length": torch.from_numpy(t_lens),
                "label_length": torch.from_numpy(u_lens)})
    want = jrnnt.rnnt_loss(jnp.asarray(logits), jnp.asarray(targets),
                           jnp.asarray(t_lens), jnp.asarray(u_lens),
                           reduction="sum", clamp=2.0)
    _close(got, want)


# --------------------------------------------------------------- tasks
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


@pytest.mark.parametrize("hybrid", [False, True])
def test_trainer_matches_jax_trainer(corpus, tmp_path, hybrid):
    import jax.numpy as jnp
    from speech2text_tpu.parallel.mesh import MeshConfig, make_mesh
    from speech2text_tpu.tasks.rnnt import CtcHybridRnntTask as JHybrid
    from speech2text_tpu.tasks.rnnt import RnntTask as JRnnt
    from speech2text_tpu.train.loop import Trainer as JTrainer

    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    tcfg = rnnt_config(corpus, tdir, hybrid)
    jcfg = rnnt_config(corpus, jdir, hybrid)
    task = (CtcHybridRnntTask if hybrid else RnntTask)(tcfg)
    trainer = Trainer(task, tcfg, tdir, seed=7, device="cpu")
    assert trainer.clip == 5.0
    start = jax.tree.map(jnp.asarray, to_flax(task.model))
    got_eval = trainer.fit(max_steps=3)
    trainer.close()

    jtask = (JHybrid if hybrid else JRnnt)(jcfg)
    mesh = make_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    jtrainer = JTrainer(jtask, jcfg, jdir, seed=7, mesh=mesh)
    want_eval = jtrainer.fit(finetune_params=start, max_steps=3)

    got, want = metrics_lines(tdir), metrics_lines(jdir)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    keys = ["loss", "train_loss"] + (["rnnt_loss", "ctc_loss"] if hybrid
                                     else [])
    for g, w in zip(got, want):
        assert set(w) <= set(g)
        np.testing.assert_allclose([g[k] for k in keys],
                                   [w[k] for k in keys], rtol=1e-5,
                                   err_msg=f"step {g['step']}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    assert got[2]["loss"] != got[0]["loss"]
    want_keys = {"val_loss", "wer"} | ({"val_rnnt_loss", "val_ctc_loss"}
                                       if hybrid else set())
    assert set(got_eval) == set(want_eval) == want_keys
    for k in want_keys - {"wer"}:
        assert got_eval[k] == pytest.approx(want_eval[k], rel=1e-5), k
    assert got_eval["wer"] == want_eval["wer"]


def test_task_checks_prune_range(corpus, tmp_path):
    cfg = rnnt_config(corpus, str(tmp_path / "x"))
    cfg["joiner"] = dict(cfg["joiner"], prune_range=3)
    with pytest.raises(ValueError, match="prune_range"):
        RnntTask(cfg)
    cfg = rnnt_config(corpus, str(tmp_path / "y"), hybrid=True)
    cfg["joiner"] = dict(cfg["joiner"], prune_range=4)
    with pytest.raises(ValueError, match="prune_range"):
        CtcHybridRnntTask(cfg)


# ------------------------------------------------------------ decoding
V = 13
ENC = 10


@pytest.fixture(scope="module")
def decoder_parts(lstm):
    jm, pparams, tm = lstm
    jcfg = JJoinerConfig(input_dim=ENC, output_dim=V, inner_dim=16,
                         prune_range=-1)
    jj = JJoiner(jcfg)
    jparams = jax.tree.map(np.asarray, jj.init(
        jax.random.PRNGKey(1), jnp.zeros((1, ENC)), jnp.zeros((1, ENC)),
        method=JJoiner.streaming_step)["params"])
    tj = Joiner(JoinerConfig(input_dim=ENC, output_dim=V, inner_dim=16,
                             prune_range=-1)).eval()
    tj.load_state_dict(flax_to_state_dict(jparams, tj))
    params = {"predictor": pparams, "joiner": jparams}

    def pred_step(p, tok, state):
        return jm.apply({"params": p["predictor"]}, tok, state,
                        method=JLstm.streaming_step)

    def join_step(p, enc, pr):
        return jj.apply({"params": p["joiner"]}, enc, pr,
                        method=JJoiner.streaming_step)

    return params, pred_step, jm.init_state, join_step, tm, tj


def _enc(seed, B=4, T=11):
    rng = np.random.default_rng(seed)
    enc = (3.0 * rng.standard_normal((B, T, ENC))).astype(np.float32)
    return enc, np.array([T, 1, 0, 7][:B], np.int32)


@pytest.mark.parametrize("beam", [False, True])
def test_decoding_with_lstm_state_matches_jax(decoder_parts, beam):
    params, pred_step, pred_init, join_step, tm, tj = decoder_parts
    if beam:
        jdec = JBeam(None, pred_step, pred_init, join_step, beam_size=4,
                     cutoff_top_k=4, max_tokens=20)
        dec = RnntBeamDecoding(tm.streaming_step, tm.init_state,
                               tj.streaming_step, beam_size=4,
                               cutoff_top_k=4, max_tokens=20)
    else:
        jdec = JGreedy(None, pred_step, pred_init, join_step,
                       max_token_step=1, max_tokens=20)
        dec = RnntGreedyDecoding(tm.streaming_step, tm.init_state,
                                 tj.streaming_step, max_token_step=1,
                                 max_tokens=20)
    total = 0
    for seed in range(3):
        enc, lens = _enc(seed)
        got_tok, got_cnt = dec.decode(torch.from_numpy(enc),
                                      torch.from_numpy(lens))
        want_tok, want_cnt = jdec._decode_jit(params, jnp.asarray(enc),
                                              jnp.asarray(lens))
        np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
        np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
        total += int(got_cnt.sum())
    assert total > 0
