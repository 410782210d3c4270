"""Int8 decoding of the port (speech2text_torch/export.py's quantization,
speech2text_torch/quant.py, the `metric.int8` branch of the transducer
task and RnntServer) against the JAX package's (speech2text_tpu/export.py,
quant.py, tasks/rnnt.py) on the CPU, at tests/test_quant_exec.py's dims:

- quantize_params on a tiny RnntModel with either predictor: the same
  keys, int8 payloads equal, scales and f32 leaves bitwise; an artifact
  written by either package loads in the other;
- quant_dense within rtol 1e-6 (its int32 product exact), at shapes the
  CUDA product needs padded;
- the int8 predictor steps (stateless and LSTM) and joiner step within
  1e-5;
- int8 greedy and beam tokens equal JAX's on the same encoder output;
- the task's and RnntServer's `metric.int8` surfaces, and JAX's session
  built once (a reference caveat) against the port's, which follows the
  weights.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_torch import export as texport
from speech2text_torch import quant as tquant
from speech2text_torch.convert import to_flax
from speech2text_torch.decoding import ids_to_texts
from speech2text_torch.tasks.rnnt import RnntModel

V, D, E = 48, 64, 96
PREDICTORS = {
    "Stateless": {"num_symbols": V, "output_dim": D,
                  "symbol_embedding_dim": E, "context_size": 3},
    "Lstm": {"num_symbols": V, "output_dim": D, "symbol_embedding_dim": E,
             "num_lstm_layers": 2, "lstm_hidden_dim": 40},
}
ENCODER = {"model": "Conformer", "config": {
    "feats_dim": 80, "subsampling_rate": 4, "input_dim": D, "num_heads": 2,
    "ffn_dim": 64, "num_layers": 1, "output_dim": D, "dropout": 0.0}}


def model_config(predictor, use_out_project=True):
    return {"encoder": ENCODER,
            "decoder": {"model": "Identity", "config": {"dummy": -1}},
            "predictor": {"model": predictor,
                          "config": dict(PREDICTORS[predictor])},
            "joiner": {"input_dim": D, "output_dim": V, "inner_dim": 32,
                       "prune_range": 3,
                       "use_out_project": use_out_project}}


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, (pred, out_proj) in enumerate((("Stateless", True),
                                          ("Lstm", True),
                                          ("Stateless", False))):
        m = RnntModel.from_config(model_config(pred, out_proj))
        m.init_weights(torch.Generator().manual_seed(i))
        out[(pred, out_proj)] = m.eval()
    return out


class Tok:
    def decode(self, ids):
        return " ".join(str(int(i)) for i in np.asarray(ids).reshape(-1))


def assert_same_flat(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("min_size", [1, 1024])
@pytest.mark.parametrize("predictor", ["Stateless", "Lstm"])
def test_quantize_params_equals_jax(models, predictor, min_size):
    from speech2text_tpu.export import quantize_params
    tree = to_flax(models[(predictor, True)])
    got = texport.quantize_params(tree, min_size=min_size)
    assert_same_flat(got, quantize_params(tree, min_size=min_size))
    assert any(v.dtype == np.int8 for v in got.values())
    assert any(k.endswith(".fp32") for k in got)


def test_artifact_loads_across_packages(models, tmp_path):
    from speech2text_tpu import export as jexport
    tree = to_flax(models[("Lstm", True)])
    tpath, jpath = str(tmp_path / "t.int8.npz"), str(tmp_path / "j.int8.npz")
    texport.save_quantized(tree, tpath, min_size=64)
    jexport.save_quantized(tree, jpath, min_size=64)
    assert_same_flat(dict(np.load(tpath)), dict(np.load(jpath)))
    for path in (tpath, jpath):
        t_tree = texport.load_quantized(path)
        j_tree = jexport.load_quantized(path)
        flat_t = dict(tquant_flat(t_tree))
        flat_j = dict(tquant_flat(j_tree))
        assert_same_flat(flat_t, flat_j)
    # the artifact and the live tree give the same QTensors
    live = tquant.flat_qtree(tree, min_size=64)
    loaded = tquant.flat_qtree(dict(np.load(jpath)))
    assert sorted(live) == sorted(loaded)
    for k, q in live.items():
        assert torch.equal(q.q, loaded[k].q)
        assert (q.scale is None) == (loaded[k].scale is None)
        if q.scale is not None:
            assert torch.equal(q.scale, loaded[k].scale)


def tquant_flat(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from tquant_flat(v, p)
        else:
            yield p, np.asarray(v)


@pytest.mark.parametrize("rows,k,n,dtype", [
    (3, 96, 64, "float32"), (20, 50, 30, "float32"),
    (5, 64, 48, "bfloat16")])
def test_quant_dense_matches_jax(rows, k, n, dtype):
    from speech2text_tpu.quant import flat_qtree, quant_dense
    rng = np.random.default_rng(rows + k)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    x[0] = 0.0                                    # the 1e-12 floor
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    tree = {"m": {"kernel": w, "bias": b}}
    jq = flat_qtree(tree, min_size=1)
    tq = tquant.flat_qtree(tree, min_size=1)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jax.jit(lambda x, b: quant_dense(
        x, jq["m/kernel"], b))(jx, jnp.asarray(b)), np.float32)
    got = tquant.quant_dense(tx, tq["m/kernel"], torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (rows, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the padded int32 product is the exact integer product
    xq = torch.randint(-127, 128, (rows, k), dtype=torch.int8)
    exact = xq.long() @ tq["m/kernel"].q.long()
    assert torch.equal(tquant.int_mm(xq, tq["m/kernel"]).long(), exact)


def _steps(tree, predictor, out_proj, min_size):
    from speech2text_tpu import quant as jquant
    jqt = jquant.flat_qtree(tree, min_size=min_size)
    cfg = PREDICTORS[predictor]
    j_pred = jquant.build_int8_predictor(jqt, predictor, cfg)
    j_join = jquant.Int8Joiner(jqt, use_out_project=out_proj)
    return j_pred, j_join


@pytest.mark.parametrize("predictor", ["Stateless", "Lstm"])
def test_int8_predictor_step_matches_jax(models, predictor):
    model = models[(predictor, True)]
    tree = to_flax(model)
    j_pred, _ = _steps(tree, predictor, True, 1)
    t_pred, _ = tquant._int8_steps(tree, model.predictor.config,
                                   model.joiner.config, 1, "cpu")
    tokens = np.array([[3, 17, 0], [5, 5, 47], [9, 1, 2]], np.int64)
    j_state = j_pred.init_state(3)
    t_state = t_pred.init_state(3)
    j_step = jax.jit(lambda tok, st: j_pred.step(None, tok, st))
    for step in range(tokens.shape[1]):
        j_out, j_state = j_step(jnp.asarray(tokens[:, step]), j_state)
        t_out, t_state = t_pred.step(torch.from_numpy(tokens[:, step]),
                                     t_state)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                                   rtol=1e-5, atol=1e-5)
    j_leaves = [np.asarray(x) for x in jax_leaves(j_state)]
    t_leaves = [x.numpy() for x in jax_leaves(t_state)]
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def jax_leaves(state):
    if isinstance(state, (list, tuple)):
        return [x for s in state for x in jax_leaves(s)]
    return [state]


@pytest.mark.parametrize("out_proj", [True, False])
def test_int8_joiner_step_matches_jax(models, out_proj):
    model = models[("Stateless", out_proj)]
    tree = to_flax(model)
    _, j_join = _steps(tree, "Stateless", out_proj, 1)
    _, t_join = tquant._int8_steps(tree, model.predictor.config,
                                   model.joiner.config, 1, "cpu")
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((3, D)).astype(np.float32)
    pre = rng.standard_normal((3, D)).astype(np.float32)
    want = np.asarray(jax.jit(lambda e, p: j_join.step(None, e, p))(
        jnp.asarray(enc), jnp.asarray(pre)))
    got = t_join.step(torch.from_numpy(enc), torch.from_numpy(pre))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def encoder_output(seed, B=3, T=14):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, T, D)).astype(np.float32)
    return enc, np.array([T, T - 5, 9][:B], np.int32)


@pytest.mark.parametrize("method", ["greedy", "beam"])
@pytest.mark.parametrize("predictor", ["Stateless", "Lstm"])
def test_int8_tokens_match_jax(models, predictor, method):
    from speech2text_tpu import quant as jquant
    model = models[(predictor, True)]
    tree = to_flax(model)
    cfg = PREDICTORS[predictor]
    joiner = {"use_out_project": True}
    enc, lens = encoder_output(3)
    if method == "greedy":
        jdec = jquant.Int8RnntGreedyDecoding(
            Tok(), tree, cfg, joiner, max_token_step=2, max_tokens=16,
            min_size=64, predictor_model=predictor)
        tdec = tquant.Int8RnntGreedyDecoding(
            tree, model.predictor.config, model.joiner.config,
            max_token_step=2, max_tokens=16, min_size=64)
    else:
        jdec = jquant.Int8RnntBeamDecoding(
            Tok(), tree, cfg, joiner, beam_size=3, cutoff_top_k=3,
            max_tokens=16, min_size=64, predictor_model=predictor)
        tdec = tquant.Int8RnntBeamDecoding(
            tree, model.predictor.config, model.joiner.config,
            beam_size=3, cutoff_top_k=3, max_tokens=16, min_size=64)
    want = jdec.decode(None, jnp.asarray(enc), jnp.asarray(lens))
    tokens, counts = tdec.decode(torch.from_numpy(enc),
                                 torch.from_numpy(lens))
    got = ids_to_texts(tokens.numpy(), counts.numpy(), Tok())
    assert sum(len(t.split()) for t in got) > 0
    assert got == want


def task_config(int8=True, method="rnnt_greedy_search"):
    cfg = {"task": {"type": "Pruned_Rnnt", "name": "tiny",
                    "export_path": "/nonexistent"},
           "tokenizer": {"type": "char", "config": {}},
           "dataset": {"feat_type": "lhotes_fbank",
                       "feat_config": {"num_mel_bins": 80},
                       "data_aug_config": {}},
           "metric": {"decode_method": method, "int8": int8,
                      "int8_min_size": 64, "max_token_step": 1},
           "loss": {"model": "Pruned_Rnnt", "config": {}},
           **copy.deepcopy(model_config("Stateless"))}
    cfg["predictor"]["config"]["num_symbols"] = 31
    cfg["joiner"]["output_dim"] = 31
    return cfg


def _jax_task(cfg):
    from speech2text_tpu.tasks import TaskFactory
    return TaskFactory("Pruned_Rnnt")(cfg)


def _params_of(model):
    return jax.tree.map(jnp.asarray, to_flax(model))


@pytest.mark.parametrize("method", ["rnnt_greedy_search",
                                    "rnnt_beam_search"])
def test_task_int8_hyps_match_jax(method):
    from speech2text_torch.tasks.rnnt import Int8Decoding, PrunedRnntTask
    cfg = task_config(method=method)
    task = PrunedRnntTask(cfg)
    task.model.init_weights(torch.Generator().manual_seed(7))
    task.eval()
    assert isinstance(task.decode_session, Int8Decoding)
    jtask = _jax_task(cfg)
    enc, lens = encoder_output(5)
    out = {"enc": torch.from_numpy(enc), "enc_lens": torch.from_numpy(lens)}
    got = task.eval_hyps(out)
    want = jtask.eval_hyps({"enc": jnp.asarray(enc),
                            "enc_lens": jnp.asarray(lens)},
                           _params_of(task.model))
    assert sum(len(h) for h in got) > 0
    assert got == want


def test_server_int8_matches_task(tmp_path):
    from speech2text_torch.serve import RnntServer
    from speech2text_torch.tasks.rnnt import Int8Decoding, PrunedRnntTask
    train_cfg = task_config(int8=False)
    train_cfg["metric"] = {}
    infer_cfg = {"task": {"type": "pruned_rnnt_inference",
                          "train_config": train_cfg},
                 "testset": {"config": {"batch_size": 2}},
                 "decoding": {"type": "rnnt_greedy_search",
                              "config": {"int8": True,
                                         "int8_min_size": 64}}}
    server = RnntServer(infer_cfg, device="cpu", seed=3)
    assert isinstance(server.decoder, Int8Decoding)
    rng = np.random.default_rng(1)
    pcm = (rng.standard_normal((2, 12000)) * 3000).astype(np.int16)
    lens = np.array([12000, 9000], np.int32)
    tokens, counts = server.transcribe(pcm, lens)
    cfg = task_config()
    task = PrunedRnntTask(cfg)
    task.model.load_state_dict(server.model.state_dict())
    task.eval()
    feats, feat_lens = server.featurize(pcm, lens)
    enc, enc_lens = server.encode(feats, feat_lens)
    want = task.eval_hyps({"enc": enc, "enc_lens": enc_lens})
    assert ids_to_texts(tokens.numpy(), counts.numpy(),
                        task.tokenizer) == want


def test_int8_session_follows_the_weights():
    """JAX builds its int8 session at the first evaluation and keeps it
    (tasks/rnnt.py:123, 219-240), so a later evaluation decodes with the
    first weights; the port quantizes the weights it decodes with."""
    from speech2text_torch.tasks.rnnt import PrunedRnntTask
    cfg = task_config()
    task = PrunedRnntTask(cfg).eval()
    jtask = _jax_task(cfg)
    enc, lens = encoder_output(6)
    t_out = {"enc": torch.from_numpy(enc), "enc_lens": torch.from_numpy(lens)}
    j_out = {"enc": jnp.asarray(enc), "enc_lens": jnp.asarray(lens)}
    hyps = []
    for seed in (8, 9):
        task.model.init_weights(torch.Generator().manual_seed(seed))
        hyps.append((task.eval_hyps(t_out),
                     jtask.eval_hyps(j_out, _params_of(task.model))))
    (port_a, jax_a), (port_b, jax_b) = hyps
    assert port_a == jax_a and port_b != port_a
    assert jax_b == jax_a                 # JAX's stale session
    fresh = _jax_task(cfg).eval_hyps(j_out, _params_of(task.model))
    assert port_b == fresh
