"""The port's inference entry (speech2text_torch/inference.py) against the
repo's inference.py, and simulated streaming in the serving path.

- A tiny pruned RNN-T (`__graft_entry__._tiny_config` dims) and a tiny
  fusion LM, saved for the same steps with the same metrics twice: as the
  JAX package's orbax checkpoints and as port checkpoints. Both entry
  points decode the synthetic corpus's eval set on the CPU (JAX on one
  device: its mesh would otherwise round test batches up to conftest's 8
  virtual devices); their `test_report.txt` files are equal byte for byte
  for greedy, beam, beam + LM, `encoder_streaming`, averaged (`chkpt_aver`),
  named (`chkpt_name`) and latest checkpoints.
- `RnntServer` with `streaming.is_encoder_streaming: true`: encoder output
  (rtol/atol 1e-4) and tokens (identical) equal JAX's chunk-masked encoder
  and greedy decode of the same weights and audio.
- Unported options raise; the entry raises with no card and no
  `--device cpu`, before it writes anything.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from __graft_entry__ import _build_model, _tiny_config
from speech2text_torch import inference as tinf
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.data.manifest import iter_text, load_manifest
from speech2text_torch.data.spm import train_unigram
from speech2text_torch.data.tokenizer import TokenizerSetup
from speech2text_torch.models.rnn_lm import RnnLm, RnnLmConfig
from speech2text_torch.serve import RnntServer
from speech2text_torch.tasks.rnnt import Int8Decoding, PrunedRnntTask, RnntModel
from speech2text_torch.tools.synth_corpus import write_corpus
from speech2text_torch.train import checkpoint as tckpt

LM_DIMS = {"embedding_dim": 16, "hidden_dim": 24, "num_layers": 2}
STEPS = {1: 0.5, 2: 0.3, 3: 0.4}          # step → wer
LM_STEPS = {1: 0.2, 2: 0.6}               # step → acc
REPORT_BLOCKS = 8                         # eval utterances


def _train_config(corpus, spm_model, vocab, workdir):
    cfg = _tiny_config(vocab)
    cfg["encoder"]["config"].update(chunk_size=[-1],
                                    left_context_frames=[-1])
    cfg.update({
        "task": {"type": "Pruned_Rnnt", "name": "tiny",
                 "export_path": workdir},
        "tokenizer": {"type": "subword", "config": {"spm_model": spm_model}},
        "dataset": {"train_data": corpus["train_data"],
                    "eval_data": corpus["eval_data"],
                    "dur_min_filter": 0.1, "dur_max_filter": 60.0,
                    "batch_size": 4, "use_bucket_sampler": True,
                    "bucket_sampler_config": {"num_bucket": 1},
                    "feat_type": "lhotes_fbank",
                    "feat_config": {"num_mel_bins": 80, "snip_edges": True}},
        "loss": {"model": "Pruned_Rnnt", "simple_loss_scale": 0.5,
                 "pruned_loss_scale": 0.5,
                 "config": {"termination_symbol": 0, "reduction": "mean"},
                 "enable_ctc": False},
        "metric": {"decode_method": "rnnt_greedy_search",
                   "max_token_step": 1},
        "callbacks": {"global_cmvn": {"apply": False}},
    })
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpus, the training and inference YAMLs, and the checkpoints
    of both packages: {"root", "infer", "ckpt": {"jax", "torch"},
    "lm": {"jax", "torch"}, "train_config", "params"}."""
    from speech2text_tpu.models.rnn_lm import RnnLm as JLm
    from speech2text_tpu.models.rnn_lm import RnnLmConfig as JLmConfig
    from speech2text_tpu.train.checkpoint import CheckpointManager as JCkpt
    root = tmp_path_factory.mktemp("infer")
    corpus = write_corpus(str(root / "corpus"), seed=13, n_train=12,
                          n_eval=REPORT_BLOCKS, n_noise=1,
                          train_seconds=(1.0, 2.0), eval_seconds=(1.0, 3.0))
    spm = train_unigram(iter_text(load_manifest(corpus["train_data"])),
                        vocab_size=48)
    spm_model = str(root / "tokenizer.model")
    spm.save(spm_model)
    vocab = len(TokenizerSetup({"type": "subword",
                                "config": {"spm_model": spm_model}}))
    train_cfg = _train_config(corpus, spm_model, vocab, str(root / "tasks"))
    train_path = root / "train.yaml"
    train_path.write_text(yaml.safe_dump(train_cfg))
    infer = {"task": {"type": "pruned_rnnt_inference",
                      "export_path": str(root / "out"),
                      "train_config": str(train_path),
                      "chkpt_aver": False, "aver_best_k": 2,
                      "descending": False, "chkpt_name": None},
             "testset": {"test_data": corpus["eval_data"],
                         "config": {"batch_size": 4,
                                    "feat_type": "lhotes_fbank",
                                    "feat_config": {"num_mel_bins": 80}}},
             "decoding": {"type": "rnnt_greedy_search",
                          "config": {"max_token_step": 1}},
             "streaming": {"is_encoder_streaming": False}}
    infer_path = root / "infer.yaml"
    infer_path.write_text(yaml.safe_dump(infer))

    ckpt = {"jax": str(root / "ckpt_jax"), "torch": str(root / "ckpt_torch")}
    jmgr, tmgr = JCkpt(ckpt["jax"]), tckpt.CheckpointManager(ckpt["torch"])
    model = RnntModel.from_config(train_cfg)
    params = {}
    for step, wer in STEPS.items():
        model.init_weights(torch.Generator().manual_seed(step))
        params[step] = to_flax(model)
        jmgr.save(step, {"params": params[step]}, {"wer": wer})
        tmgr.save(step, {"model": model.state_dict()}, {"wer": wer})

    lm = {"jax": str(root / "lm_jax"), "torch": str(root / "lm_torch")}
    jlm = JLm(JLmConfig(num_symbols=vocab, **LM_DIMS))
    tlm = RnnLm(RnnLmConfig(num_symbols=vocab, **LM_DIMS))
    jmgr, tmgr = JCkpt(lm["jax"], monitor="acc", mode="max"), \
        tckpt.CheckpointManager(lm["torch"], monitor="acc", mode="max")
    for step, acc in LM_STEPS.items():
        p = jax.tree.map(np.asarray, jlm.init(
            jax.random.PRNGKey(step), jnp.zeros((1, 2), jnp.int32))["params"])
        jmgr.save(step, {"params": p}, {"acc": acc})
        tmgr.save(step, {"model": flax_to_state_dict(p, tlm)}, {"acc": acc})
    return {"root": root, "infer": str(infer_path), "ckpt": ckpt, "lm": lm,
            "train_config": train_cfg, "params": params}


def _run_jax(infer_path, overrides, monkeypatch):
    import inference as jinf
    from speech2text_tpu.parallel import mesh as jmesh
    one_device = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda config=None, devices=None:
                        one_device(config, devices=jax.devices()[:1]))
    jinf.FLAGS.unparse_flags()
    jinf.FLAGS(["inference", f"--inference_config={infer_path}"]
               + [f"--override={o}" for o in overrides])
    jinf.run_inference([])


LM_FUSION = "decoding.config.lm_fusion."
CASES = {
    "greedy_averaged": ["task.chkpt_aver=true"],
    "beam_named": ["decoding.type=rnnt_beam_search",
                   "decoding.config.beam_size=3",
                   "decoding.config.cutoff_top_k=2", "task.chkpt_name=3"],
    "beam_lm_latest": ["decoding.type=rnnt_beam_search",
                       LM_FUSION + "lm_weight=0.5", LM_FUSION + "best_k=2"]
    + [f"{LM_FUSION}lm_config.{k}={v}" for k, v in LM_DIMS.items()],
    "streaming_beam_averaged": ["streaming.is_encoder_streaming=true",
                                "decoding.config.streaming_chunk_size=8",
                                "decoding.config.streaming_left_chunks=2",
                                "decoding.type=rnnt_beam_search",
                                "task.chkpt_aver=true"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_report_equals_jax(setup, case, monkeypatch):
    out = {}
    for pkg in ("jax", "torch"):
        workdir = setup["root"] / case / pkg
        overrides = CASES[case] + [
            f"task.export_path={workdir}",
            f"task.checkpoints_dir={setup['ckpt'][pkg]}"]
        if "lm" in case:
            overrides.append(f"{LM_FUSION}checkpoint_dir={setup['lm'][pkg]}")
        if pkg == "jax":
            _run_jax(setup["infer"], overrides, monkeypatch)
        else:
            run = tinf.main(["--inference_config", setup["infer"],
                             "--device", "cpu"]
                            + [a for o in overrides for a in ("--override",
                                                             o)])
            assert run["num_utts"] == REPORT_BLOCKS and run["batches"] == 2
            assert (workdir / "inference.log").exists()
        out[pkg] = (workdir / "test_report.txt").read_bytes()
    text = out["torch"].decode()
    assert text.count("\nhyp: ") == REPORT_BLOCKS
    assert text.splitlines()[-1].startswith("corpus wer: ")
    assert out["torch"] == out["jax"]


def test_checkpoint_selection(setup):
    """inference_weights: averaged best-k by wer, named, latest."""
    cfg, d = setup["train_config"], setup["ckpt"]["torch"]
    mgr = tckpt.CheckpointManager(d)
    avg = tckpt.inference_weights(
        {"chkpt_aver": True, "aver_best_k": 2, "checkpoints_dir": d}, cfg)
    want = tckpt.average_checkpoints(d, best_k=2)
    assert mgr.best_steps(2) == [2, 3]
    assert all(torch.equal(avg[k], want[k]) for k in want)
    named = tckpt.inference_weights({"chkpt_name": "1",
                                     "checkpoints_dir": d}, cfg)
    latest = tckpt.inference_weights({"checkpoints_dir": d}, cfg)
    for got, step in ((named, 1), (latest, 3)):
        ref = mgr.restore(step)["model"]
        assert all(torch.equal(got[k], ref[k]) for k in ref)
    # the default directory: <export_path>/<name>/checkpoints
    with pytest.raises(FileNotFoundError, match="tasks/tiny/checkpoints"):
        tckpt.inference_weights({}, cfg)
    # descending ranks by max: the worst wer first
    worst = tckpt.inference_weights({"chkpt_aver": True, "aver_best_k": 1,
                                     "descending": True,
                                     "checkpoints_dir": d}, cfg)
    ref = mgr.restore(1)["model"]
    assert all(torch.equal(worst[k], ref[k]) for k in ref)


def _streaming_infer(train_cfg):
    return {"task": {"type": "pruned_rnnt_inference",
                     "train_config": train_cfg},
            "testset": {"config": {"batch_size": 2}},
            "decoding": {"type": "rnnt_greedy_search",
                         "config": {"max_token_step": 1}},
            "streaming": {"is_encoder_streaming": True}}


def test_server_streaming_matches_jax_chunked(setup):
    """With streaming.is_encoder_streaming the server runs the encoder
    chunk-masked (32 frames, 4 chunks of left context), as JAX's
    eval_forward does; full context gives a different encoder output."""
    from speech2text_tpu.data import frontend as jf
    from speech2text_tpu.decoding import RnntGreedyDecoding as JGreedy
    from speech2text_tpu.tasks.rnnt import RnntModel as JModel
    cfg = setup["train_config"]
    params = setup["params"][1]
    server = RnntServer(_streaming_infer(cfg), device="cpu",
                        checkpoint=os.path.join(setup["ckpt"]["torch"],
                                                "step_00000001.pt"))
    assert server.streaming == (32, 4)
    rng = np.random.default_rng(9)
    pcm = (3000 * rng.standard_normal((2, 64000))).astype(np.int16)
    lens = np.array([64000, 41000], np.int32)
    tokens, counts = server.transcribe(pcm, lens)
    enc, enc_lens = server.encode(*server.featurize(pcm, lens))

    jm = _build_model(cfg)
    feats, feat_lens = jf.Fbank(jf.FbankConfig(), use_pallas=False)(
        jnp.asarray(pcm.astype(np.float32) / 32768.0), jnp.asarray(lens))

    def jenc(p, f, n, cs, lc):
        return jm.apply({"params": p}, f, n, deterministic=True,
                        chunk_size=cs, left_context_chunks=lc,
                        method=lambda m, *a, **k: m.encoder(*a, **k))

    jenc = jax.jit(jenc)
    want_enc, want_lens = jenc(params, feats, feat_lens, jnp.int32(32),
                               jnp.int32(4))
    full_enc, _ = jenc(params, feats, feat_lens, jnp.int32(-1), jnp.int32(-1))
    np.testing.assert_array_equal(enc_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), rtol=1e-4,
                               atol=1e-4)
    assert np.abs(np.asarray(full_enc) - np.asarray(want_enc)).max() > 1e-3

    def pred_step(p, tok, state):
        return jm.apply({"params": p}, tok, state,
                        method=JModel.predictor_step)

    def join_step(p, e, pr):
        return jm.apply({"params": p}, e, pr, method=JModel.joiner_step)

    jdec = JGreedy(None, pred_step, lambda B: jnp.zeros((B, 1), jnp.int32),
                   join_step)
    want_tok, want_cnt = jdec._decode_jit(params, want_enc, want_lens)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tok))


def test_server_checkpoint_and_fusion(setup):
    """A checkpoint directory is resolved as the inference entry resolves
    it; the server decodes with beam search and the fusion LM."""
    cfg = setup["train_config"]
    infer = _streaming_infer(cfg)
    infer["task"].update(chkpt_aver=True, aver_best_k=2)
    infer["streaming"]["is_encoder_streaming"] = False
    infer["decoding"] = {"type": "rnnt_beam_search", "config": {
        "beam_size": 2, "cutoff_top_k": 2,
        "lm_fusion": {"checkpoint_dir": setup["lm"]["torch"],
                      "lm_config": dict(LM_DIMS)}}}
    server = RnntServer(infer, device="cpu",
                        checkpoint=setup["ckpt"]["torch"])
    want = tckpt.average_checkpoints(setup["ckpt"]["torch"], best_k=2)
    got = server.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert server.lm is not None and server.streaming == (-1, -1)
    assert server.decoder._lm_weight == 0.3
    pcm = (3000 * np.random.default_rng(2).standard_normal((2, 20000))
           ).astype(np.int16)
    tokens, counts = server.transcribe(pcm, np.array([20000, 9000],
                                                     np.int32))
    assert tokens.shape == (2, 256) and counts.dtype == torch.int32


def test_unported_options_raise(setup, monkeypatch):
    base = ["--inference_config", setup["infer"], "--device", "cpu",
            "--override", f"task.checkpoints_dir={setup['ckpt']['torch']}",
            "--override", f"task.export_path={setup['root'] / 'unported'}"]
    for ov in ("task.type=rnnt_inference",
               "task.type=ctc_hybrid_rnnt_inference"):
        # the full-lattice tasks refuse a pruned joiner
        with pytest.raises(ValueError, match="prune_range"):
            tinf.main(base + ["--override", ov])
    for ov in ("decoding.type=ctc_greedy_search",
               "decoding.type=ctc_prefix_beam_search"):
        with pytest.raises(NotImplementedError):
            tinf.main(base + ["--override", ov])
    # int8 decoding, module_export and onnx_export are ported
    # (tests/test_torch_quant.py, tests/test_torch_export.py)
    cfg = dict(setup["train_config"], metric={"int8": True})
    assert isinstance(PrunedRnntTask(cfg).decode_session, Int8Decoding)
    infer = _streaming_infer(setup["train_config"])
    infer["decoding"]["config"]["int8"] = True
    assert isinstance(RnntServer(infer, device="cpu").decoder, Int8Decoding)
    small = dict(LM_DIMS, num_symbols=5)
    cfg = dict(setup["train_config"], metric={
        "decode_method": "rnnt_beam_search",
        "lm_fusion": {"checkpoint_dir": setup["lm"]["torch"],
                      "lm_config": small}})
    with pytest.raises(ValueError, match="do not cover"):
        PrunedRnntTask(cfg)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = setup["root"] / "no_card"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinf.main(["--inference_config", setup["infer"],
                   "--override", f"task.export_path={out}"])
    assert not out.exists()


def test_inference_train_config(setup):
    """What inference.py applies: the spm path of the training run, the
    test set, the decoding section, the streaming flag."""
    infer = yaml.safe_load(Path(setup["infer"]).read_text())
    train = yaml.safe_load(Path(infer["task"]["train_config"]).read_text())
    train["tokenizer"]["config"] = {"spm_model": None}
    infer["task"]["train_config"] = train
    infer["streaming"]["is_encoder_streaming"] = True
    infer["decoding"] = {"type": "rnnt_beam_search",
                         "config": {"beam_size": 2}}
    got = tinf.inference_train_config(infer)
    spm = os.path.join(train["task"]["export_path"], "tiny", "spm")
    assert got["tokenizer"]["config"] == {
        "spm_model": os.path.join(spm, "tokenizer.model"),
        "spm_vocab": os.path.join(spm, "tokenizer.vocab")}
    assert got["dataset"]["test_data"] == infer["testset"]["test_data"]
    assert got["metric"] == {"decode_method": "rnnt_beam_search",
                             "max_token_step": 1, "beam_size": 2,
                             "encoder_streaming": True}
    assert train["tokenizer"]["config"] == {"spm_model": None}
    del infer["testset"]["test_data"]
    assert tinf.inference_train_config(infer)["dataset"]["test_data"] == \
        train["dataset"]["eval_data"]
