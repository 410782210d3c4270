"""The port's Wav2Vec2 (speech2text_torch/models/wav2vec2.py), its HF
checkpoint converter (speech2text_torch/tools/convert_wav2vec2.py), the
PCM frontend of tasks/base.py and the wav2vec2 CTC recipe against the JAX
package's, on the CPU, f32, dropout off, on numpy-seeded inputs:

- `conv_output_lengths` over 0-20 000 samples, equal;
- the forward (hidden 32, 2 layers, positional conv 16/4, 0.5 s of PCM
  and a shorter row, weights from a synthetic HF checkpoint through JAX's
  `hf_to_flax`) in both layouts, freeze on and off: rtol 1e-4 (atol 1e-4
  × the output's scale; the GroupNorm's statistics over ~1600 frames and
  seven convolutions sum in other orders than XLA's);
- the gradients of a CTC loss, rtol 1e-3 (atol 1e-3 × each tensor's
  largest; the key biases, whose exact gradient is 0, within 1e-5 of the
  largest gradient): with the extractor frozen its parameters get no
  gradient (JAX's are zeros), and after one AdamW step they are decayed
  as JAX's, p − lr·wd·p, and otherwise unchanged;
- the port's converter against JAX's `read_safetensors` + `hf_to_flax`
  on files written by JAX's `write_safetensors` (F32) and by the port's
  writer (F32 and BF16 tensors), with `weight_g`/`weight_v` and
  `parametrizations.weight.original0/1`: every tensor equal, the same
  layout record; a layout or shape mismatch raises in both packages'
  merges;
- the PCM featurize given JAX's add_noise draws (rtol = atol = 1e-5);
- wav2vec2_ctc.yaml's recipe at tiny dims (merged from a converted
  checkpoint through `pretrained_path`) trained by the port's Trainer and
  by JAX's from the same weights: two steps' losses rtol 1e-4, grad_norm
  rtol 1e-3, an evaluation (val_loss rtol 1e-4, WER equal); and the YAML
  through build_task's main, then ctc_greedy_search.yaml through both
  inference entries: test_report.txt equal byte for byte.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech2text_tpu.losses import Loss as JLoss
from speech2text_tpu.models import wav2vec2 as jw
from speech2text_tpu.tasks.base import AsrTaskBase as JTaskBase
from speech2text_tpu.tools import convert_wav2vec2 as jconv

from speech2text_torch import build_task
from speech2text_torch import inference as tinf
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.losses import Loss
from speech2text_torch.models import wav2vec2 as tw
from speech2text_torch.optim import Adam
from speech2text_torch.tasks.base import Featurizer
from speech2text_torch.tasks.ctc import CtcTask
from speech2text_torch.tools import convert_wav2vec2 as tconv
from speech2text_torch.train.loop import Trainer

from conformer_task_util import ctc_config, make_corpus, metrics_lines
from test_torch_augment import _noisy_batch, _t, jax_noise_draws

DIMS = dict(hidden=32, num_layers=2, ffn=64, pos_kernel=16, pos_groups=4)
N = 8000
LENGTHS = (N, 5003)
CTC_LOSS = {"model": "CTC", "config": {"blank_label": 0, "reduction": "mean",
                                       "zero_infinity": True}}
LR, WD = 1e-3, 1e-2


def _config(stable, freeze=True, **kw):
    return dict(hidden_dim=DIMS["hidden"], num_layers=DIMS["num_layers"],
                num_heads=2, ffn_dim=DIMS["ffn"], output_dim=24, dropout=0.0,
                conv_pos_kernel=DIMS["pos_kernel"],
                conv_pos_groups=DIMS["pos_groups"],
                freeze_feature_extractor=freeze,
                feat_extract_norm="layer" if stable else "group",
                do_stable_layer_norm=stable, **kw)


def _hf(stable, seed=3, **kw):
    return tconv.synthetic_hf_tensors(stable=stable, seed=seed, **DIMS, **kw)


def _models(stable, freeze):
    """Both encoders with every tensor but the head from a synthetic HF
    checkpoint through JAX's `hf_to_flax`, the head the port's seeded
    init."""
    jm = jw.Wav2Vec2Encoder(jw.Wav2Vec2Config(**_config(stable, freeze)))
    rng = np.random.default_rng(1)
    pcm = (0.1 * rng.standard_normal((2, N))).astype(np.float32)
    pcm[1, LENGTHS[1]:] = 0.0
    lens = np.asarray(LENGTHS, np.int32)
    tm = tw.Wav2Vec2Encoder(tw.Wav2Vec2Config(**_config(stable, freeze)))
    tm.head.init_parameters(torch.Generator().manual_seed(0))
    params = jconv.hf_to_flax(_hf(stable))
    params.pop("__layout__")
    params["head"] = to_flax(tm)["head"]
    tm.load_state_dict(flax_to_state_dict(params, tm))
    return jm, jax.tree.map(jnp.asarray, params), tm, pcm, lens


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()) + 1e-12)


def test_conv_output_lengths_match_jax():
    n = np.arange(0, 20001, dtype=np.int32)
    got = tw.conv_output_lengths(torch.from_numpy(n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jw.conv_output_lengths(jnp.asarray(n))))
    assert int(got[399]) == 0 and int(got[400]) == 1


@pytest.mark.parametrize("stable,freeze", [(False, True), (False, False),
                                           (True, True), (True, False)])
def test_forward_matches_jax(stable, freeze):
    jm, params, tm, pcm, lens = _models(stable, freeze)
    want, want_lens = jm.apply({"params": params}, jnp.asarray(pcm),
                               jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = tm(torch.from_numpy(pcm), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == (2, 24, 24) and int(got_lens[1]) == 15
    assert float(got[1, 15:].abs().max()) == 0.0
    _close(got, want, 1e-4)


def _ctc_grads(jm, params, tm, pcm, lens):
    rng = np.random.default_rng(9)
    labels = rng.integers(1, 24, (2, 4)).astype(np.int32)
    label_lens = np.asarray([4, 3], np.int32)
    jloss = JLoss(CTC_LOSS)

    def loss_fn(p):
        out, out_lens = jm.apply({"params": p}, jnp.asarray(pcm),
                                 jnp.asarray(lens))
        return jloss({"logits": out, "logits_length": out_lens,
                      "label": jnp.asarray(labels),
                      "label_length": jnp.asarray(label_lens)})

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    out, out_lens = tm(torch.from_numpy(pcm), torch.from_numpy(lens))
    loss = Loss(CTC_LOSS)({"logits": out, "logits_length": out_lens,
                           "label": torch.from_numpy(labels),
                           "label_length": torch.from_numpy(label_lens)})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-4)
    return grads


@pytest.mark.parametrize("stable,freeze", [(False, True), (True, False)])
def test_ctc_gradients_match_jax(stable, freeze):
    """Every gradient within rtol 1e-3; the key projections' biases,
    whose exact gradient is 0 (a bias on every key shifts a row's scores
    alike), within 1e-5 of the largest gradient in both. Frozen: the
    extractor takes no gradient (JAX's are zeros) and one AdamW step
    decays it as JAX's does, p − lr·wd·p, and moves it no further."""
    jm, params, tm, pcm, lens = _models(stable, freeze)
    grads = _ctc_grads(jm, params, tm, pcm, lens)
    want = flax_to_state_dict(jax.tree.map(np.asarray, grads), tm)
    scale = max(float(g.abs().max()) for g in want.values())
    for k, p in tm.named_parameters():
        g = want[k]
        if freeze and k.startswith("feature_extractor."):
            assert p.grad is None and float(g.abs().max()) == 0.0, k
            continue
        if k.endswith("k_proj.bias"):
            assert max(float(p.grad.abs().max()),
                       float(g.abs().max())) < 1e-5 * scale, k
            continue
        assert p.grad is not None and float(p.grad.abs().max()) > 0, k
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=1e-3,
                                   atol=1e-3 * float(g.abs().max()),
                                   err_msg=k)
    if not freeze:
        return
    tx = optax.adamw(LR, weight_decay=WD)
    new = optax.apply_updates(params, tx.update(grads, tx.init(params),
                                                params)[0])
    before = {k: v.detach().clone()
              for k, v in tm.feature_extractor.state_dict().items()}
    Adam(tm.parameters(), lambda c: LR, weight_decay=WD).step()
    want = flax_to_state_dict(jax.tree.map(np.asarray, new), tm)
    for k, p in tm.feature_extractor.state_dict().items():
        decayed = before[k] + (-LR) * (WD * before[k])
        assert torch.equal(p, decayed), k
        assert not torch.equal(p, before[k]), k
        np.testing.assert_allclose(p.numpy(),
                                   want["feature_extractor." + k].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=k)


CONVERT_CASES = [  # stable, parametrized weight norm, BF16 tensors
    (False, False, False), (True, True, False), (False, True, True),
    (True, False, True)]


@pytest.mark.parametrize("stable,parametrized,bf16", CONVERT_CASES)
def test_converter_matches_jax(stable, parametrized, bf16, tmp_path):
    tensors = _hf(stable, seed=5, parametrized=parametrized,
                  prefix="wav2vec2." if parametrized else "")
    path = str(tmp_path / "model.safetensors")
    if bf16:
        half = [k for i, k in enumerate(sorted(tensors)) if i % 2]
        tconv.write_safetensors(tensors, path, bf16=half)
    else:
        jconv.write_safetensors(tensors, path)
    jt = jconv.read_safetensors(path)
    tt = tconv.read_safetensors(path)
    assert set(jt) == set(tt) == set(tensors)
    for k in jt:
        assert np.array_equal(jt[k], tt[k]), k
        if bf16 and k in half:
            assert not np.array_equal(tt[k], tensors[k]), k
            np.testing.assert_allclose(tt[k], tensors[k], rtol=2 ** -8)
    jparams = jconv.hf_to_flax(jt)
    jlayout = {k: int(v) for k, v in jparams.pop("__layout__").items()}
    state, layout = tconv.convert(path, str(tmp_path / "w2v2.pt"))
    assert layout == jlayout == {"num_layers": 2,
                                 "do_stable_layer_norm": int(stable),
                                 "feat_extract_norm": int(stable)}
    model = tw.Wav2Vec2Encoder(tw.Wav2Vec2Config(**_config(stable)))
    want = flax_to_state_dict(
        dict(jax.tree.map(np.asarray, jparams),
             head=to_flax(model)["head"]), model)
    assert set(state) == set(want) - {"head.weight", "head.bias"}
    for k, v in state.items():
        assert torch.equal(v, want[k]), k
    saved = torch.load(str(tmp_path / "w2v2.pt"), weights_only=True)
    assert saved["layout"] == layout and saved["encoder"].keys() == \
        state.keys()


def _pcm_task_config(encoder_cfg):
    return {"tokenizer": {"type": "char", "config": {}},
            "dataset": {"feat_type": "pcm", "feat_config": {"dummy": -1},
                        "data_aug_config": {}},
            "metric": {},
            "encoder": {"model": "Wav2Vec2", "config": encoder_cfg},
            "decoder": {"model": "Projector",
                        "config": {"input_dim": 24, "num_classes": 31,
                                   "dropout_p": 0.0}},
            "loss": {"model": "CTC", "config": {}}}


@pytest.mark.parametrize("mismatch", ["layout", "shape"])
def test_merge_mismatch_raises_in_both(mismatch, tmp_path):
    """A stable checkpoint into a base encoder (layout), or a base one
    into a wider base encoder (shape): ValueError from both packages'
    merges, the JAX one given its own converter's msgpack; the matching
    checkpoint merges in both."""
    st = str(tmp_path / "model.safetensors")
    jconv.write_safetensors(_hf(mismatch == "layout"), st)
    jpath, tpath = str(tmp_path / "w.msgpack"), str(tmp_path / "w.pt")
    jconv.convert(st, jpath)
    tconv.convert(st, tpath)
    enc = _config(False)
    if mismatch == "shape":
        enc["hidden_dim"] = 48
    live = tw.Wav2Vec2Encoder(tw.Wav2Vec2Config(**enc))
    jtask = JTaskBase.__new__(JTaskBase)
    jtask.config = {"encoder": {"config": dict(enc, pretrained_path=jpath)}}
    ttask = CtcTask(_pcm_task_config(dict(enc, pretrained_path=tpath)))
    with pytest.raises(ValueError):
        jtask.merge_pretrained_encoder({"encoder": to_flax(live)})
    with pytest.raises(ValueError):
        ttask.merge_pretrained_encoder()
    fresh = CtcTask(_pcm_task_config(dict(enc, pretrained_path=None)))
    assert all(torch.equal(a, b) for a, b in zip(
        ttask.model.state_dict().values(), fresh.model.state_dict().values()))
    ok = _config(mismatch == "layout")
    ttask = CtcTask(_pcm_task_config(dict(ok, pretrained_path=tpath)))
    assert ttask.merge_pretrained_encoder() == len(
        torch.load(tpath, weights_only=True)["encoder"])
    jtask.config = {"encoder": {"config": dict(ok, pretrained_path=jpath)}}
    jtask.merge_pretrained_encoder({"encoder": to_flax(
        tw.Wav2Vec2Encoder(tw.Wav2Vec2Config(**ok)))})


def test_pcm_featurize_given_jax_draws():
    aug = {"use_add_noise": True, "add_noise_proportion": 0.5,
           "add_noise_config": {"min_snr_db": 10, "max_snr_db": 50},
           "use_mix_feats": True, "use_spec_aug": True}
    cfg = {"tokenizer": {"type": "char"},
           "dataset": {"feat_type": "pcm", "feat_config": {"dummy": -1},
                       "data_aug_config": aug}}
    batch = _noisy_batch(0)
    rng = jax.random.PRNGKey(100)
    want, want_lens = JTaskBase(cfg).featurize(
        {k: jnp.asarray(v) for k, v in batch.items()}, rng, training=True)
    k_noise, k_apply1 = jax.random.split(rng, 6)[:2]
    draws = {"add_noise": jax_noise_draws(
        k_noise, k_apply1, 0.5, jnp.asarray(batch["noise_length"]), 10.0,
        50.0)}
    feat = Featurizer(cfg)
    tb = {k: _t(v) for k, v in batch.items()}
    assert set(feat.sample_augmentation(tb, torch.Generator())) == \
        {"add_noise"}
    got, got_lens = feat.featurize(tb, training=True, draws=draws)
    assert got.shape == batch["pcm"].shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert bool(draws["add_noise"]["apply"].any())
    plain, _ = feat.featurize(tb)
    assert torch.equal(plain, _t(batch["pcm"]).float() / 32768.0)


# ------------------------------------------------------------- the recipe
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


def _recipe_config(corpus, workdir, pretrained=None):
    cfg = ctc_config(corpus, workdir)
    cfg["dataset"] = dict(cfg["dataset"], feat_type="pcm",
                          feat_config={"dummy": -1})
    cfg["encoder"] = {"model": "Wav2Vec2", "config": dict(
        _config(False), output_dim=32, pretrained_path=pretrained)}
    return cfg


def test_wav2vec2_trainer_matches_jax_trainer(corpus, tmp_path):
    from speech2text_tpu.parallel.mesh import MeshConfig, make_mesh
    from speech2text_tpu.tasks.ctc import CtcTask as JTask
    from speech2text_tpu.train.loop import Trainer as JTrainer

    st = str(tmp_path / "model.safetensors")
    jconv.write_safetensors(_hf(False), st)
    state, _ = tconv.convert(st, str(tmp_path / "w2v2.pt"))
    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    tcfg = _recipe_config(corpus, tdir, str(tmp_path / "w2v2.pt"))
    jcfg = _recipe_config(corpus, jdir)
    task = CtcTask(tcfg)
    trainer = Trainer(task, tcfg, tdir, seed=7, device="cpu")
    enc = task.model.encoder.state_dict()
    assert all(torch.equal(enc[k], v) for k, v in state.items())
    start = jax.tree.map(jnp.asarray, to_flax(task.model))
    got_eval = trainer.fit(max_steps=2)
    trainer.close()
    mesh = make_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    want_eval = JTrainer(JTask(jcfg), jcfg, jdir, seed=7, mesh=mesh).fit(
        finetune_params=start, max_steps=2)
    got, want = metrics_lines(tdir), metrics_lines(jdir)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-3)
        assert g["frames_per_sec"] > 0
    assert got_eval["val_loss"] == pytest.approx(want_eval["val_loss"],
                                                 rel=1e-4)
    assert got_eval["wer"] == want_eval["wer"]


def test_wav2vec2_yaml_build_task_and_greedy_report(corpus, tmp_path,
                                                   monkeypatch):
    import inference as jinf
    from speech2text_tpu.parallel import mesh as jmesh
    from speech2text_tpu.train.checkpoint import CheckpointManager as JCkpt
    argv = ["--training_config", "configs/training/wav2vec2_ctc.yaml",
            "--device", "cpu", "--max_steps", "2",
            "--override", f"task.export_path={tmp_path / 'tasks'}",
            "--override", f"tokenizer.config.spm_model={corpus['spm_model']}",
            "--override", "tokenizer.apply_train=false",
            "--override", "trainer.val_check_interval=2",
            "--override", "trainer.log_interval=1",
            "--override", "dataset.bucket_sampler_config.num_bucket=1",
            "--override", "dataset.bucket_sampler_config.volume_threshold=6",
            "--override", "dataset.bucket_sampler_config.min_batch_size=3",
            "--override", "dataset.batch_size=4",
            "--override", f"decoder.config.num_classes={corpus['vocab']}",
            "--override", "decoder.config.input_dim=24"]
    for key, value in _config(False).items():
        argv += ["--override", f"encoder.config.{key}={value}"]
    for key in ("train_data", "eval_data", "noise_data"):
        argv += ["--override", f"dataset.{key}={corpus[key]}"]
    trainer = build_task.main(argv)
    assert isinstance(trainer.task.model.encoder, tw.Wav2Vec2Encoder)
    lines = metrics_lines(trainer.workdir)
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in lines)
    assert set(trainer.last_eval) == {"val_loss", "wer"}

    train_yaml = os.path.join(trainer.workdir, "wav2vec2_ctc.yaml")
    jdir = str(tmp_path / "jax_ckpt")
    JCkpt(jdir).save(2, {"params": to_flax(trainer.task.model)},
                     {"wer": trainer.last_eval["wer"]})
    one_device = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda config=None, devices=None:
                        one_device(config, devices=jax.devices()[:1]))
    out = {}
    yaml_path = "configs/inference/ctc_greedy_search.yaml"
    for pkg, ckpt in (("jax", jdir), ("torch", trainer.ckpt.directory)):
        workdir = tmp_path / pkg
        overrides = [f"task.train_config={train_yaml}",
                     f"task.export_path={workdir}",
                     f"task.checkpoints_dir={ckpt}",
                     f"testset.test_data={corpus['eval_data']}"]
        if pkg == "jax":
            jinf.FLAGS.unparse_flags()
            jinf.FLAGS(["inference", f"--inference_config={yaml_path}"]
                       + [f"--override={o}" for o in overrides])
            jinf.run_inference([])
        else:
            run = tinf.main(["--inference_config", yaml_path, "--device",
                             "cpu"] + [a for o in overrides
                                       for a in ("--override", o)])
            assert isinstance(run["task"].model.encoder, tw.Wav2Vec2Encoder)
        out[pkg] = (workdir / "test_report.txt").read_bytes()
    assert out["torch"].decode().count("\nhyp: ") >= 8
    assert out["torch"] == out["jax"]
