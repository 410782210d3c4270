"""The port's Emformer (speech2text_torch/models/emformer.py) and its CTC
recipe against the JAX package's, on the CPU, f32, dropout off:

- the attention and memory masks and the segment summaries, equal;
- the forward at 2 layers × 64, segment 4, left 8, right 2, with
  `max_memory_size` 0 and 2, on lengths whose second utterance ends in
  fully padded segments: rtol 1e-5 (atol 1e-5 × the output's scale);
- `streaming_step` over 5 chunks, with and without the bank, and the
  ValueError of a chunk that is not one segment while the bank is on;
- the gradients of a CTC loss on the encoder's output, rtol 1e-4;
- configs/training/emformer_ctc.yaml's recipe at tiny dims (the
  Emformer above, Projector head, AdamW + Warmup with clipping 5.0,
  augmentation off but speed perturbation) trained by the port's Trainer
  and by JAX's from the same weights: two steps' losses rtol 1e-5,
  grad_norm rtol 1e-4, then an evaluation (val_loss rtol 1e-5, WER
  equal); and the YAML itself through build_task's main (two steps,
  an evaluation), then ctc_greedy_search.yaml through both packages'
  inference entries on its checkpoint: test_report.txt equal byte for
  byte.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from speech2text_tpu.losses import Loss as JLoss
from speech2text_tpu.models import emformer as je

from speech2text_torch import build_task
from speech2text_torch import inference as tinf
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.losses import Loss
from speech2text_torch.models import emformer as te
from speech2text_torch.tasks.ctc import CtcTask
from speech2text_torch.train.loop import Trainer

from conformer_task_util import ctc_config, make_corpus, metrics_lines

CFG = dict(feats_dim=80, subsampling_rate=4, input_dim=64, num_heads=4,
           ffn_dim=128, num_layers=2, segment_length=4,
           left_context_length=8, right_context_length=2, output_dim=64,
           dropout=0.0)
CTC_LOSS = {"model": "CTC", "config": {"blank_label": 0, "reduction": "mean",
                                       "zero_infinity": True}}
CHUNK_FRAMES = 19            # → one segment of 4 frames after subsampling
# 80 raw frames → 19 subsampled; 40 → 9: segments 3-4 of row 1 all pad
LENGTHS = (80, 40)


def _models(memory):
    jcfg = je.EmformerConfig(**CFG, max_memory_size=memory)
    jm = je.Emformer(jcfg)
    rng = np.random.default_rng(11 + memory)
    x = rng.standard_normal((2, LENGTHS[0], 80)).astype(np.float32)
    lens = np.asarray(LENGTHS, np.int32)
    params = jm.init(jax.random.PRNGKey(memory), jnp.asarray(x),
                     jnp.asarray(lens))["params"]
    # norm scales and biases off their init values
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: p + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), p.shape)
        if path[-1].key in ("scale", "bias") else p, params)
    tm = te.Emformer(te.EmformerConfig(**CFG, max_memory_size=memory))
    tm.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, {"p": params})["p"], tm))
    return jm, params, tm, x, lens


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def test_masks_and_summaries_match_jax():
    for T, seg, left, right, mem in ((12, 4, 4, 2, 2), (19, 4, 8, 2, 1),
                                     (7, 3, 0, 0, 3)):
        assert np.array_equal(
            te.emformer_attention_mask(T, seg, left, right).numpy(),
            np.asarray(je.emformer_attention_mask(T, seg, left, right)))
        assert np.array_equal(
            te.emformer_memory_mask(T, seg, mem).numpy(),
            np.asarray(je.emformer_memory_mask(T, seg, mem)))
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 10, 8)).astype(np.float32)
    pad = np.arange(10)[None, :] < np.asarray([10, 5])[:, None]
    _close(te.segment_summaries(torch.from_numpy(h), torch.from_numpy(pad),
                                4),
           je.segment_summaries(jnp.asarray(h), jnp.asarray(pad), 4), 1e-6)


@pytest.mark.parametrize("memory", [0, 2])
def test_forward_matches_jax(memory):
    jm, params, tm, x, lens = _models(memory)
    want, want_lens = jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                                        jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = tm(torch.from_numpy(x), torch.from_numpy(lens))
    assert np.array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert int(got_lens[1]) == 9 and got.shape[1] == 19
    assert float(got[1, 9:].abs().max()) == 0.0
    _close(got, want, 1e-5)
    with torch.no_grad():
        assert torch.equal(tm.streaming_forward(
            torch.from_numpy(x), torch.from_numpy(lens))[0], got)


@pytest.mark.parametrize("memory", [0, 2])
def test_streaming_step_matches_jax(memory):
    jm, params, tm, _, _ = _models(memory)
    rng = np.random.default_rng(5)
    chunks = rng.standard_normal((5, 2, CHUNK_FRAMES, 80)).astype(np.float32)
    jstates = jm.init_state(2)
    tstates = tm.init_state(2)
    assert len(tstates) == len(jstates) == 2 * (1 + (memory > 0)) + 1
    step = jax.jit(lambda c, s: jm.apply({"params": params}, c, s,
                                         method=je.Emformer.streaming_step))
    with torch.no_grad():
        for c in chunks:
            want, jstates = step(jnp.asarray(c), jstates)
            got, tstates = tm.streaming_step(torch.from_numpy(c), tstates)
            assert got.shape == (2, 4, 64)
            _close(got, want, 1e-5)
            for g, w in zip(tstates, jstates):
                _close(g, w, 1e-5)
    assert tstates[-1].tolist() == [5, 5]


def test_streaming_step_wrong_chunk_raises():
    _, _, tm, _, _ = _models(2)
    with pytest.raises(ValueError, match="segment_length"):
        tm.streaming_step(torch.zeros(1, 32, 80), tm.init_state(1))
    _, _, tm0, _, _ = _models(0)
    out, _ = tm0.streaming_step(torch.zeros(1, 32, 80), tm0.init_state(1))
    assert out.shape == (1, 7, 64)


@pytest.mark.parametrize("memory", [0, 2])
def test_ctc_gradients_match_jax(memory):
    jm, params, tm, x, lens = _models(memory)
    rng = np.random.default_rng(9)
    labels = rng.integers(1, 64, (2, 4)).astype(np.int32)
    label_lens = np.asarray([4, 2], np.int32)
    jloss = JLoss(CTC_LOSS)

    def loss_fn(p):
        out, out_lens = jm.apply({"params": p}, jnp.asarray(x),
                                 jnp.asarray(lens))
        return jloss({"logits": out, "logits_length": out_lens,
                      "label": jnp.asarray(labels),
                      "label_length": jnp.asarray(label_lens)})

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    out, out_lens = tm(torch.from_numpy(x), torch.from_numpy(lens))
    loss = Loss(CTC_LOSS)({"logits": out, "logits_length": out_lens,
                           "label": torch.from_numpy(labels),
                           "label_length": torch.from_numpy(label_lens)})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    want = flax_to_state_dict(jax.tree.map(np.asarray, grads), tm)
    named = dict(tm.named_parameters())
    assert named["layers.1.qkv.weight"].grad.abs().max() > 0
    for k, g in want.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                   rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()) + 1e-12,
                                   err_msg=k)


# ------------------------------------------------------------- the recipe
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


def emformer_config(corpus, workdir):
    cfg = ctc_config(corpus, workdir)
    cfg["encoder"] = {"model": "Emformer", "config": dict(
        CFG, input_dim=32, ffn_dim=64, num_layers=1, output_dim=32,
        max_memory_size=2)}
    return cfg


def test_emformer_trainer_matches_jax_trainer(corpus, tmp_path):
    from speech2text_tpu.parallel.mesh import MeshConfig, make_mesh
    from speech2text_tpu.tasks.ctc import CtcTask as JTask
    from speech2text_tpu.train.loop import Trainer as JTrainer

    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    tcfg, jcfg = emformer_config(corpus, tdir), emformer_config(corpus, jdir)
    task = CtcTask(tcfg)
    assert isinstance(task.model.encoder, te.Emformer)
    trainer = Trainer(task, tcfg, tdir, seed=7, device="cpu")
    start = jax.tree.map(jnp.asarray, to_flax(task.model))
    got_eval = trainer.fit(max_steps=2)
    trainer.close()
    mesh = make_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    want_eval = JTrainer(JTask(jcfg), jcfg, jdir, seed=7, mesh=mesh).fit(
        finetune_params=start, max_steps=2)
    got, want = metrics_lines(tdir), metrics_lines(jdir)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    assert got_eval["val_loss"] == pytest.approx(want_eval["val_loss"],
                                                 rel=1e-5)
    assert got_eval["wer"] == want_eval["wer"]


def test_emformer_yaml_build_task_and_greedy_report(corpus, tmp_path,
                                                   monkeypatch):
    import inference as jinf
    from speech2text_tpu.parallel import mesh as jmesh
    from speech2text_tpu.train.checkpoint import CheckpointManager as JCkpt
    argv = ["--training_config", "configs/training/emformer_ctc.yaml",
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
            "--override", f"decoder.config.num_classes={corpus['vocab']}"]
    for key, value in dataclasses.asdict(te.EmformerConfig(
            **dict(CFG, input_dim=32, ffn_dim=64, num_layers=1,
                   output_dim=32))).items():
        if key in ("input_dim", "ffn_dim", "num_layers", "output_dim"):
            argv += ["--override", f"encoder.config.{key}={value}"]
    argv += ["--override", "decoder.config.input_dim=32"]
    for key in ("train_data", "eval_data", "noise_data"):
        argv += ["--override", f"dataset.{key}={corpus[key]}"]
    trainer = build_task.main(argv)
    assert isinstance(trainer.task.model.encoder, te.Emformer)
    assert trainer.clip == 5.0
    lines = metrics_lines(trainer.workdir)
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in lines)
    assert set(trainer.last_eval) == {"val_loss", "wer"}

    train_yaml = os.path.join(trainer.workdir, "emformer_ctc.yaml")
    jdir = str(tmp_path / "jax_ckpt")
    JCkpt(jdir).save(2, {"params": to_flax(trainer.task.model)},
                     {"wer": trainer.last_eval["wer"]})
    one_device = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda config=None, devices=None:
                        one_device(config, devices=jax.devices()[:1]))
    out = {}
    for pkg, ckpt in (("jax", jdir), ("torch", trainer.ckpt.directory)):
        workdir = tmp_path / pkg
        overrides = [f"task.train_config={train_yaml}",
                     f"task.export_path={workdir}",
                     f"task.checkpoints_dir={ckpt}",
                     f"testset.test_data={corpus['eval_data']}"]
        yaml_path = "configs/inference/ctc_greedy_search.yaml"
        if pkg == "jax":
            # JAX's entry reads the backup with PyYAML
            with open(train_yaml) as f:
                assert yaml.safe_load(f)["encoder"]["model"] == "Emformer"
            jinf.FLAGS.unparse_flags()
            jinf.FLAGS(["inference", f"--inference_config={yaml_path}"]
                       + [f"--override={o}" for o in overrides])
            jinf.run_inference([])
        else:
            run = tinf.main(["--inference_config", yaml_path, "--device",
                             "cpu"] + [a for o in overrides
                                       for a in ("--override", o)])
            assert isinstance(run["task"].model.encoder, te.Emformer)
        out[pkg] = (workdir / "test_report.txt").read_bytes()
    assert out["torch"].decode().count("\nhyp: ") >= 8
    assert out["torch"] == out["jax"]
