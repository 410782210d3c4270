"""The port's training loop (speech2text_torch/train/loop.py), checkpoints
and entry point against the JAX package's, on a synthetic corpus written
to tmp_path (speech2text_torch/tools/synth_corpus.py).

- Trainer against JAX's Trainer at `__graft_entry__._tiny_config` dims,
  one bucket, `trainer.mesh: {data: 1, model: 1}`, speed perturbation on,
  dropout, feature mask, random chunks and the device-side augmentation
  off, the same starting weights (convert.to_flax), `log_interval: 1`:
  the three steps' logged losses within rtol 1e-5 (grad_norm, a sum over
  every gradient, rtol 1e-4); then one evaluation: validation losses
  within rtol 1e-5, WER equal, and the hypotheses of the trained models
  identical.
- Resume, port only, with augmentation, dropout and random chunks on:
  4 straight steps and 2 + resume + 2 give bitwise-equal parameters and
  optimizer state.
- Top-k pruning keeps the steps JAX's CheckpointManager keeps for the
  same metric sequence; averaging; the config backup reader; the
  TensorBoard writer's bytes; the command line on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from speech2text_torch import build_task
from speech2text_torch.config import dumps, load_config, loads
from speech2text_torch.convert import to_flax
from speech2text_torch.data.spm import train_unigram
from speech2text_torch.data.manifest import iter_text, load_manifest
from speech2text_torch.data.tokenizer import TokenizerSetup
from speech2text_torch.tasks.rnnt import Int8Decoding, PrunedRnntTask
from speech2text_torch.tools.synth_corpus import write_corpus
from speech2text_torch.train import checkpoint as tckpt
from speech2text_torch.train import tb_writer as ttb
from speech2text_torch.train.loop import Trainer

REPO = Path(__file__).resolve().parents[1]
SPM_VOCAB = 64     # asked of the subword trainer; the corpus gives fewer
JAX_KEYS = ("step", "loss", "lr", "utts_per_sec", "frames_per_sec",
            "simple_loss", "pruned_loss", "train_loss", "grad_norm")
LOSS_KEYS = ("loss", "simple_loss", "pruned_loss", "train_loss")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("corpus")
    paths = write_corpus(str(out), seed=11, n_train=16, n_eval=6, n_noise=3,
                         train_seconds=(1.0, 2.0), eval_seconds=(1.0, 2.0),
                         noise_seconds=(0.5, 1.5))
    model = train_unigram(iter_text(load_manifest(paths["train_data"])),
                          vocab_size=SPM_VOCAB)
    paths["spm_model"] = str(out / "tokenizer.model")
    model.save(paths["spm_model"])
    # the model's vocabulary is the tokenizer's label count
    paths["vocab"] = len(TokenizerSetup(
        {"type": "subword", "config": {"spm_model": paths["spm_model"]}}))
    return paths


def _config(corpus, workdir, augment=False, dropout=0.0, chunks=False,
            **trainer):
    cfg = _tiny_config(corpus["vocab"])
    enc = cfg["encoder"]["config"]
    enc.update(dropout=dropout, feature_mask_dropout_prob=dropout)
    if not chunks:
        enc.update(chunk_size=[-1], left_context_frames=[-1])
    aug = {"use_speed_perturb": True}
    if augment:
        aug.update(use_spec_aug=True, use_add_noise=True,
                   add_noise_proportion=0.5, use_mix_feats=True,
                   mix_feats_proportion=0.5)
    cfg.update({
        "task": {"type": "Pruned_Rnnt", "name": os.path.basename(workdir),
                 "export_path": os.path.dirname(workdir)},
        "tokenizer": {"type": "subword",
                      "config": {"spm_model": corpus["spm_model"]}},
        "dataset": {
            "train_data": corpus["train_data"],
            "eval_data": corpus["eval_data"],
            "noise_data": corpus["noise_data"],
            "dur_min_filter": 0.1, "dur_max_filter": 60.0, "batch_size": 4,
            "use_bucket_sampler": True,
            "bucket_sampler_config": {"num_bucket": 1, "min_batch_size": 3,
                                      "volume_threshold": 6.0},
            "feat_type": "lhotes_fbank",
            "feat_config": {"num_mel_bins": 80, "snip_edges": True},
            "data_aug_config": aug},
        "loss": {"model": "Pruned_Rnnt", "simple_loss_scale": 0.5,
                 "pruned_loss_scale": 0.5,
                 "config": {"termination_symbol": 0, "reduction": "mean"},
                 "enable_ctc": False},
        "metric": {"decode_method": "rnnt_greedy_search",
                   "max_token_step": 1},
        "optim_setup": {
            "optimizer": {"type": "ScaledAdam",
                          "config": {"lr": 0.045, "clipping_scale": 2.0}},
            "lr_scheduler": {"type": "Eden",
                             "config": {"lr_batches": 7000}}},
        "trainer": dict({"mesh": {"data": 1, "model": 1},
                         "log_interval": 1, "val_check_interval": 1000},
                        **trainer),
        "callbacks": {"model_chkpt_config": {"monitor": "wer", "mode": "min",
                                             "save_top_k": 2},
                      "global_cmvn": {"apply": False}},
    })
    return cfg


def _lines(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _eval_hyps_torch(task):
    out = []
    for batch in task.make_eval_pipeline():
        arrays = {k: torch.from_numpy(v) for k, v in batch.items()
                  if not isinstance(v, list)}
        out += task.eval_hyps(task.eval_forward(arrays))
    return out


def _eval_hyps_jax(task, params):
    out = []
    fwd = jax.jit(task.eval_forward)
    for batch in task.make_eval_pipeline():
        arrays = {k: jnp.asarray(v) for k, v in batch.items()
                  if not isinstance(v, list)}
        out += task.eval_hyps(fwd(params, arrays), params)
    return out


def test_trainer_matches_jax_trainer(corpus, tmp_path):
    from speech2text_tpu.parallel.mesh import MeshConfig, make_mesh
    from speech2text_tpu.tasks.rnnt import PrunedRnntTask as JTask
    from speech2text_tpu.train.checkpoint import CheckpointManager as JCkpt
    from speech2text_tpu.train.loop import Trainer as JTrainer

    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    tcfg, jcfg = _config(corpus, tdir), _config(corpus, jdir)
    task = PrunedRnntTask(tcfg)
    assert len(task.tokenizer) == corpus["vocab"]
    trainer = Trainer(task, tcfg, tdir, seed=7, device="cpu")
    start = jax.tree.map(jnp.asarray, to_flax(task.model))
    got_eval = trainer.fit(max_steps=3)
    trainer.close()

    jtask = JTask(jcfg)
    # trainer.mesh {data: 1, model: 1} on the first of conftest's 8
    # virtual CPU devices
    mesh = make_mesh(MeshConfig(data=1, model=1),
                     devices=jax.devices()[:1])
    jtrainer = JTrainer(jtask, jcfg, jdir, seed=7, mesh=mesh)
    want_eval = jtrainer.fit(finetune_params=start, max_steps=3)

    got, want = _lines(tdir), _lines(jdir)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert set(JAX_KEYS) <= set(g) and "data_wait_ms" in g
        np.testing.assert_allclose([g[k] for k in LOSS_KEYS],
                                   [w[k] for k in LOSS_KEYS], rtol=1e-5,
                                   err_msg=f"step {g['step']}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
        # JAX's schedule computes in f32 (a few ulps), the port's in float64
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    assert got[2]["loss"] != got[0]["loss"]

    assert set(got_eval) == set(want_eval) == {
        "val_simple_loss", "val_pruned_loss", "val_loss", "wer"}
    for k in ("val_simple_loss", "val_pruned_loss", "val_loss"):
        assert got_eval[k] == pytest.approx(want_eval[k], rel=1e-5), k
    assert got_eval["wer"] == want_eval["wer"]

    jparams = JCkpt(os.path.join(jdir, "checkpoints")).restore(3)["params"]
    hyps = _eval_hyps_torch(task)
    assert hyps == _eval_hyps_jax(jtask, jparams)
    assert len(hyps) == sum(b["pcm"].shape[0]
                            for b in task.make_eval_pipeline())
    with open(os.path.join(tdir, "checkpoints", "index.json")) as f:
        assert json.load(f) == {"checkpoints": {"3": got_eval}}


def _run(corpus, workdir, max_steps):
    cfg = _config(corpus, workdir, augment=True, dropout=0.2, chunks=True,
                  val_check_interval=2, log_interval=2)
    trainer = Trainer(PrunedRnntTask(cfg), cfg, workdir, seed=3,
                      device="cpu")
    trainer.fit(max_steps=max_steps)
    trainer.close()
    return trainer


def test_resume_is_bitwise(corpus, tmp_path):
    straight = _run(corpus, str(tmp_path / "a"), 4)
    _run(corpus, str(tmp_path / "b"), 2)
    resumed = _run(corpus, str(tmp_path / "b"), 4)
    assert [h["step"] for h in resumed.history] == [3, 4]
    a, b = straight.task.model.state_dict(), resumed.task.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["step_count"] == sb["step_count"] == 4
    assert torch.equal(sa["norm_buffer"], sb["norm_buffer"])
    for name in ("delta", "exp_avg_sq", "scale_exp_avg_sq", "scale_grads",
                 "param_rms"):
        assert all(torch.equal(x, y) for x, y in zip(sa[name], sb[name]))
    # the run's own checkpoint holds that state
    saved = straight.ckpt.restore(4)
    assert saved["step"] == 4 and saved["seed"] == 3
    assert all(torch.equal(saved["model"][k], a[k]) for k in a)
    assert _lines(str(tmp_path / "a"))[-1]["loss"] == pytest.approx(
        _lines(str(tmp_path / "b"))[-1]["loss"], rel=0, abs=0)


def test_restore_into_fresh_trainer(corpus, tmp_path):
    """init_state restores weights and optimizer state bitwise."""
    workdir = str(tmp_path / "r")
    first = _run(corpus, workdir, 2)
    cfg = _config(corpus, workdir, augment=True, dropout=0.2, chunks=True)
    fresh = Trainer(PrunedRnntTask(cfg), cfg, workdir, seed=3, device="cpu")
    assert fresh.init_state() == 2
    saved = first.ckpt.restore(2)
    model = fresh.task.model.state_dict()
    assert all(torch.equal(saved["model"][k], model[k]) for k in model)
    opt = fresh.optimizer.state_dict()
    assert opt["step_count"] == saved["optimizer"]["step_count"] == 2
    assert all(torch.equal(x, y) for x, y in
               zip(opt["delta"], saved["optimizer"]["delta"]))
    fresh.close()


@pytest.mark.parametrize("monitor,mode,values", [
    ("wer", "min", [0.9, 0.8, None, 0.8, 0.95, 0.7, 0.7, 1.0, 0.85]),
    ("acc", "max", [0.1, 0.3, 0.3, None, 0.2, 0.5, 0.05, 0.3])])
def test_top_k_keeps_jax_steps(tmp_path, monitor, mode, values):
    from speech2text_tpu.train.checkpoint import CheckpointManager as JCkpt
    got = tckpt.CheckpointManager(str(tmp_path / "t"), save_top_k=3,
                                  monitor=monitor, mode=mode)
    want = JCkpt(str(tmp_path / "j"), save_top_k=3, monitor=monitor,
                 mode=mode)
    for i, v in enumerate(values):
        metrics = {} if v is None else {monitor: v, "other": float(i)}
        got.save(10 * (i + 1), {"model": {"w": torch.full((2,), float(i))}},
                 metrics)
        want.save(10 * (i + 1), {"w": np.full((2,), float(i), np.float32)},
                  metrics)
    with open(tmp_path / "t" / "index.json") as f, \
            open(tmp_path / "j" / "index.json") as g:
        assert json.load(f) == json.load(g)
    kept = sorted(p.name for p in (tmp_path / "t").glob("step_*.pt"))
    assert kept == sorted(p.name + ".pt"
                          for p in (tmp_path / "j").glob("step_*"))
    assert got.best_steps() == want.best_steps()
    assert got.latest_step() == want.latest_step() == 10 * len(values)


def test_average_checkpoints(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), save_top_k=5)
    for step, (v, wer) in enumerate([(1.0, 0.5), (2.0, 0.2), (4.0, 0.3)], 1):
        mgr.save(step, {"model": {"w": torch.full((3,), v),
                                  "n": torch.tensor([step])}}, {"wer": wer})
    avg = tckpt.average_checkpoints(str(tmp_path), best_k=2)
    assert torch.equal(avg["w"], torch.full((3,), 3.0))
    assert avg["w"].dtype == torch.float32
    assert torch.equal(avg["n"], torch.tensor([2]))   # from the best
    ft = build_task.load_finetune({"base_model": str(tmp_path),
                                   "best_k": 2})
    assert torch.equal(ft["w"], avg["w"])
    ft = build_task.load_finetune({"base_model": mgr.path(3)})
    assert torch.equal(ft["w"], torch.full((3,), 4.0))
    with pytest.raises(FileNotFoundError):
        tckpt.average_checkpoints(str(tmp_path / "empty"))


def test_config_backup_reads_back():
    for path in sorted((REPO / "configs").rglob("*.yaml")):
        cfg = load_config(str(path))
        assert loads(dumps(cfg)) == cfg, path
    odd = {"a": {"b": [1.5e-07, 3, "x'y", None, True], "c": {}, "d": []},
           "e": 1e20, "f": "null", "g": "1.0", "h": float("inf")}
    assert loads(dumps(odd)) == odd
    with pytest.raises(ValueError):
        dumps({"a": [{"b": 1}]})


def test_tb_writer_bytes_equal_jax(tmp_path, monkeypatch):
    from speech2text_tpu.train import tb_writer as jtb
    monkeypatch.setattr(ttb.time, "time", lambda: 1700000000.25)
    a = ttb.TensorBoardWriter(str(tmp_path / "t"))
    b = jtb.TensorBoardWriter(str(tmp_path / "j"))
    for w in (a, b):
        for step in range(3):
            w.add_scalar("train/loss", 1.5 / (step + 1), step,
                         wall_time=1700000001.5)
        w.close()
    assert Path(a.path).read_bytes() == Path(b.path).read_bytes()


def test_unported_options_raise(corpus, tmp_path):
    workdir = str(tmp_path / "x")
    # a model axis (tensor parallelism) is not ported
    cfg = _config(corpus, workdir, mesh={"data": 1, "model": 2})
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        Trainer(PrunedRnntTask(cfg), cfg, workdir, device="cpu")
    # data parallelism is ported (tests/test_torch_parallel.py): a data
    # axis of another size than the ranks launched raises
    cfg = _config(corpus, workdir, mesh={"data": 2, "model": 1})
    with pytest.raises(ValueError, match="data = 2, but 1 process"):
        Trainer(PrunedRnntTask(cfg), cfg, workdir, device="cpu")
    # FSDP over one process replicates, as JAX's shard_params on one device
    cfg = _config(corpus, workdir, mesh={"data": -1, "model": 1}, fsdp=True)
    trainer = Trainer(PrunedRnntTask(cfg), cfg, workdir, device="cpu")
    assert trainer.mesh.shape == {"data": 1, "model": 1} and trainer.fsdp
    trainer.init_state()
    assert trainer.task.model is trainer.model
    trainer.close()
    # gradient accumulation is ported (tests/test_torch_loop_options.py)
    cfg = _config(corpus, workdir, accumulate_grad_batches=2)
    assert Trainer(PrunedRnntTask(cfg), cfg, workdir, device="cpu").accum == 2
    for key, value in (("decode_method", "ctc_greedy_search"),
                       ("decode_method", "ctc_prefix_beam_search")):
        cfg = _config(corpus, workdir)
        cfg["metric"][key] = value
        with pytest.raises(NotImplementedError):
            PrunedRnntTask(cfg)
    # int8 decoding is ported (tests/test_torch_quant.py)
    cfg = _config(corpus, workdir)
    cfg["metric"]["int8"] = True
    assert isinstance(PrunedRnntTask(cfg).decode_session, Int8Decoding)


def _cli_config(corpus, tmp_path):
    cfg = _config(corpus, str(tmp_path / "tasks" / "cli"), augment=True,
                  dropout=0.1, chunks=True, val_check_interval=2)
    cfg["tokenizer"] = {"type": "subword", "apply_train": True,
                        "train_config": {"vocab_size": SPM_VOCAB},
                        "config": {"spm_model": None, "spm_vocab": None}}
    path = tmp_path / "cli.yaml"
    path.write_text(dumps(cfg))
    return path


def test_build_task_cli_on_cpu(corpus, tmp_path):
    path = _cli_config(corpus, tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run(
        [sys.executable, "-m", "speech2text_torch.build_task",
         f"--training_config={path}", "--device", "cpu", "--max_steps", "2",
         "--override", "trainer.log_interval=1"],
        check=True, cwd=REPO, env=env, timeout=300, capture_output=True)
    workdir = tmp_path / "tasks" / "cli"
    assert "training done" in (workdir / "run.log").read_text()
    backup = load_config(str(workdir / "cli.yaml"))
    spm = backup["tokenizer"]["config"]["spm_model"]
    assert spm == str(workdir / "spm" / "tokenizer.model")
    assert os.path.exists(spm)
    assert backup["trainer"]["log_interval"] == 1
    lines = _lines(str(workdir))
    assert [r["step"] for r in lines] == [1, 2]
    assert all(set(JAX_KEYS) <= set(r) and np.isfinite(r["loss"])
               for r in lines)
    assert (workdir / "checkpoints" / "step_00000002.pt").exists()
    index = json.loads((workdir / "checkpoints" / "index.json").read_text())
    assert set(index["checkpoints"]["2"]) >= {"val_loss", "wer"}
    assert list((workdir / "tb").glob("events.out.tfevents.*"))


def test_build_task_finetune_and_unported(corpus, tmp_path):
    path = _cli_config(corpus, tmp_path)
    base = _run(corpus, str(tmp_path / "base"), 2)
    trainer, kw = build_task.prepare([
        f"--training_config={path}", "--device", "cpu",
        f"--override=finetune.base_model={base.ckpt.path(2)}"])
    want = base.ckpt.restore(2)["model"]
    assert all(torch.equal(kw["finetune_state"][k], want[k]) for k in want)
    assert trainer.init_state(finetune_state=kw["finetune_state"]) == 0
    got = trainer.task.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    trainer.close()
    # the frontend export callback is ported (tests/test_torch_export.py)
    trainer, _ = build_task.prepare([
        f"--training_config={path}", "--device", "cpu",
        "--override=callbacks.frontend_save=true"])
    trainer.close()
    assert (tmp_path / "tasks" / "cli" / "frontend.pt2").stat().st_size > 0
    # global CMVN is ported: an existing statistics file is loaded as it is
    # (their computation: tests/test_torch_loop_options.py)
    stats = tmp_path / "stats.json"
    stats.write_text(json.dumps({"mean": [0.5] * 80, "istd": [2.0] * 80}))
    trainer, _ = build_task.prepare([
        f"--training_config={path}", "--device", "cpu",
        "--override=callbacks.global_cmvn.apply=true",
        f"--override=callbacks.global_cmvn.pre_compute_cmvn={stats}"])
    trainer.close()
    assert torch.equal(trainer.task.cmvn.mean, torch.full((80,), 0.5))
