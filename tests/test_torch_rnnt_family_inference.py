"""The remaining transducer recipes through the port's entry points, on a
synthetic corpus written to tmp_path, on the CPU:

- configs/inference/rnnt_greedy_search.yaml, rnnt_beam_search.yaml (W=4,
  K=4) and ctc_hybrid_rnnt_greedy_search.yaml through both inference
  entries, on a tiny RNN-T and a tiny CTC + RNN-T hybrid Conformer (LSTM
  predictor; tests/conformer_task_util.py's configs) with the same
  averaged checkpoints in each package's format: `test_report.txt` equal
  byte for byte.
- build_task's main on configs/training/conformer_rnnt.yaml,
  conformer_hybrid_rnnt.yaml and zipformer_heldout.yaml (`dynamics:
  true`, bf16, `seperate_lr`, the RSS watchdog's `max_rss_gb: 100`) with
  the corpus and tiny dims given by --override: two steps, an
  evaluation, a checkpoint.
- The host-RSS watchdog in a subprocess (`python -m
  speech2text_torch.build_task`, CPU) with `max_rss_gb` below the
  process's RSS: every `log_interval` (1) step it checkpoints and
  exec-restarts, each new process resumes from the checkpoint and takes
  the next step, and the run ends at `max_steps` with each step logged
  once and resume continuing the global step; with `rss_restart: false`
  the run stops, in process, at the first step over the limit, with its
  checkpoint.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from speech2text_torch import build_task
from speech2text_torch import inference as tinf
from speech2text_torch.convert import to_flax
from speech2text_torch.models.decoder import IdentityDecoder, \
    ProjectorDecoder
from speech2text_torch.models.predictor import LstmPredictor
from speech2text_torch.optim.setup import MultiOptimizer
from speech2text_torch.tasks.rnnt import (CtcHybridRnntTask, PrunedRnntTask,
                                          RnntModel, RnntTask)
from speech2text_torch.train import checkpoint as tckpt

from conformer_task_util import make_corpus, metrics_lines, rnnt_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_STEPS = {1: 0.5, 2: 0.3}             # step → wer


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


INFER = {
    "rnnt_greedy_search": ("configs/inference/rnnt_greedy_search.yaml",
                           False),
    "rnnt_beam_search": ("configs/inference/rnnt_beam_search.yaml", False),
    "ctc_hybrid_rnnt_greedy_search": (
        "configs/inference/ctc_hybrid_rnnt_greedy_search.yaml", True),
}


@pytest.fixture(scope="module")
def checkpoints(corpus, tmp_path_factory):
    """Training YAMLs of the tiny RNN-T and hybrid models, and their
    checkpoints in both packages' formats (the same seeded weights)."""
    from speech2text_tpu.train.checkpoint import CheckpointManager as JCkpt
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for hybrid in (False, True):
        kind = "hybrid" if hybrid else "rnnt"
        cfg = rnnt_config(corpus, str(root / kind / "tasks" / "tiny"),
                          hybrid)
        path = root / kind / "train.yaml"
        path.parent.mkdir(parents=True)
        path.write_text(yaml.safe_dump(cfg))
        model = RnntModel.from_config(cfg)
        dirs = {"jax": str(root / kind / "jax"),
                "torch": str(root / kind / "torch")}
        jmgr = JCkpt(dirs["jax"])
        tmgr = tckpt.CheckpointManager(dirs["torch"])
        for step, wer in CKPT_STEPS.items():
            model.init_weights(torch.Generator().manual_seed(10 + step))
            jmgr.save(step, {"params": to_flax(model)}, {"wer": wer})
            tmgr.save(step, {"model": model.state_dict()}, {"wer": wer})
        out[hybrid] = {"train": str(path), **dirs}
    return out


@pytest.mark.parametrize("name", sorted(INFER))
def test_inference_report_equals_jax(corpus, checkpoints, name, tmp_path,
                                     monkeypatch):
    import inference as jinf
    from speech2text_tpu.parallel import mesh as jmesh
    yaml_path, hybrid = INFER[name]
    one_device = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda config=None, devices=None:
                        one_device(config, devices=jax.devices()[:1]))
    out = {}
    for pkg in ("jax", "torch"):
        workdir = tmp_path / pkg
        overrides = [f"task.train_config={checkpoints[hybrid]['train']}",
                     f"task.export_path={workdir}",
                     f"task.checkpoints_dir={checkpoints[hybrid][pkg]}",
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
            assert type(run["task"]) is (CtcHybridRnntTask if hybrid
                                         else RnntTask)
            assert isinstance(run["task"].model.predictor, LstmPredictor)
        out[pkg] = (workdir / "test_report.txt").read_bytes()
    text = out["torch"].decode()
    assert text.count("\nhyp: ") >= 8
    assert text.splitlines()[-1].startswith("corpus wer: ")
    assert out["torch"] == out["jax"]


def _data_overrides(corpus, tmp_path):
    argv = ["--override", f"task.export_path={tmp_path}",
            "--override", f"tokenizer.config.spm_model={corpus['spm_model']}",
            "--override", "tokenizer.apply_train=false",
            "--override", "trainer.val_check_interval=2",
            "--override", "trainer.log_interval=1",
            "--override", "dataset.bucket_sampler_config.num_bucket=1",
            "--override", "dataset.bucket_sampler_config.volume_threshold=6",
            "--override", "dataset.bucket_sampler_config.min_batch_size=3",
            "--override", "dataset.dur_max_filter=60.0"]
    for key in ("train_data", "eval_data", "noise_data"):
        argv += ["--override", f"dataset.{key}={corpus[key]}"]
    return argv


RNNT_YAMLS = {"conformer_rnnt": (RnntTask, IdentityDecoder),
              "conformer_hybrid_rnnt": (CtcHybridRnntTask, ProjectorDecoder)}


@pytest.mark.parametrize("name", sorted(RNNT_YAMLS))
def test_build_task_rnnt_yaml(corpus, tmp_path, name):
    task_cls, head = RNNT_YAMLS[name]
    hybrid = task_cls is CtcHybridRnntTask
    v = corpus["vocab"]
    argv = ["--training_config", f"configs/training/{name}.yaml",
            "--device", "cpu", "--max_steps", "2"]
    argv += _data_overrides(corpus, tmp_path)
    for ov in ("encoder.config.input_dim=32", "encoder.config.ffn_dim=64",
               "encoder.config.num_layers=1", "encoder.config.output_dim=32",
               "predictor.config.output_dim=32",
               "predictor.config.symbol_embedding_dim=24",
               "predictor.config.lstm_hidden_dim=20",
               f"predictor.config.num_symbols={v}", "joiner.input_dim=32",
               "joiner.inner_dim=16", f"joiner.output_dim={v}"):
        argv += ["--override", ov]
    if hybrid:
        argv += ["--override", "decoder.config.input_dim=32",
                 "--override", f"decoder.config.num_classes={v}"]
    trainer = build_task.main(argv)
    assert type(trainer.task) is task_cls and trainer.clip == 5.0
    assert isinstance(trainer.task.model.decoder, head)
    assert isinstance(trainer.task.model.predictor, LstmPredictor)
    lines = metrics_lines(trainer.workdir)
    assert [r["step"] for r in lines] == [1, 2]
    keys = ["loss", "grad_norm"] + (["rnnt_loss", "ctc_loss"] if hybrid
                                    else [])
    assert all(np.isfinite(r[k]) for r in lines for k in keys)
    want = {"val_loss", "wer"} | ({"val_rnnt_loss", "val_ctc_loss"}
                                  if hybrid else set())
    assert set(trainer.last_eval) == want
    assert os.path.exists(trainer.ckpt.path(2))


HELDOUT_TINY = (
    "encoder.config.downsampling_factor=[1,2]",
    "encoder.config.num_encoder_layers=[1,1]",
    "encoder.config.feedforward_dim=[64,64]",
    "encoder.config.encoder_dim=[32,64]",
    "encoder.config.encoder_unmasked_dim=[24,24]",
    "encoder.config.num_heads=[2,2]",
    "encoder.config.cnn_module_kernel=[7,7]",
    "encoder.config.query_head_dim=8", "encoder.config.value_head_dim=8",
    "encoder.config.pos_dim=16",
    "encoder.config.chunk_size=[8,-1]",
    "encoder.config.left_context_frames=[32,-1]",
    "predictor.config.output_dim=64",
    "predictor.config.symbol_embedding_dim=64",
    "joiner.input_dim=64")


def heldout_argv(corpus, tmp_path, steps=2):
    v = corpus["vocab"]
    argv = ["--training_config", "configs/training/zipformer_heldout.yaml",
            "--device", "cpu", "--max_steps", str(steps)]
    argv += _data_overrides(corpus, tmp_path)
    for ov in HELDOUT_TINY + (f"predictor.config.num_symbols={v}",
                              f"joiner.output_dim={v}"):
        argv += ["--override", ov]
    return argv


def test_build_task_heldout_yaml(corpus, tmp_path):
    trainer = build_task.main(heldout_argv(corpus, tmp_path))
    task = trainer.task
    assert type(task) is PrunedRnntTask
    enc = task.model.encoder
    assert enc.config.dynamics and enc.config.dtype == "bfloat16"
    assert trainer.max_rss_gb == 100.0 and trainer.rss_restart
    assert isinstance(trainer.optimizer, MultiOptimizer)
    assert sorted(trainer.optimizer.optimizers) == ["default", "joiner",
                                                    "predictor"]
    lines = metrics_lines(trainer.workdir)
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r[k]) for r in lines
               for k in ("loss", "simple_loss", "pruned_loss", "grad_norm"))
    assert {"val_loss", "wer"} <= set(trainer.last_eval)
    state = trainer.ckpt.restore(2)
    assert sorted(state["optimizer"]) == ["default", "joiner", "predictor"]


def test_rss_watchdog_exec_restarts_and_resumes(corpus, tmp_path):
    argv = heldout_argv(corpus, tmp_path, steps=3)
    argv += ["--override", "trainer.max_rss_gb=0.001",
             "--override", "trainer.val_check_interval=100",
             "--override", "task.name=watchdog"]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "speech2text_torch.build_task"] + argv,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = proc.stdout + proc.stderr
    # a checkpoint and an exec-restart after each of the three steps; the
    # last process finds step 3 = max_steps and ends
    assert log.count("exec-restarting") == 3, log[-3000:]
    assert log.count("restoring checkpoint step") == 3
    workdir = tmp_path / "watchdog"
    lines = metrics_lines(str(workdir))
    assert [r["step"] for r in lines] == [1, 2, 3]
    mgr = tckpt.CheckpointManager(str(workdir / "checkpoints"))
    assert mgr.latest_step() == 3
    # the third step ran in a process resumed at step 2 and left the
    # optimizers at three steps
    opt = mgr.restore(3)["optimizer"]
    assert all(o["step_count"] == 3 for o in opt.values())


def test_rss_watchdog_stops_without_restart(corpus, tmp_path):
    """`rss_restart: false`: the first check over the limit checkpoints
    that step and ends the run there, in the same process."""
    argv = heldout_argv(corpus, tmp_path, steps=3)
    argv += ["--override", "trainer.max_rss_gb=0.001",
             "--override", "trainer.rss_restart=false",
             "--override", "trainer.val_check_interval=100"]
    trainer = build_task.main(argv)
    assert not trainer.rss_restart
    assert [h["step"] for h in trainer.history] == [1]
    assert [r["step"] for r in metrics_lines(trainer.workdir)] == [1]
    assert trainer.ckpt.latest_step() == 1
