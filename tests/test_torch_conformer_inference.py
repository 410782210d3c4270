"""The Conformer family's inference YAMLs and training entry in the port
against the JAX package's, on a synthetic corpus written to tmp_path, on
the CPU:

- configs/inference/ctc_greedy_search.yaml, ctc_beam_search.yaml (beam
  8), ctc_beam_search.yaml with `ctc_lexicon_beam_search` (the C++
  runtime's lexicon beam over the corpus's words and a synthetic ARPA LM;
  JAX's binding loads the library the port builds) and
  pruned_rnnt_ctc_greedy_search.yaml through both inference entries, on a
  tiny CTC and a tiny pruned RNN-T + CTC Conformer
  (tests/test_torch_ctc_task.py's configs) with the same averaged
  checkpoints in each package's format: `test_report.txt` equal byte for
  byte;
- build_task's main on configs/training/conformer_ctc.yaml,
  conformer_stateless_pruned_rnnt.yaml (Identity head, no CTC branch)
  and conformer_pruned_rnnt.yaml (Projector head, CTC branch) with the
  corpus and tiny dims given by --override: two steps, an evaluation, a
  checkpoint.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from speech2text_torch import build_task
from speech2text_torch import inference as tinf
from speech2text_torch.convert import to_flax
from speech2text_torch.tasks.ctc import CtcModel, CtcTask
from speech2text_torch.models.decoder import IdentityDecoder, \
    ProjectorDecoder
from speech2text_torch.tasks.rnnt import PrunedRnntTask, RnntModel
from speech2text_torch.train import checkpoint as tckpt

from conformer_task_util import ctc_config, make_corpus, metrics_lines, \
    pruned_config

CKPT_STEPS = {1: 0.5, 2: 0.3}             # step → wer


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


INFER = {
    "ctc_greedy_search": ("configs/inference/ctc_greedy_search.yaml",
                          "ctc"),
    "ctc_beam_search": ("configs/inference/ctc_beam_search.yaml", "ctc"),
    "ctc_lexicon_beam_search": ("configs/inference/ctc_beam_search.yaml",
                                "ctc"),
    "pruned_rnnt_ctc_greedy_search": (
        "configs/inference/pruned_rnnt_ctc_greedy_search.yaml", "pruned"),
}


@pytest.fixture(scope="module")
def lexicon_overrides(corpus, tmp_path_factory):
    """The decoding overrides of the lexicon case: the corpus's words as
    the word list, and a unigram ARPA LM over them."""
    from speech2text_torch.data.manifest import iter_text, load_manifest
    words = sorted({w for text in iter_text(load_manifest(
        corpus["train_data"])) for w in text.split()})
    root = tmp_path_factory.mktemp("lexicon")
    (root / "words.txt").write_text("".join(f"{w}\n" for w in words))
    grams = [f"{-1.0 - 0.01 * i:.2f} {w} -0.1"
             for i, w in enumerate(["<s>", "</s>"] + words)]
    (root / "lm.arpa").write_text(
        f"\\data\\\nngram 1={len(grams)}\n\n\\1-grams:\n"
        + "\n".join(grams) + "\n\n\\end\\\n")
    return ["decoding.type=ctc_lexicon_beam_search",
            f"decoding.config.word_list={root / 'words.txt'}",
            f"decoding.config.arpa_lm={root / 'lm.arpa'}",
            "decoding.config.lm_weight=0.5"]


@pytest.fixture(scope="module")
def checkpoints(corpus, tmp_path_factory):
    """Training YAMLs of the tiny CTC and pruned models, and their
    checkpoints in both packages' formats (the same weights)."""
    from speech2text_tpu.train.checkpoint import CheckpointManager as JCkpt
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for kind, make, build in (("ctc", ctc_config, CtcModel),
                              ("pruned", pruned_config, RnntModel)):
        cfg = make(corpus, str(root / kind / "tasks" / "tiny"))
        path = root / kind / "train.yaml"
        path.parent.mkdir(parents=True)
        path.write_text(yaml.safe_dump(cfg))
        model = build.from_config(cfg)
        dirs = {"jax": str(root / kind / "jax"),
                "torch": str(root / kind / "torch")}
        jmgr = JCkpt(dirs["jax"])
        tmgr = tckpt.CheckpointManager(dirs["torch"])
        for step, wer in CKPT_STEPS.items():
            model.init_weights(torch.Generator().manual_seed(step))
            jmgr.save(step, {"params": to_flax(model)}, {"wer": wer})
            tmgr.save(step, {"model": model.state_dict()}, {"wer": wer})
        out[kind] = {"train": str(path), **dirs}
    return out


@pytest.mark.parametrize("name", sorted(INFER))
def test_inference_report_equals_jax(corpus, checkpoints, name, tmp_path,
                                     monkeypatch, request):
    import inference as jinf
    from speech2text_tpu import runtime_binding as jrb
    from speech2text_tpu.parallel import mesh as jmesh
    from speech2text_torch.runtime_binding import build_library
    yaml_path, kind = INFER[name]
    one_device = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda config=None, devices=None:
                        one_device(config, devices=jax.devices()[:1]))
    extra = []
    if name == "ctc_lexicon_beam_search":
        extra = request.getfixturevalue("lexicon_overrides")
        monkeypatch.setattr(jrb, "_LIB_PATHS", (str(build_library()),))
    out = {}
    for pkg in ("jax", "torch"):
        workdir = tmp_path / pkg
        overrides = [f"task.train_config={checkpoints[kind]['train']}",
                     f"task.export_path={workdir}",
                     f"task.checkpoints_dir={checkpoints[kind][pkg]}",
                     f"testset.test_data={corpus['eval_data']}"] + extra
        if pkg == "jax":
            jinf.FLAGS.unparse_flags()
            jinf.FLAGS(["inference", f"--inference_config={yaml_path}"]
                       + [f"--override={o}" for o in overrides])
            jinf.run_inference([])
        else:
            run = tinf.main(["--inference_config", yaml_path, "--device",
                             "cpu"] + [a for o in overrides
                                       for a in ("--override", o)])
            assert type(run["task"]) is (CtcTask if kind == "ctc"
                                         else PrunedRnntTask)
        out[pkg] = (workdir / "test_report.txt").read_bytes()
    text = out["torch"].decode()
    assert text.count("\nhyp: ") >= 8
    assert text.splitlines()[-1].startswith("corpus wer: ")
    assert out["torch"] == out["jax"]


def test_build_task_conformer_ctc_yaml(corpus, tmp_path):
    argv = ["--training_config", "configs/training/conformer_ctc.yaml",
            "--device", "cpu", "--max_steps", "2",
            "--override", f"task.export_path={tmp_path}",
            "--override", f"tokenizer.config.spm_model={corpus['spm_model']}",
            "--override", "tokenizer.apply_train=false",
            "--override", "trainer.val_check_interval=2",
            "--override", "trainer.log_interval=1",
            "--override", "dataset.bucket_sampler_config.num_bucket=1",
            "--override", "dataset.bucket_sampler_config.volume_threshold=6",
            "--override", "dataset.bucket_sampler_config.min_batch_size=3",
            "--override", "dataset.dur_max_filter=60.0",
            "--override", "encoder.config.input_dim=32",
            "--override", "encoder.config.ffn_dim=64",
            "--override", "encoder.config.num_layers=1",
            "--override", "encoder.config.output_dim=32",
            "--override", "decoder.config.input_dim=32",
            "--override", f"decoder.config.num_classes={corpus['vocab']}"]
    for key in ("train_data", "eval_data", "noise_data"):
        argv += ["--override", f"dataset.{key}={corpus[key]}"]
    trainer = build_task.main(argv)
    assert isinstance(trainer.task, CtcTask) and trainer.clip == 5.0
    lines = metrics_lines(trainer.workdir)
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in lines)
    assert set(trainer.last_eval) == {"val_loss", "wer"}
    assert os.path.exists(trainer.ckpt.path(2))


PRUNED_YAMLS = {
    "conformer_stateless_pruned_rnnt": (IdentityDecoder, False),
    "conformer_pruned_rnnt": (ProjectorDecoder, True),
}


@pytest.mark.parametrize("name", sorted(PRUNED_YAMLS))
def test_build_task_conformer_pruned_yaml(corpus, tmp_path, name):
    head, ctc = PRUNED_YAMLS[name]
    argv = ["--training_config", f"configs/training/{name}.yaml",
            "--device", "cpu", "--max_steps", "2",
            "--override", f"task.export_path={tmp_path}",
            "--override", f"tokenizer.config.spm_model={corpus['spm_model']}",
            "--override", "tokenizer.apply_train=false",
            "--override", "trainer.val_check_interval=2",
            "--override", "trainer.log_interval=1",
            "--override", "dataset.bucket_sampler_config.num_bucket=1",
            "--override", "dataset.bucket_sampler_config.volume_threshold=6",
            "--override", "dataset.bucket_sampler_config.min_batch_size=3",
            "--override", "encoder.config.input_dim=32",
            "--override", "encoder.config.ffn_dim=64",
            "--override", "encoder.config.num_layers=1",
            "--override", "encoder.config.output_dim=32",
            "--override", "predictor.config.output_dim=32",
            "--override", "predictor.config.symbol_embedding_dim=32",
            "--override", f"predictor.config.num_symbols={corpus['vocab']}",
            "--override", "joiner.input_dim=32",
            "--override", f"joiner.output_dim={corpus['vocab']}"]
    if ctc:
        argv += ["--override", "decoder.config.input_dim=32",
                 "--override",
                 f"decoder.config.num_classes={corpus['vocab']}"]
    for key in ("train_data", "eval_data", "noise_data"):
        argv += ["--override", f"dataset.{key}={corpus[key]}"]
    trainer = build_task.main(argv)
    assert isinstance(trainer.task, PrunedRnntTask)
    assert isinstance(trainer.task.model.decoder, head)
    assert trainer.clip is None          # ScaledAdam clips by itself
    lines = metrics_lines(trainer.workdir)
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in lines)
    assert all(("ctc_loss" in r) == ctc for r in lines)
    assert all(np.isfinite(r["ctc_loss"]) for r in lines if ctc)
    assert {"val_loss", "wer"} <= set(trainer.last_eval)
    assert ("val_ctc_loss" in trainer.last_eval) == ctc
    assert os.path.exists(trainer.ckpt.path(2))
