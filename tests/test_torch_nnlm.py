"""The NNLM task family of the port (data/dataset.py:LmPipeline, the
masked losses of losses.py, metrics.masked_topk_accuracy,
tasks/nnlm.py:NnLmTask, the Trainer without audio) against the JAX
package's, on the CPU. Tolerances: f32 rtol 1e-5 / atol 1e-6 for values,
1e-4 for gradients (rtol, and atol of each tensor's largest entry);
batches and accuracies exact.

- LmPipeline: train batches across an epoch boundary, the eval epoch with
  its topped-up last batch, a resume by `skip_batches`, two shards;
- MaskedCELoss (with and without label smoothing, a (B, T) mask and a
  vector of lengths), MaskedKLDiv and MaeLoss (normalized or not):
  values and gradients; masked_topk_accuracy with equal logits at k = 1
  and k = 2;
- NnLmTask: loss, acc, frames and gradients against JAX's loss_fn; three
  Trainer steps and an evaluation against JAX's Trainer from the same
  weights, a bitwise resume; its checkpoint, kept by acc, loaded by the
  shallow fusion of tasks/rnnt.py:load_fusion_lm;
- build_task's main on rnn_lm.yaml and rnn_lm_heldout.yaml at tiny dims;
  the task factory takes all seven task types of the JAX package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_torch import build_task
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.data.dataset import LmPipeline
from speech2text_torch.data.tokenizer import TokenizerSetup
from speech2text_torch.losses import Loss
from speech2text_torch.metrics import masked_topk_accuracy
from speech2text_torch.tasks.factory import TASKS, TaskFactory
from speech2text_torch.tasks.nnlm import NnLmTask
from speech2text_torch.tasks.rnnt import load_fusion_lm
from speech2text_torch.train.loop import Trainer

from conformer_task_util import LM_DIMS, lm_config, make_corpus, \
    metrics_lines

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD = 1e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


def _t(x):
    return torch.from_numpy(np.array(x))


def _tokenizers(corpus):
    from speech2text_tpu.data.tokenizer import TokenizerSetup as JSetup
    cfg = {"type": "subword", "config": {"spm_model": corpus["spm_model"]}}
    return TokenizerSetup(cfg), JSetup(cfg)


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"text", "text_length"}
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def _take(pipe, n):
    out = []
    for batch in pipe:
        out.append(batch)
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("kind", ["train", "eval", "skip", "shards"])
def test_lm_pipeline_identical(corpus, kind):
    """Batches bit for bit: `train` 10 batches (two and a half epochs of
    4), `eval` one epoch whose last batch is topped up with repeats,
    `skip` training resumed at global batch 5, `shards` shard 1 of 2."""
    from speech2text_tpu.data.dataset import LmPipeline as JPipe
    tok, jtok = _tokenizers(corpus)
    path = corpus["train_data" if kind != "eval" else "eval_data"]
    kw = dict(batch_size=3 if kind == "eval" else 4, seed=5,
              training=kind != "eval")
    if kind == "shards":
        kw.update(shard_index=1, num_shards=2)
    pipes = [cls(path, t, **kw) for cls, t in ((LmPipeline, tok),
                                               (JPipe, jtok))]
    assert pipes[0].max_len == pipes[1].max_len
    if kind == "skip":
        for p in pipes:
            p.skip_batches(5)
    if kind == "eval":
        got, want = list(pipes[0]), list(pipes[1])
        assert len(got) == 3 and len(pipes[0].seqs) == 8
    else:
        got, want = _take(pipes[0], 10), _take(pipes[1], 10)
    _same_batches(got, want)
    row = got[0]["text"][0]
    n = got[0]["text_length"][0]
    assert row[0] == row[n - 1] == tok.sos_eos_id and not row[n:].any()


LOSSES = {
    "ce": ({"model": "MaskedCELoss", "config": {}}, "lengths"),
    "ce_smoothed": ({"model": "MaskedCELoss",
                     "config": {"label_smoothing": 0.1}}, "mask"),
    "kl": ({"model": "MaskedKLDiv", "config": {"label_smoothing": 0.1}},
           "mask"),
    "kl_lengths": ({"model": "MaskedKLDiv", "config": {}}, "lengths"),
    "mae": ({"model": "MaeLoss", "config": {}}, None),
    "mae_raw": ({"model": "MaeLoss", "config": {"normalized": False}}, None),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    """Each masked loss and MaeLoss against the JAX factory's: the value
    at TOL, the gradient with respect to the logits (or the predicted
    counts) at GRAD."""
    from speech2text_tpu.losses import Loss as JLoss
    cfg, mask_kind = LOSSES[name]
    rng = np.random.default_rng(sorted(LOSSES).index(name))
    if mask_kind is None:
        x = rng.uniform(0, 30, 6).astype(np.float32)
        other = {"true_token_counts": np.array([0, 1, 5, 12, 30, 7],
                                               np.int32)}
        key = "pred_token_counts"
    else:
        x = rng.standard_normal((3, 7, 11)).astype(np.float32)
        lens = np.array([7, 4, 0], np.int32)
        mask = lens if mask_kind == "lengths" else \
            np.arange(7)[None] < lens[:, None]
        other = {"label": rng.integers(0, 11, (3, 7)).astype(np.int32),
                 "mask": mask}
        key = "logits"
    jl = JLoss(cfg)

    def jfn(v):
        return jl({key: v, **{k: jnp.asarray(a) for k, a in other.items()}})

    want, jg = jax.value_and_grad(jfn)(jnp.asarray(x))
    leaf = _t(x).requires_grad_()
    got = Loss(cfg)({key: leaf, **{k: _t(a) for k, a in other.items()}})
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), rtol=GRAD,
                               atol=GRAD * float(np.abs(jg).max()))
    if mask_kind is not None:
        assert np.asarray(jg)[2].max() == 0.0     # a fully masked row


@pytest.mark.parametrize("k", [1, 2])
def test_masked_topk_accuracy_with_ties(k):
    """Equal logits rank by index (lax.top_k's order): accuracies equal
    JAX's on rows built to tie at the k-th place."""
    from speech2text_tpu.metrics import masked_topk_accuracy as jacc
    logits = np.zeros((2, 4, 5), np.float32)
    logits[0, 0] = [1, 3, 3, 0, 3]       # three-way tie for the top
    logits[0, 1] = [2, 2, 1, 1, 0]
    logits[0, 2] = [0, 1, 1, 1, 1]
    logits[0, 3] = [5, 0, 0, 0, 0]
    logits[1] = np.random.default_rng(0).standard_normal((4, 5))
    labels = np.array([[2, 1, 1, 0], [4, 3, 2, 1]], np.int32)
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 1]], bool)
    want = float(jacc(jnp.asarray(logits), jnp.asarray(labels),
                      jnp.asarray(mask), k=k))
    got = float(masked_topk_accuracy(_t(logits), _t(labels), _t(mask), k=k))
    assert got == want
    assert 0.0 < got < 1.0


def _task_pair(corpus, workdir):
    from speech2text_tpu.tasks.nnlm import NnLmTask as JTask
    cfg = lm_config(corpus, workdir)
    return NnLmTask(cfg), JTask(cfg), cfg


def test_nnlm_task_matches_jax_loss_fn(corpus, tmp_path):
    """NnLmTask's loss, acc and frames, and every parameter's gradient,
    against JAX's loss_fn on a training batch; eval_forward likewise."""
    task, jtask, _ = _task_pair(corpus, str(tmp_path / "lm"))
    task.model.init_weights(torch.Generator().manual_seed(2))
    params = jax.tree.map(jnp.asarray, to_flax(task.model))
    batch = next(iter(task.make_train_pipeline(seed=3)))
    jbatch = jax.tree.map(jnp.asarray, batch)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jtask.loss_fn(p, jbatch, jax.random.PRNGKey(0), 0),
        has_aux=True))(params)
    got = task.train_losses({k: _t(v) for k, v in batch.items()})
    got["loss"].backward()
    np.testing.assert_allclose(got["loss"].item(), float(loss), **TOL)
    assert float(got["acc"]) == float(metrics["acc"])
    assert int(got["frames"]) == int(metrics["frames"])
    want = flax_to_state_dict(jax.tree.map(np.asarray, grads), task.model)
    for name, p in task.model.named_parameters():
        if not p.requires_grad:         # the LSTM's zero input bias
            continue
        g = want[name]
        assert g.abs().max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=GRAD,
                                   atol=GRAD * float(g.abs().max()),
                                   err_msg=name)
    jout = jax.jit(jtask.eval_forward)(params, jbatch)
    out = task.eval_forward({k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(out["val_loss"]),
                               float(jout["val_loss"]), **TOL)
    assert float(out["acc"]) == float(jout["acc"])


def test_nnlm_trainer_matches_jax_trainer(corpus, tmp_path):
    """Three Trainer steps and an evaluation against JAX's Trainer from
    the same weights (AdamW + Warmup, clipping at 5.0): the logged loss,
    acc and grad_norm, the loop's counters (rows, tokens), val_loss and
    acc; a resumed Trainer restores step 3 bitwise; the checkpoint, kept
    by acc, loads into load_fusion_lm."""
    from speech2text_tpu.parallel.mesh import MeshConfig, make_mesh
    from speech2text_tpu.train.loop import Trainer as JTrainer
    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    task, jtask, tcfg = _task_pair(corpus, tdir)
    jcfg = lm_config(corpus, jdir)
    trainer = Trainer(task, tcfg, tdir, seed=7, device="cpu")
    assert not hasattr(task, "frontend") and trainer.clip == 5.0
    start = jax.tree.map(jnp.asarray, to_flax(task.model))
    got_eval = trainer.fit(max_steps=3)
    trainer.close()
    mesh = make_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    jtrainer = JTrainer(jtask, jcfg, jdir, seed=7, mesh=mesh)
    want_eval = jtrainer.fit(finetune_params=start, max_steps=3)

    got, want = metrics_lines(tdir), metrics_lines(jdir)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert set(w) <= set(g)
        np.testing.assert_allclose([g["loss"], g["train_loss"]],
                                   [w["loss"], w["train_loss"]], **TOL)
        assert g["acc"] == pytest.approx(w["acc"], abs=1e-7)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=GRAD)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
        # the counters' ratio: tokens per row, the same in both loops
        assert g["frames_per_sec"] / g["utts_per_sec"] == pytest.approx(
            w["frames_per_sec"] / w["utts_per_sec"], rel=1e-6)
    assert set(got_eval) == set(want_eval) == {"val_loss", "acc"}
    assert got_eval["val_loss"] == pytest.approx(want_eval["val_loss"],
                                                 rel=1e-5)
    assert got_eval["acc"] == pytest.approx(want_eval["acc"], abs=1e-7)

    state = trainer.ckpt.restore(3)
    again = Trainer(NnLmTask(tcfg), tcfg, tdir, seed=7, device="cpu")
    assert again.init_state() == 3
    live = again.optimizer.state_dict()
    assert all(torch.equal(a, b) for k in ("mu", "nu")
               for a, b in zip(state["optimizer"][k], live[k]))
    again.close()
    assert (trainer.ckpt.monitor, trainer.ckpt.mode) == ("acc", "max")
    lm, weight = load_fusion_lm(
        {"lm_fusion": {"checkpoint_dir": trainer.ckpt.directory,
                       "lm_config": dict(LM_DIMS)}},
        len(task.tokenizer), len(task.tokenizer))
    assert weight == 0.3
    assert all(torch.equal(v, state["model"][k])
               for k, v in lm.state_dict().items())


@pytest.mark.parametrize("name", ["rnn_lm", "rnn_lm_heldout"])
def test_build_task_lm_yaml(corpus, tmp_path, name):
    """build_task's main on the LM YAML at tiny dims on the corpus's
    transcripts: two steps with acc, an evaluation with val_loss and acc,
    a checkpoint."""
    argv = ["--training_config", f"configs/training/{name}.yaml",
            "--device", "cpu", "--max_steps", "2",
            "--override", f"task.export_path={tmp_path}",
            "--override", f"tokenizer.config.spm_model={corpus['spm_model']}",
            "--override", "tokenizer.apply_train=false",
            "--override", "trainer.val_check_interval=2",
            "--override", "trainer.log_interval=1",
            "--override", "dataset.batch_size=4",
            "--override", f"dataset.train_data={corpus['train_data']}",
            "--override", f"dataset.eval_data={corpus['eval_data']}"]
    for key, value in LM_DIMS.items():
        argv += ["--override", f"lm.config.{key}={value}"]
    trainer = build_task.main(argv)
    assert isinstance(trainer.task, NnLmTask) and trainer.clip == 5.0
    # every task type of the JAX package's factory is ported
    assert set(TASKS) == {"CTC", "Rnnt", "CTC_Hybrid_Rnnt", "Pruned_Rnnt",
                          "SSL", "CIF", "NNLM"}
    with pytest.raises(ValueError):
        TaskFactory("Nope")
    lines = metrics_lines(trainer.workdir)
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite([r["loss"], r["acc"], r["grad_norm"],
                            r["frames_per_sec"]]).all() for r in lines)
    assert set(trainer.last_eval) == {"val_loss", "acc"}
    assert os.path.exists(trainer.ckpt.path(2))
