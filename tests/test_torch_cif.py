"""The CIF task family of the port (speech2text_torch/models/cif.py,
tasks/cif.py, decoding.CifGreedyDecoding, `cif_inference`) against the
JAX package's, on the CPU. Tolerances: f32 rtol 1e-5 / atol 1e-6 for
values, 1e-4 for gradients (rtol, and atol of each tensor's largest
entry); fire counts exact.

The last-fire trap (ROADMAP §C, reference caveat 6): in training the
weights are rescaled so that Σα = U, so the U-th fire happens when the
rounded running sum reaches the threshold, and XLA and torch round Σα
differently. Where the two packages' counts differ, the tests print the
utterance, require that the counts differ by one, that the one with
fewer fires ends with its accumulator within 1e-5 of the threshold (it
stopped a rounding error short of the U-th fire), and compare every
other slot and every other utterance at the tolerances above.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from speech2text_torch import build_task
from speech2text_torch import inference as tinf
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.decoding import CifGreedyDecoding, build_decoding
from speech2text_torch.models import cif as tcif
from speech2text_torch.models.layers import init_parameters
from speech2text_torch.tasks.cif import CifModel, CifTask
from speech2text_torch.train import checkpoint as tckpt

from conformer_task_util import cif_config, make_corpus, metrics_lines, \
    tiny_recipe_argv

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD = 1e-4            # gradients: rtol, and atol of each tensor's max
EDGE = 1e-5            # a missed last fire: accumulator within this of 1
# The layer's embeddings from its own α: each α differs from JAX's in its
# last bits (conv, sigmoid, the rescale by Σα), and the accumulator sums
# 250 of them, so a fire's left/right split drifts by up to ~250 ulps of
# 1, times |h| ≤ 4 (2.4e-5 at most here); given JAX's α the frame loop is
# held to TOL.
DRIFT = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


class _Fires:
    """Records each integrate_and_fire call of a CIF module (JAX's or the
    port's): its α (B, T) and its (embeds, count, accumulator)."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        real = module.integrate_and_fire

        def wrapped(hidden, alphas, *args, **kwargs):
            out = real(hidden, alphas, *args, **kwargs)
            self.calls.append((_np(alphas),) + tuple(_np(o)
                                                     for o in out[:3]))
            return out
        monkeypatch.setattr(module, "integrate_and_fire", wrapped)


def differing_fires(got_count, want_count, got_accum, want_accum,
                    threshold=1.0):
    """The utterances whose counts differ, each checked: one fire apart,
    the one with fewer fires stopped within EDGE of `threshold`."""
    rows = np.flatnonzero(np.asarray(got_count) != np.asarray(want_count))
    for b in rows:
        g, w = int(got_count[b]), int(want_count[b])
        short = got_accum if g < w else want_accum
        print(f"utterance {b}: port {g} fires, JAX {w}; accumulator of "
              f"the shorter {float(short[b])!r}")
        assert abs(g - w) == 1, (b, g, w)
        assert abs(float(short[b]) - threshold) < EDGE, (b, short[b])
    print(f"{len(rows)} of {len(got_count)} utterances differ in count")
    return rows


def check_embeds(got, want, got_count, want_count, tol=TOL):
    """Every slot below both counts at `tol`; the slots past a count are
    0 in that package."""
    got, want = np.asarray(got), np.asarray(want)
    for b in range(got.shape[0]):
        n = min(int(got_count[b]), int(want_count[b]))
        np.testing.assert_allclose(got[b, :n], want[b, :n], **tol,
                                   err_msg=f"utterance {b}")
        assert not got[b, int(got_count[b]):].any()
        assert not want[b, int(want_count[b]):].any()


def _adjacent_alphas():
    """Fires on frames 1 and 2 (one apart) and on 4, then a long tail."""
    a = np.zeros((2, 12), np.float32)
    a[0, :6] = [0.5, 0.6, 0.95, 0.3, 0.8, 0.1]
    a[1, :8] = [0.99, 0.02, 0.99, 0.5, 0.25, 0.25, 0.7, 0.4]
    return a


@pytest.mark.parametrize("case", ["random", "overflow", "adjacent"])
def test_integrate_and_fire_matches_jax(case):
    """Given α: the embeddings at TOL, the counts, accumulators and last
    embeddings; `overflow` emits more than u_cap, `adjacent` fires on
    neighbouring frames."""
    from speech2text_tpu.models.cif import integrate_and_fire as jfire
    rng = np.random.default_rng(["random", "overflow", "adjacent"].index(
        case))
    if case == "adjacent":
        alphas = _adjacent_alphas()
    else:
        hi = 1.0 if case == "overflow" else 0.6
        alphas = rng.uniform(0.0, hi, (4, 40)).astype(np.float32)
    B, T = alphas.shape
    u_cap = 8 if case == "overflow" else 16
    hidden = rng.standard_normal((B, T, 8)).astype(np.float32)
    want = jax.jit(jfire, static_argnums=(2,))(
        jnp.asarray(hidden), jnp.asarray(alphas), u_cap, 1.0)
    got = tcif.integrate_and_fire(_t(hidden), _t(alphas), u_cap, 1.0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if case == "overflow":
        assert (got[1].numpy() == u_cap).all()
    if case == "adjacent":
        assert got[1].tolist() == [3, 4]
    assert got[1].min() > 0
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _layers(D=8, k=3, max_tokens=64, seed=0):
    from speech2text_tpu.models.cif import CifConfig as JCfg
    from speech2text_tpu.models.cif import CifLayer as JLayer
    layer = tcif.CifLayer(tcif.CifConfig(input_dim=D, conv_kernel=k,
                                         max_tokens=max_tokens))
    init_parameters(layer, torch.Generator().manual_seed(seed))
    with torch.no_grad():     # sigmoid weights around 0.2-0.5 per frame
        layer.alpha_proj.bias.fill_(-1.0)
    jlayer = JLayer(JCfg(input_dim=D, conv_kernel=k, max_tokens=max_tokens))
    return layer, jlayer, to_flax(layer)


def _cif_inputs(B, T, D, seed, train):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, T, D)).astype(np.float32)
    lens = rng.integers(int(0.8 * T), T + 1, B).astype(np.int32)
    lens[0] = T
    targets = rng.integers(20, 60, B).astype(np.int32) if train else None
    return hidden, lens, targets


@pytest.mark.parametrize("mode", ["train", "infer"])
def test_cif_layer_matches_jax(mode, monkeypatch):
    """CifLayer at B=64, T=250 (U from 20 to 59 in training): the
    predicted counts at TOL, the fire counts equal but for last-fire
    utterances (shown and bounded), the embeddings of every other slot at
    TOL. In inference the residual's tail fire is compared too."""
    from speech2text_tpu.models import cif as jcif
    train = mode == "train"
    layer, jlayer, params = _layers()
    hidden, lens, targets = _cif_inputs(64, 250, 8, 5, train)
    jfires = _Fires(monkeypatch, jcif)
    tfires = _Fires(monkeypatch, tcif)
    args = (jnp.asarray(hidden), jnp.asarray(lens)) + (
        (jnp.asarray(targets),) if train else ())
    want = jlayer.apply({"params": params}, *args)
    with torch.no_grad():
        got = layer(_t(hidden), _t(lens), _t(targets) if train else None)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    (j_alpha, j_emb, j_count, j_acc), = jfires.calls
    (t_alpha, _, _, t_acc), = tfires.calls
    np.testing.assert_allclose(t_alpha, j_alpha, **TOL)
    # the frame loop on JAX's α gives JAX's fires exactly
    same = tcif.integrate_and_fire(_t(hidden), _t(j_alpha), 64, 1.0)
    np.testing.assert_array_equal(same[1].numpy(), j_count)
    np.testing.assert_allclose(same[0].numpy(), j_emb, **TOL)
    np.testing.assert_allclose(same[2].numpy(), j_acc, **TOL)
    rows = differing_fires(got[2].numpy(), np.asarray(want[2]), t_acc, j_acc)
    if not train:
        assert len(rows) == 0      # Σα is summed in frame order in both
        assert got[2].min() > 0
    else:
        # the trap: some utterances fire U − 1 times in either package
        short = (got[2].numpy() < targets).sum()
        print(f"the port fired U - 1 times on {short} of 64 utterances")
        assert ((got[2].numpy() == targets) |
                (got[2].numpy() == targets - 1)).all()
    check_embeds(got[0].numpy(), want[0], got[2].numpy(), np.asarray(want[2]),
                 DRIFT)


def test_cif_gradients_match_jax():
    """Training-mode gradients with respect to the encoder output and the
    α predictor's parameters, of Σ w·embeds over the slots below U − 1
    (the last slot is the rounding coin flip) + Σ v·Σα, against
    jax.grad."""
    layer, jlayer, params = _layers(max_tokens=48, seed=1)
    hidden, lens, targets = _cif_inputs(6, 120, 8, 9, True)
    targets = np.minimum(targets, 40)
    rng = np.random.default_rng(2)
    w = rng.standard_normal((6, 48, 8)).astype(np.float32)
    w[np.arange(48)[None, :] >= targets[:, None] - 1] = 0.0
    v = rng.standard_normal(6).astype(np.float32)

    def jloss(p, h):
        emb, pred, _ = jlayer.apply({"params": p}, h, jnp.asarray(lens),
                                    jnp.asarray(targets))
        return jnp.sum(emb * w) + jnp.sum(pred * v)

    jg_p, jg_h = jax.grad(jloss, argnums=(0, 1))(params,
                                                 jnp.asarray(hidden))
    h = _t(hidden).requires_grad_()
    emb, pred, _ = layer(h, _t(lens), _t(targets))
    ((emb * _t(w)).sum() + (pred * _t(v)).sum()).backward()
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jg_h), rtol=GRAD,
                               atol=GRAD * float(np.abs(jg_h).max()))
    want = flax_to_state_dict(jax.tree.map(np.asarray, jg_p), layer)
    named = dict(layer.named_parameters())
    assert set(want) == set(named)
    for k, g in want.items():
        assert g.abs().max() > 0, k
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                   rtol=GRAD, atol=GRAD * float(
                                       g.abs().max()), err_msg=k)


def _batch(task, seed):
    it = iter(task.make_train_pipeline(seed=seed))
    batch = next(it)
    it.close()
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def test_cif_task_matches_jax_loss_fn(corpus, tmp_path, monkeypatch):
    """The CifTask training losses and evaluation against JAX's loss_fn
    and eval_forward on a training batch of 8 featurized by JAX with its
    augmentation draws (add_noise, mix_feats, SpecAugment; the same
    features fed to both): mae_loss and frames at TOL; the utterances
    whose fire counts differ are shown and bounded, and the CE (each
    package's loss on its own logits) is compared over the other
    utterances; with no such utterance, ce_loss, the loss and val_loss
    too. The evaluation's free pass: log-probs, token counts and
    hypotheses."""
    from speech2text_tpu.models import cif as jcif
    from speech2text_tpu.tasks.cif import CifTask as JTask
    cfg = cif_config(corpus, str(tmp_path / "cif"))
    cfg["dataset"]["bucket_sampler_config"].update(min_batch_size=8,
                                                   volume_threshold=16.0)
    cfg["dataset"]["data_aug_config"] = {
        "use_speed_perturb": True, "use_spec_aug": True,
        "use_add_noise": True, "add_noise_proportion": 0.5,
        "use_mix_feats": True, "mix_feats_proportion": 0.5}
    task = CifTask(cfg)
    task.model.init_weights(torch.Generator().manual_seed(4))
    params = jax.tree.map(jnp.asarray, to_flax(task.model))
    jtask = JTask(cfg)
    batch = _batch(task, 3)
    assert batch["label"].shape[0] == 8
    jbatch = jax.tree.map(jnp.asarray, batch)
    tbatch = {k: _t(v) for k, v in batch.items()}
    feats, feat_lens = jtask.featurize(jbatch, jax.random.PRNGKey(11),
                                       training=True)
    monkeypatch.setattr(jtask, "featurize",
                        lambda b, k, training: (feats, feat_lens))
    monkeypatch.setattr(task, "featurize",
                        lambda b, training: (tfeats, tlens))
    tfeats, tlens = _t(feats), _t(feat_lens)

    loss, metrics = jax.jit(jtask.loss_fn)(params, jbatch,
                                           jax.random.PRNGKey(0), 0)
    jout = jax.jit(jtask.eval_forward)(params, jbatch)
    jfires = _Fires(monkeypatch, jcif)
    tfires = _Fires(monkeypatch, tcif)
    want_out = jtask.model.apply({"params": params}, feats, feat_lens,
                                 jbatch["label_length"])
    got = task.train_losses(tfeats, tlens, tbatch, None)
    with torch.no_grad():
        got_out = task.model(tfeats, tlens, tbatch["label_length"])
    np.testing.assert_allclose(got_out["pred_counts"].numpy(),
                               np.asarray(want_out["pred_counts"]), **TOL)
    np.testing.assert_allclose(got["mae_loss"].item(),
                               float(metrics["mae_loss"]), **TOL)
    assert int(got["frames"]) == int(metrics["frames"])
    rows = differing_fires(got_out["emit_counts"].numpy(),
                           np.asarray(want_out["emit_counts"]),
                           tfires.calls[0][3], jfires.calls[0][3])
    L = min(batch["label"].shape[1], got_out["logits"].shape[1])
    keep = np.ones(8, bool)
    keep[rows] = False
    mask = np.where(keep, np.minimum(batch["label_length"], L), 0)
    ce = {pkg: float(t.ce_loss({"logits": out["logits"][:, :L],
                                "label": b["label"][:, :L], "mask": m}))
          for pkg, t, out, b, m in (
              ("torch", task, got_out, tbatch, _t(mask)),
              ("jax", jtask, want_out, jbatch, jnp.asarray(mask)))}
    np.testing.assert_allclose(ce["torch"], ce["jax"], **TOL)
    if len(rows) == 0:
        np.testing.assert_allclose(got["ce_loss"].item(),
                                   float(metrics["ce_loss"]), **TOL)
        np.testing.assert_allclose(got["loss"].item(), float(loss), **TOL)

    # evaluation: the free pass (tail fire) and the teacher-forced loss
    tout = task.eval_forward(tbatch)
    np.testing.assert_array_equal(tout["token_counts"].numpy(),
                                  np.asarray(jout["token_counts"]))
    np.testing.assert_allclose(tout["log_probs"].numpy(),
                               np.asarray(jout["log_probs"]), rtol=1e-5,
                               atol=1e-5)
    if len(rows) == 0:
        np.testing.assert_allclose(float(tout["val_loss"]),
                                   float(jout["val_loss"]), **TOL)
    assert task.eval_hyps(tout) == jtask.eval_hyps(jout)
    assert int(tout["token_counts"].sum()) > 0


def test_cif_greedy_decoding():
    """The per-position argmax (the first of equal maxima) and the
    counts; the factory builds it for cif_greedy_search."""
    dec = build_decoding({"decode_method": "cif_greedy_search"})
    assert isinstance(dec, CifGreedyDecoding)
    lp = torch.tensor([[[0.0, 1.0, 1.0], [2.0, 0.0, 2.0]]])
    tokens, counts = dec.decode(lp, torch.tensor([1]))
    assert tokens.tolist() == [[1, 0]] and counts.tolist() == [1]
    assert tokens.dtype == counts.dtype == torch.int32


CKPT_STEPS = {1: 0.5, 2: 0.3}             # step → wer


def test_cif_inference_report_equals_jax(corpus, tmp_path, monkeypatch):
    """configs/inference/cif_greedy_search.yaml through both inference
    entries on the same averaged checkpoints of a tiny CIF model:
    test_report.txt equal byte for byte."""
    import inference as jinf
    from speech2text_tpu.parallel import mesh as jmesh
    from speech2text_tpu.train.checkpoint import CheckpointManager as JCkpt
    cfg = cif_config(corpus, str(tmp_path / "tasks" / "tiny"))
    train_yaml = tmp_path / "train.yaml"
    train_yaml.write_text(yaml.safe_dump(cfg))
    model = CifModel.from_config(cfg)
    dirs = {"jax": str(tmp_path / "jax_ckpt"),
            "torch": str(tmp_path / "torch_ckpt")}
    jmgr, tmgr = JCkpt(dirs["jax"]), tckpt.CheckpointManager(dirs["torch"])
    for step, wer in CKPT_STEPS.items():
        model.init_weights(torch.Generator().manual_seed(step))
        with torch.no_grad():     # fire a few tokens per utterance
            model.cif.alpha_proj.bias.fill_(-1.5)
        jmgr.save(step, {"params": to_flax(model)}, {"wer": wer})
        tmgr.save(step, {"model": model.state_dict()}, {"wer": wer})
    one_device = jmesh.make_mesh
    monkeypatch.setattr(jmesh, "make_mesh", lambda config=None, devices=None:
                        one_device(config, devices=jax.devices()[:1]))
    yaml_path = "configs/inference/cif_greedy_search.yaml"
    out = {}
    for pkg in ("jax", "torch"):
        workdir = tmp_path / pkg
        overrides = [f"task.train_config={train_yaml}",
                     f"task.export_path={workdir}",
                     f"task.checkpoints_dir={dirs[pkg]}",
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
            assert type(run["task"]) is CifTask
        out[pkg] = (workdir / "test_report.txt").read_bytes()
    text = out["torch"].decode()
    assert text.count("\nhyp: ") >= 8
    assert any(line[5:] for line in text.splitlines()
               if line.startswith("hyp: "))
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("name", ["conformer_cif", "conformer_cif_heldout"])
def test_build_task_cif_yaml(corpus, tmp_path, name):
    """build_task's main on the CIF YAML at tiny dims on the corpus: two
    steps with ce_loss and mae_loss, an evaluation with val_loss and
    WER, a checkpoint."""
    argv = tiny_recipe_argv(f"configs/training/{name}.yaml", corpus,
                            str(tmp_path)) + [
        "--override", f"tokenizer.config.spm_model={corpus['spm_model']}",
        "--override", "tokenizer.apply_train=false",
        "--override", "cif.config.input_dim=32",
        "--override", "decoder.config.input_dim=32",
        "--override", f"decoder.config.num_classes={corpus['vocab']}"]
    trainer = build_task.main(argv)
    assert isinstance(trainer.task, CifTask) and trainer.clip == 5.0
    assert trainer.task.model.cif.config.max_tokens == 128
    lines = metrics_lines(trainer.workdir)
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite([r["loss"], r["ce_loss"], r["mae_loss"],
                            r["grad_norm"]]).all() for r in lines)
    assert set(trainer.last_eval) == {"val_loss", "wer"}
    assert os.path.exists(trainer.ckpt.path(2))
