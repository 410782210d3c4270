"""Shared fixtures of the Conformer family's port tests
(tests/test_torch_ctc_task.py, tests/test_torch_conformer_inference.py,
tests/test_torch_rnnt_family.py, tests/test_torch_rnnt_family_inference.py,
tests/test_torch_cif.py, tests/test_torch_ssl.py, tests/test_torch_nnlm.py):
a synthetic corpus with its subword model, the training configs of a
tiny CTC, a tiny pruned RNN-T + CTC, a tiny RNN-T, a tiny CTC + RNN-T
hybrid Conformer (LSTM predictor, full lattice), a tiny CIF, a tiny
BEST-RQ SSL and a tiny RNN-LM on it, and the build_task overrides that
shrink a Conformer YAML to those dims; conformer_bestrq_xl.yaml cut to
tiny widths with no manifests (tests/test_torch_conformer_bestrq.py,
tests/test_torch_tracing.py)."""

import json
import os

from speech2text_torch.config import load_config
from speech2text_torch.data.manifest import iter_text, load_manifest
from speech2text_torch.data.spm import train_unigram
from speech2text_torch.data.tokenizer import TokenizerSetup
from speech2text_torch.tools.synth_corpus import write_corpus

D = 32
ENCODER = {"model": "Conformer", "config": {
    "feats_dim": 80, "subsampling_rate": 4, "input_dim": D, "num_heads": 4,
    "ffn_dim": 64, "num_layers": 1, "depthwise_conv_kernel_size": 7,
    "output_dim": D, "dropout": 0.0}}


def make_corpus(out):
    """The corpus under `out` (a path) and its subword model: the
    manifests' paths by dataset key, "spm_model" and "vocab"."""
    paths = write_corpus(str(out), seed=21, n_train=16, n_eval=8, n_noise=2,
                         train_seconds=(1.0, 2.0), eval_seconds=(1.0, 2.5),
                         noise_seconds=(0.5, 1.5))
    model = train_unigram(iter_text(load_manifest(paths["train_data"])),
                          vocab_size=48)
    paths["spm_model"] = str(out / "tokenizer.model")
    model.save(paths["spm_model"])
    paths["vocab"] = len(TokenizerSetup(
        {"type": "subword", "config": {"spm_model": paths["spm_model"]}}))
    return paths


def dataset_config(corpus):
    return {"train_data": corpus["train_data"],
            "eval_data": corpus["eval_data"],
            "noise_data": corpus["noise_data"],
            "dur_min_filter": 0.1, "dur_max_filter": 60.0, "batch_size": 4,
            "use_bucket_sampler": True,
            "bucket_sampler_config": {"num_bucket": 1, "min_batch_size": 3,
                                      "volume_threshold": 6.0},
            "feat_type": "lhotes_fbank",
            "feat_config": {"num_mel_bins": 80, "snip_edges": True},
            "data_aug_config": {"use_speed_perturb": True}}


def ctc_config(corpus, workdir):
    return {
        "task": {"type": "CTC", "name": os.path.basename(workdir),
                 "export_path": os.path.dirname(workdir)},
        "tokenizer": {"type": "subword",
                      "config": {"spm_model": corpus["spm_model"]}},
        "dataset": dataset_config(corpus),
        "encoder": ENCODER,
        "decoder": {"model": "Projector", "config": {
            "input_dim": D, "num_classes": corpus["vocab"],
            "dropout_p": 0.0}},
        "loss": {"model": "CTC", "config": {"blank_label": 0,
                                            "reduction": "mean",
                                            "zero_infinity": True}},
        "metric": {"decode_method": "ctc_greedy_search"},
        "optim_setup": {"optimizer": {"type": "AdamW",
                                      "config": {"lr": 0.001}},
                        "lr_scheduler": {"type": "Warmup",
                                         "config": {"warmup_steps": 500}}},
        "trainer": {"mesh": {"data": 1, "model": 1}, "log_interval": 1,
                    "val_check_interval": 1000, "gradient_clip_val": 5.0},
        "callbacks": {"model_chkpt_config": {"monitor": "wer", "mode": "min",
                                             "save_top_k": 2},
                      "global_cmvn": {"apply": False}},
    }


def pruned_config(corpus, workdir):
    vocab = corpus["vocab"]
    cfg = ctc_config(corpus, workdir)
    cfg.update({
        "task": dict(cfg["task"], type="Pruned_Rnnt"),
        "predictor": {"model": "Stateless", "config": {
            "num_symbols": vocab, "output_dim": D,
            "symbol_embedding_dim": 24, "context_size": 2}},
        "joiner": {"input_dim": D, "output_dim": vocab, "prune_range": 3,
                   "use_out_project": False},
        "loss": {"model": "Pruned_Rnnt", "simple_loss_scale": 0.5,
                 "pruned_loss_scale": 0.5, "enable_ctc": True,
                 "ctc_weight": 0.3,
                 "config": {"termination_symbol": 0, "reduction": "mean"}},
        "metric": {"decode_method": "rnnt_greedy_search",
                   "max_token_step": 1},
        "optim_setup": {"optimizer": {"type": "ScaledAdam",
                                      "config": {"lr": 0.045}},
                        "lr_scheduler": {"type": "Eden",
                                         "config": {"lr_batches": 7000}}}})
    return cfg


LSTM = {"model": "Lstm", "config": {
    "output_dim": D, "symbol_embedding_dim": 24, "num_lstm_layers": 2,
    "lstm_hidden_dim": 20}}


def rnnt_config(corpus, workdir, hybrid=False):
    """conformer_rnnt.yaml's recipe (conformer_hybrid_rnnt.yaml's with
    `hybrid`) at tiny dims: LSTM predictor, the full joiner, AdamW +
    Warmup with clipping 5.0."""
    vocab = corpus["vocab"]
    cfg = ctc_config(corpus, workdir)
    cfg.update({
        "task": dict(cfg["task"],
                     type="CTC_Hybrid_Rnnt" if hybrid else "Rnnt"),
        "predictor": {"model": "Lstm", "config": dict(
            LSTM["config"], num_symbols=vocab)},
        "joiner": {"input_dim": D, "output_dim": vocab, "prune_range": -1,
                   "use_out_project": True, "inner_dim": 16},
        "loss": ({"rnnt_weight": 0.75, "ctc_weight": 0.25} if hybrid else
                 {"model": "Rnnt", "config": {"reduction": "mean"}}),
        "metric": {"decode_method": "rnnt_greedy_search",
                   "max_token_step": 1}})
    if not hybrid:
        cfg["decoder"] = {"model": "Identity", "config": {"dummy": -1}}
    return cfg


def cif_config(corpus, workdir, max_tokens=16):
    """conformer_cif.yaml's recipe at tiny dims: the Conformer, CIF of
    `max_tokens` slots, a Projector head, CE with label smoothing 0.1 +
    MAE, AdamW + Warmup with clipping 5.0."""
    cfg = ctc_config(corpus, workdir)
    cfg.update({
        "task": dict(cfg["task"], type="CIF"),
        "cif": {"config": {"input_dim": D, "conv_kernel": 3,
                           "threshold": 1.0, "tail_threshold": 0.5,
                           "max_tokens": max_tokens}},
        "loss": {"model": "MaskedCELoss", "mae_weight": 1.0,
                 "ce_config": {"label_smoothing": 0.1}},
        "metric": {"decode_method": "cif_greedy_search"}})
    return cfg


BEST_RQ = {"stack_size": 4, "num_codebooks": 2, "codebook_size": 16,
           "codebook_dim": 16, "distance": "euclidean",
           "masking": {"mask_proportion": 0.5, "mean_span_length": 2,
                       "span_distribution": "static"}}


def ssl_config(corpus, workdir):
    """conformer_ssl.yaml's recipe at tiny dims: the Conformer, BEST-RQ
    with 2 codebooks of 16, masked CE, acc monitored."""
    cfg = ctc_config(corpus, workdir)
    cfg.pop("decoder")
    cfg.update({
        "task": dict(cfg["task"], type="SSL"),
        "tokenizer": {"type": "char", "config": {}},
        "ssl": {"best_rq": dict(BEST_RQ)},
        "loss": {"model": "MaskedCELoss", "config": {},
                 "loss_selection": "mask_loss"},
        "metric": {"top_k": 1},
        "callbacks": dict(cfg["callbacks"], model_chkpt_config={
            "monitor": "acc", "mode": "max", "save_top_k": 2})})
    return cfg


LM_DIMS = {"embedding_dim": 16, "hidden_dim": 24, "num_layers": 2}


def lm_config(corpus, workdir):
    """rnn_lm.yaml's recipe at tiny dims on the corpus's transcripts."""
    return {
        "task": {"type": "NNLM", "name": os.path.basename(workdir),
                 "export_path": os.path.dirname(workdir)},
        "tokenizer": {"type": "subword",
                      "config": {"spm_model": corpus["spm_model"]}},
        "dataset": {"train_data": corpus["train_data"],
                    "eval_data": corpus["eval_data"], "batch_size": 4},
        "lm": {"config": dict(LM_DIMS)},
        "loss": {"model": "MaskedKLDiv", "config": {"label_smoothing": 0.1}},
        "metric": {"top_k": 1},
        "optim_setup": {"optimizer": {"type": "AdamW",
                                      "config": {"lr": 0.001}},
                        "lr_scheduler": {"type": "Warmup",
                                         "config": {"warmup_steps": 500}}},
        "trainer": {"mesh": {"data": 1, "model": 1}, "log_interval": 1,
                    "val_check_interval": 1000, "gradient_clip_val": 5.0},
        "callbacks": {"model_chkpt_config": {"monitor": "acc", "mode": "max",
                                             "save_top_k": 2},
                      "global_cmvn": {"apply": False}},
    }


BESTRQ_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "training",
    "conformer_bestrq_xl.yaml")


def bestrq_config(clip=5.0):
    """conformer_bestrq_xl.yaml with no manifests and no speed
    perturbation: 2 blocks of width 64, 4 heads, 2 codebooks of 32 × 8,
    spans of 2 label frames, in f32, the full lr from the first step
    (Warmup of 1 step), global-norm clip `clip`."""
    cfg = load_config(BESTRQ_YAML)
    ds = cfg["dataset"]
    for key in ("train_data", "eval_data", "noise_data", "base_dir"):
        ds.pop(key)
    ds["data_aug_config"]["use_speed_perturb"] = False
    ds["bucket_sampler_config"].update(
        {"num_bucket": 2, "volume_threshold": 4.0, "min_batch_size": 2})
    cfg["encoder"]["config"].update(
        {"input_dim": 64, "num_heads": 4, "ffn_dim": 128, "num_layers": 2,
         "output_dim": 64, "dtype": "float32"})
    cfg["ssl"]["best_rq"].update(
        {"num_codebooks": 2, "codebook_size": 32, "codebook_dim": 8})
    cfg["ssl"]["best_rq"]["masking"]["mean_span_length"] = 2
    cfg["optim_setup"]["lr_scheduler"]["config"]["warmup_steps"] = 1
    cfg["trainer"]["gradient_clip_val"] = clip
    return cfg


def tiny_recipe_argv(yaml_path, corpus, export_path, steps=2):
    """build_task's argv for a Conformer recipe YAML on the corpus: tiny
    encoder dims, one bucket, an evaluation and a checkpoint at the last
    step, a metrics line every step."""
    argv = ["--training_config", yaml_path, "--device", "cpu",
            "--max_steps", str(steps),
            "--override", f"task.export_path={export_path}",
            "--override", "trainer.val_check_interval=" + str(steps),
            "--override", "trainer.log_interval=1",
            "--override", "dataset.bucket_sampler_config.num_bucket=1",
            "--override", "dataset.bucket_sampler_config.volume_threshold=6",
            "--override", "dataset.bucket_sampler_config.min_batch_size=3",
            "--override", "dataset.batch_size=4",
            "--override", "dataset.dur_max_filter=60.0",
            "--override", f"encoder.config.input_dim={D}",
            "--override", "encoder.config.ffn_dim=64",
            "--override", "encoder.config.num_layers=1",
            "--override", "encoder.config.depthwise_conv_kernel_size=7",
            "--override", f"encoder.config.output_dim={D}"]
    for key in ("train_data", "eval_data", "noise_data"):
        argv += ["--override", f"dataset.{key}={corpus[key]}"]
    return argv


def metrics_lines(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]
