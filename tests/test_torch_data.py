"""The port's host data layer against the JAX package's, bit for bit, on a
synthetic corpus written to tmp_path (speech2text_torch/tools/
synth_corpus.py: tone-plus-noise int16 wavs, transcripts from a fixed
word list): wav reading and speed perturbation, manifests, the unigram
subword trainer (identical pieces and scores, identical ids), both
tokenizers, the subword preprocess, bucket specs, the bucket batcher
(three epochs, resume, two shards) and the ASR pipeline (training with
speed perturbation and noise, eval). Also the WER metrics and the
reference decoder. Every comparison is exact.
"""

import copy
import os

import numpy as np
import pytest

from speech2text_tpu import metrics as jmetrics
from speech2text_tpu.data import audio as jaudio
from speech2text_tpu.data import batcher as jbatcher
from speech2text_tpu.data import dataset as jdataset
from speech2text_tpu.data import manifest as jmanifest
from speech2text_tpu.data import spm as jspm
from speech2text_tpu.data import tokenizer as jtok
from speech2text_tpu.decoding import reference_decoder as j_ref_decoder
from speech2text_tpu.tools.spm_train import \
    spm_training_preprocess as j_spm_preprocess
from speech2text_torch import metrics as tmetrics
from speech2text_torch.data import audio as taudio
from speech2text_torch.data import batcher as tbatcher
from speech2text_torch.data import dataset as tdataset
from speech2text_torch.data import manifest as tmanifest
from speech2text_torch.data import spm as tspm
from speech2text_torch.data import tokenizer as ttok
from speech2text_torch.decoding import reference_decoder as t_ref_decoder
from speech2text_torch.tools.spm_train import \
    spm_training_preprocess as t_spm_preprocess
from speech2text_torch.tools.synth_corpus import write_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("corpus")
    return write_corpus(str(out), seed=5, n_train=40, n_eval=12, n_noise=4,
                        train_seconds=(0.5, 3.0), eval_seconds=(0.5, 3.0),
                        noise_seconds=(0.3, 1.5))


def _texts(path):
    return list(tmanifest.iter_text(tmanifest.load_manifest(path)))


def test_read_wav_and_speed_perturb(corpus):
    path = tmanifest.load_manifest(corpus["train_data"])[0]["audio_filepath"]
    a, sr_a = taudio.read_wav(path)
    b, sr_b = jaudio.read_wav(path)
    assert sr_a == sr_b == 16000
    np.testing.assert_array_equal(a, b)
    for speed in (0.9, 1.0, 1.1, 1.05):
        x, y = taudio.speed_perturb(a, speed), jaudio.speed_perturb(b, speed)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_manifest_filters(corpus):
    for lo, hi in ((0.0, float("inf")), (1.0, 2.5)):
        got = tmanifest.load_manifest(corpus["train_data"], lo, hi)
        want = jmanifest.load_manifest(corpus["train_data"], lo, hi)
        assert got == want
    assert 0 < len(tmanifest.load_manifest(corpus["train_data"], 1.0, 2.5)) \
        < len(tmanifest.load_manifest(corpus["train_data"]))
    assert list(tmanifest.iter_text(got)) == list(jmanifest.iter_text(want))


@pytest.mark.parametrize("vocab_size", [48, 96])
def test_train_unigram_identical(corpus, vocab_size):
    texts = _texts(corpus["train_data"])
    got = tspm.train_unigram(texts, vocab_size=vocab_size)
    want = jspm.train_unigram(texts, vocab_size=vocab_size)
    assert got.pieces == want.pieces
    for t in texts + _texts(corpus["eval_data"]) + ["zzz qq unseen"]:
        assert got.encode_as_pieces(t) == want.encode_as_pieces(t)


def test_tokenizers_identical(corpus, tmp_path):
    texts = _texts(corpus["train_data"])
    model = tspm.train_unigram(texts, vocab_size=64)
    model.save(str(tmp_path / "t.model"), str(tmp_path / "t.vocab"))
    for cfg in ({"type": "char"},
                {"type": "subword",
                 "config": {"spm_model": str(tmp_path / "t.model")}},
                {"type": "subword",
                 "config": {"spm_vocab": str(tmp_path / "t.vocab")}}):
        got = ttok.TokenizerSetup(copy.deepcopy(cfg))
        want = jtok.TokenizerSetup(copy.deepcopy(cfg))
        assert got.labels == want.labels
        assert got.blank_id == 0 and got.sos_eos_id == len(got) - 1
        for t in texts[:10] + ["hello, world!"]:
            ids = got.encode(t)
            np.testing.assert_array_equal(ids, want.encode(t))
            assert ids.dtype == np.int32
            assert got.decode(ids) == want.decode(ids)


def test_spm_training_preprocess_identical(corpus, tmp_path):
    def cfg(root):
        return {"task": {"name": "t", "export_path": str(root)},
                "tokenizer": {"type": "subword", "apply_train": True,
                              "train_config": {"vocab_size": 64},
                              "config": {"spm_model": None}},
                "dataset": {"train_data": corpus["train_data"]}}
    got = t_spm_preprocess(cfg(tmp_path / "torch"))
    want = j_spm_preprocess(cfg(tmp_path / "jax"))
    for key in ("spm_model", "spm_vocab"):
        a = got["tokenizer"]["config"][key]
        b = want["tokenizer"]["config"][key]
        assert a == str(tmp_path / "torch" / "t" / "spm" / os.path.basename(b))
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    skipped = cfg(tmp_path / "resumed")
    skipped["resume"] = "somewhere"
    assert t_spm_preprocess(copy.deepcopy(skipped)) == skipped


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_buckets=3, volume_threshold=20.0, min_batch_size=2),
    dict(num_buckets=4, volume_threshold=0.0, min_batch_size=4,
         max_batch_size=4, speed_perturb_slack=1.0, batch_multiple=2)])
def test_bucket_specs_identical(kw):
    rng = np.random.default_rng(0)
    durs = rng.uniform(0.5, 16.0, 300)
    toks = rng.integers(1, 120, 300)
    assert tbatcher.build_bucket_specs(durs, toks, **kw) == [
        tbatcher.BucketSpec(**vars(s))
        for s in jbatcher.build_bucket_specs(durs, toks, **kw)]


def test_bucket_batcher_identical():
    rng = np.random.default_rng(1)
    durs = rng.uniform(0.5, 10.0, 157)
    toks = rng.integers(1, 60, 157)
    specs = tbatcher.build_bucket_specs(durs, toks, num_buckets=4,
                                        volume_threshold=30.0,
                                        min_batch_size=3)
    jspecs = jbatcher.build_bucket_specs(durs, toks, num_buckets=4,
                                         volume_threshold=30.0,
                                         min_batch_size=3)
    for shard in ((0, 1), (0, 2), (1, 2)):
        got = tbatcher.BucketBatcher(durs, specs, seed=4,
                                     shard_index=shard[0],
                                     num_shards=shard[1])
        want = jbatcher.BucketBatcher(durs, jspecs, seed=4,
                                      shard_index=shard[0],
                                      num_shards=shard[1])
        assert got.batches_per_epoch() == want.batches_per_epoch()
        for epoch in range(3):
            assert got.epoch_batches(epoch) == want.epoch_batches(epoch)
        bpe = got.batches_per_epoch()
        for start in (0, 3, bpe + 1):
            a, b = got.iter_from(start), want.iter_from(start)
            assert [next(a) for _ in range(2 * bpe)] == \
                [next(b) for _ in range(2 * bpe)]


def _data_config(mod, corpus, **kw):
    cfg = dict(train_data=corpus["train_data"], eval_data=corpus["eval_data"],
               noise_data=corpus["noise_data"], dur_min_filter=0.1,
               dur_max_filter=60.0, batch_size=4,
               bucket_sampler_config={"num_bucket": 3, "min_batch_size": 2,
                                      "volume_threshold": 12.0},
               data_aug_config={"use_speed_perturb": True,
                                "use_add_noise": True, "use_mix_feats": True,
                                "use_spec_aug": True})
    cfg.update(kw)
    return mod.DataConfig(**cfg)


def _batches(pipe, n):
    it = iter(pipe)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], list):
                assert g[k] == w[k]
            else:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_asr_pipeline_training_identical(corpus):
    tok = ttok.CharTokenizer()
    got = tdataset.AsrPipeline(corpus["train_data"], tok,
                               _data_config(tdataset, corpus), seed=9)
    want = jdataset.AsrPipeline(corpus["train_data"], jtok.CharTokenizer(),
                                _data_config(jdataset, corpus), seed=9)
    assert got.batches_per_epoch() == want.batches_per_epoch()
    n = got.batches_per_epoch() + 2
    gb, wb = _batches(got, n), _batches(want, n)
    _assert_batches_equal(gb, wb)
    assert all("noise_pcm" in b for b in gb)
    assert len({b["pcm"].shape for b in gb}) > 1
    # speed perturbation changed some lengths away from the wavs'
    durs = {round(e["duration"] * 16000) for e in got.entries}
    assert any(int(x) not in durs for b in gb for x in b["pcm_length"])
    # resume: the batches a fresh pipeline gives from batch 3 on
    got.skip_batches(3)
    want.skip_batches(3)
    _assert_batches_equal(_batches(got, 3), _batches(want, 3))
    _assert_batches_equal(_batches(got, 3), gb[3:6])


def test_asr_pipeline_eval_and_test_identical(corpus):
    cfg_t = _data_config(tdataset, corpus, test_data=corpus["eval_data"])
    cfg_j = _data_config(jdataset, corpus, test_data=corpus["eval_data"])
    got = tdataset.AsrPipeline(corpus["eval_data"], ttok.CharTokenizer(),
                               cfg_t, training=False)
    want = jdataset.AsrPipeline(corpus["eval_data"], jtok.CharTokenizer(),
                                cfg_j, training=False)
    gb, wb = list(got), list(want)
    _assert_batches_equal(gb, wb)
    assert all(b["pcm"].shape[0] == 4 and "noise_pcm" not in b for b in gb)
    got = tdataset.AsrPipeline(corpus["eval_data"], ttok.CharTokenizer(),
                               cfg_t, training=False, keep_text=True)
    want = jdataset.AsrPipeline(corpus["eval_data"], jtok.CharTokenizer(),
                                cfg_j, training=False, keep_text=True)
    _assert_batches_equal(list(got), list(want))


def test_asr_pipeline_two_shards_identical(corpus):
    for shard in (0, 1):
        got = tdataset.AsrPipeline(
            corpus["train_data"], ttok.CharTokenizer(),
            _data_config(tdataset, corpus, data_aug_config={}), seed=2,
            shard_index=shard, num_shards=2)
        want = jdataset.AsrPipeline(
            corpus["train_data"], jtok.CharTokenizer(),
            _data_config(jdataset, corpus, data_aug_config={}), seed=2,
            shard_index=shard, num_shards=2)
        _assert_batches_equal(_batches(got, 4), _batches(want, 4))


def test_noise_pool_identical(corpus):
    got = tdataset.NoisePool(corpus["noise_data"])
    want = jdataset.NoisePool(corpus["noise_data"])
    a = got.sample_batch(np.random.default_rng(3), 7)
    b = want.sample_batch(np.random.default_rng(3), 7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_pipeline_worker_error_reaches_consumer(corpus, tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"audio_filepath": "/nonexistent.wav", "duration": 1.0, '
                   '"text": "a"}\n')
    pipe = tdataset.AsrPipeline(str(bad), ttok.CharTokenizer(),
                                _data_config(tdataset, corpus,
                                             data_aug_config={}))
    with pytest.raises(FileNotFoundError):
        next(iter(pipe))


# ------------------------------------------------------------- metrics
def test_wer_and_metric_identical():
    rng = np.random.default_rng(0)
    words = ["a", "b", "c", "dd", "e"]
    refs = [" ".join(rng.choice(words, rng.integers(0, 8))) for _ in range(40)]
    hyps = [" ".join(rng.choice(words, rng.integers(0, 8))) for _ in range(40)]
    for use_cer in (False, True):
        assert tmetrics.word_error_rate(hyps, refs, use_cer) == \
            jmetrics.word_error_rate(hyps, refs, use_cer)
        assert tmetrics.wer_counts(hyps, refs, use_cer) == \
            jmetrics.wer_counts(hyps, refs, use_cer)
    assert tmetrics.word_error_rate(["x"], [""]) == 1.0
    assert tmetrics.levenshtein("kitten", "sitting") == 3
    mt, mj = tmetrics.AsrMetric(), jmetrics.AsrMetric()
    for i in range(0, 40, 7):
        mt.update(hyps[i:i + 7], refs[i:i + 7])
        mj.update(hyps[i:i + 7], refs[i:i + 7])
    assert mt.compute() == mj.compute() and mt.num_utts == mj.num_utts == 40


def test_reference_decoder_identical(corpus, tmp_path):
    texts = _texts(corpus["train_data"])
    tspm.train_unigram(texts, vocab_size=64).save(str(tmp_path / "m"))
    cfg = {"type": "subword", "config": {"spm_model": str(tmp_path / "m")}}
    tt, jt = ttok.TokenizerSetup(cfg), jtok.TokenizerSetup(cfg)
    ids = [tt.encode(t) for t in texts[:6]]
    U = max(len(i) for i in ids) + 3
    labels = np.zeros((6, U), np.int32)
    lens = np.array([len(i) for i in ids], np.int32)
    for r, i in enumerate(ids):
        labels[r, :len(i)] = i
    got = t_ref_decoder(labels, lens, tt)
    assert got == j_ref_decoder(labels, lens, jt)
    assert got == [" ".join(t.split()) for t in texts[:6]]
