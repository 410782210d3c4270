"""The traffic generator: deterministic for a seed, the same sizes for
every seed, and each mix's mean and range as its source gives them."""

import json

import numpy as np
import pytest
import torch

from s2t_bench.cell import PACKAGE, load_cell
from s2t_bench.tests.tiny import ZIP, tiny_cell
from s2t_bench.workload import (BLOCK, NoisePool, Traffic,
                                draw_durations, make_batch, swrr_order)

# (mix, utterances, mean s, lo s, hi s)
MIXES = [("aishell1_train", 120098, 4.5, 1.2, 14.5),
         ("libri960_train", 281241, 12.3, 1.4, 35.0)]


def traffic_of(name):
    """A mix by name, batched by the flagship's sampler."""
    cell = load_cell(ZIP)
    with open(PACKAGE / "traffic" / f"{name}.json") as f:
        spec = json.load(f)
    return Traffic(name, spec,
                   cell.train_config["dataset"]["bucket_sampler_config"])


@pytest.mark.parametrize("name,n,mean,lo,hi", MIXES)
def test_mix_matches_its_source(name, n, mean, lo, hi):
    t = traffic_of(name)
    assert len(t.durations) == n
    assert abs(t.durations.mean() - mean) < 0.1
    assert t.durations.min() >= lo and t.durations.max() <= hi
    assert t.durations.max() > hi - 0.5     # the tail reaches the top
    rate = t.token_counts / t.durations
    assert np.percentile(rate, 1) > 3.5 and np.percentile(rate, 99) < 6.5


def test_librispeech_mostly_10_to_17_s():
    d = traffic_of("libri960_train").durations
    assert ((d >= 10) & (d <= 17)).mean() > 0.6


@pytest.mark.parametrize("name", [m[0] for m in MIXES])
def test_corpus_is_the_same_for_every_seed(name):
    a, b = traffic_of(name), traffic_of(name)
    assert np.array_equal(a.durations, b.durations)
    assert a.buckets == b.buckets
    n = BLOCK * 40
    one = [a.bucket_at(1, i) for i in range(n)]
    two = [a.bucket_at(98765432123, i) for i in range(n)]
    assert one != two
    for k in range(0, n, BLOCK):    # each block: the same shapes
        assert sorted(one[k:k + BLOCK]) == sorted(two[k:k + BLOCK])


def test_schedule_holds_epoch_shares():
    t = traffic_of("aishell1_train")
    steps = [t.bucket_at(4242, i) for i in range(40)]
    counts = np.bincount(steps, minlength=len(t.buckets))
    share = np.array(t.epoch_batches) / sum(t.epoch_batches)
    assert np.all(np.abs(counts - 40 * share) <= 1.0)


def test_swrr_period():
    assert sorted(swrr_order([3, 1, 2])) == [0, 0, 0, 1, 2, 2]
    assert swrr_order([2, 1]) == [0, 1, 0]


def test_draw_durations_in_range():
    rng = np.random.default_rng(0)
    spec = {"lo": 1.0, "hi": 2.0, "components": [
        {"weight": 1.0, "dist": "normal", "mean": 1.5, "sd": 1.0}]}
    x = draw_durations(spec, 1000, rng)
    assert len(x) == 1000 and x.min() >= 1.0 and x.max() <= 2.0


def test_batches_deterministic_and_well_formed():
    cell = tiny_cell(ZIP)
    t = Traffic(cell.traffic, cell.traffic_spec,
                cell.train_config["dataset"]["bucket_sampler_config"])
    dev = torch.device("cpu")
    for seed in (5, 2 ** 31 + 11):
        noise = NoisePool(t, seed, dev)
        a = make_batch(t, noise, seed, 3, 1, dev)
        b = make_batch(t, noise, seed, 3, 1, dev)
        for k in a:
            assert torch.equal(a[k], b[k])
        spec = t.buckets[1]
        assert a["pcm"].shape == (spec.batch_size, spec.pcm_len)
        assert a["pcm"].dtype == torch.int16
        assert a["label"].shape == (spec.batch_size, spec.label_len)
        for i in range(spec.batch_size):
            n, u = int(a["pcm_length"][i]), int(a["label_length"][i])
            assert torch.all(a["pcm"][i, n:] == 0)
            assert torch.all(a["label"][i, u:] == 0)
            assert torch.all((a["label"][i, :u] >= 1)
                             & (a["label"][i, :u] <= 127))
        c = make_batch(t, noise, seed, 4, 1, dev)
        assert not torch.equal(a["pcm"], c["pcm"])
