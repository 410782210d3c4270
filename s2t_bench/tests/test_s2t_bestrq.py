"""The cell conformer_bestrq.pretrain_libri960 in the harness: its
configuration names its own reference and counts modules, which take
it; a tiny version runs to `correct` on the CPU; the counts match a hand
count at a tiny shape; the cell reports the readers of every per-layer
metric whose `workloads` lists it, and no other."""

import copy
import json
import time

import pytest
import torch

from s2t_bench import bench
from s2t_bench.cell import load_cell
from s2t_bench.counts import conformer_bestrq as counts
from s2t_bench.counts.frames import fbank_frames
from s2t_bench.reference import bestrq
from s2t_bench.tests.tiny import TINY_TRAFFIC

CELL = "conformer_bestrq.pretrain_libri960"


def tiny_bestrq():
    """The cell with its widths and lengths cut: 2 blocks of width 64,
    4 heads, 2 codebooks of 32 × 8."""
    cell = load_cell(CELL)
    cell.meta = copy.deepcopy(cell.meta)
    cfg = cell.meta["train_config"]
    cfg["dataset"]["bucket_sampler_config"].update(
        {"num_bucket": 2, "volume_threshold": 4.0, "min_batch_size": 2})
    cfg["encoder"]["config"].update({"input_dim": 64, "num_heads": 4,
                                     "ffn_dim": 128, "num_layers": 2,
                                     "output_dim": 64})
    cfg["ssl"]["best_rq"].update({"num_codebooks": 2, "codebook_size": 32,
                                  "codebook_dim": 8})
    cfg["ssl"]["best_rq"]["masking"]["mean_span_length"] = 2
    cell.traffic_spec = json.loads(json.dumps(TINY_TRAFFIC))
    return cell


def test_modules_take_the_cell():
    cell = load_cell(CELL)
    assert cell.reference() is bestrq
    assert cell.part("counts") is counts
    assert cell.train_config["encoder"]["config"]["pos_enc"] == "rel"


def test_tiny_cell_runs_correct():
    r = bench.run_cell(tiny_bestrq(), 2 ** 31 + 77, 0.2, False,
                       torch.device("cpu"), time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("key,change,named", [
    ("task", {"type": "Pruned_Rnnt"}, "SSL task only"),
    ("encoder", {"model": "Zipformer"}, "Conformer only"),
    ("optim_setup", {"optimizer": {"type": "ScaledAdam"}}, "ScaledAdam"),
    ("loss", {"config": {"label_smoothing": 0.1}}, "label smoothing"),
])
def test_check_config_refuses(key, change, named):
    cfg = copy.deepcopy(load_cell(CELL).train_config)
    cfg[key].update(change)
    with pytest.raises(ValueError, match=named):
        bestrq.check_config(cfg)


def test_check_config_refuses_other_spans_and_positions():
    cfg = copy.deepcopy(load_cell(CELL).train_config)
    cfg["ssl"]["best_rq"]["masking"]["span_distribution"] = "poisson"
    with pytest.raises(ValueError, match="static spans only"):
        bestrq.check_config(cfg)
    cfg = copy.deepcopy(load_cell(CELL).train_config)
    cfg["encoder"]["config"]["pos_enc"] = "none"
    with pytest.raises(ValueError, match="relative attention only"):
        bestrq.check_config(cfg)


def test_check_traffic():
    cell = load_cell(CELL)
    bestrq.check_traffic(cell.train_config, cell.traffic_spec)
    with pytest.raises(ValueError, match="8000 Hz"):
        bestrq.check_traffic(cell.train_config,
                             dict(cell.traffic_spec, sample_rate=8000))
    with pytest.raises(ValueError, match="no noise clips"):
        bestrq.check_traffic(cell.train_config,
                             dict(cell.traffic_spec, noise={"clips": 0}))


def test_counts_by_hand():
    # 2 blocks, D=4, F=8, K=3, 2 codebooks of 4 × 2 over 2 stacked frames
    # of 9 bins; 36 feature frames: 17 × 4 after the first conv, 8 × 1
    # after the second, T = 8 frames
    cfg = {"task": {"type": "SSL"},
           "encoder": {"model": "Conformer", "config": {
               "feats_dim": 9, "input_dim": 4, "ffn_dim": 8, "num_layers": 2,
               "depthwise_conv_kernel_size": 3, "output_dim": 4}},
           "ssl": {"best_rq": {"stack_size": 2, "num_codebooks": 2,
                               "codebook_size": 4, "codebook_dim": 2}},
           "dataset": {"data_aug_config": {"use_mix_feats": True}}}
    pcm = 400 + 35 * 160                       # 36 frames
    assert fbank_frames(pcm) == 36 and counts.subsampled(36) == 8
    sub = 2 * 9 * 4 * 17 * 4 + 2 * 9 * 16 * 8 * 1 + 2 * 4 * 4 * 8
    per_frame = 2 * 2 * 2 * 4 * 8 + 2 * 4 * 16 + 2 * 3 * 16 + 2 * 3 * 4
    block = 8 * per_frame + 2 * 2 * 64 * 4 + 2 * 8 * 15 * 4
    head = 8 * 2 * 4 * 4 + 8 * 2 * 4 * 8       # output Dense, logits
    pos = 2 * 15 * 16                          # per block, once a batch
    quant = 18 * (2 * 18 * 2 + 2 * 2 * 8)      # 18 label frames
    B = 3
    want = 3 * (B * (sub + 2 * block + head) + 2 * pos) + B * quant
    assert counts.step_flops(cfg, B, pcm, 0) == want
    assert counts.b2_calls(cfg, B, pcm, 700) == [(B, pcm), (B, pcm),
                                                 (B, 700)]


def test_cell_reports_the_shared_readers():
    names = {m["name"] for m in load_cell(CELL).metrics(True)}
    assert names == {"train_mfu_pct", "device_idle_pct", "peak_mem_gib",
                     "featurize_device_ms", "b2_roofline_pct",
                     "encoder_device_ms", "backward_device_ms",
                     "optimizer_device_ms"}
    assert {m["name"] for m in load_cell(CELL).metrics(False)} == \
        {"train_audio_s_per_s", "setup_s"}
