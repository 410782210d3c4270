"""Tiny versions of the benchmark's cell for the CPU tests: the cells'
own config and mix with every width and length cut, so that a whole
run takes seconds on the CPU."""

from __future__ import annotations

import copy
import json

from s2t_bench.cell import PACKAGE, Cell, load_cell

ZIP = "zipformer_prnnt.train_aishell1"

TINY_TRAFFIC = {
    "corpus_seed": 7, "utterances": 64,
    "durations": {"lo": 0.6, "hi": 1.6, "components": [
        {"weight": 1.0, "dist": "uniform", "lo": 0.6, "hi": 1.6}]},
    "tokens_per_second": [4.0, 6.0], "vocab": [1, 127],
    "batching": {"max_batch_size": 8, "pcm_multiple": 1600,
                 "label_multiple": 8, "speed_perturb_slack": 1.12},
    "noise": {"clips": 3, "seconds": [0.5, 1.0]}, "sample_rate": 16000}


def tiny_cell(name: str) -> Cell:
    return tiny(load_cell(name))


def tiny(cell: Cell) -> Cell:
    """`cell` with every width and length cut (the flagship's model)."""
    cell.meta = copy.deepcopy(cell.meta)
    cfg = cell.meta["train_config"]
    cfg["dataset"]["bucket_sampler_config"].update(
        {"num_bucket": 2, "volume_threshold": 4.0, "min_batch_size": 2})
    cfg["encoder"]["config"].update({
        "downsampling_factor": [1, 2], "num_encoder_layers": [1, 1],
        "feedforward_dim": [32, 48], "encoder_dim": [24, 32],
        "encoder_unmasked_dim": [16, 16], "num_heads": [2, 2],
        "query_head_dim": 8, "value_head_dim": 4, "pos_head_dim": 4,
        "pos_dim": 8, "cnn_module_kernel": [7, 7],
        "chunk_size": [8, -1], "left_context_frames": [16, -1]})
    cfg["predictor"]["config"].update({"output_dim": 32,
                                       "symbol_embedding_dim": 16,
                                       "num_symbols": 128})
    cfg["joiner"].update({"input_dim": 32, "output_dim": 128})
    cell.traffic_spec = json.loads(json.dumps(TINY_TRAFFIC))
    return cell


def benchmark() -> dict:
    with open(PACKAGE.parent / "BENCHMARK.json") as f:
        return json.load(f)
