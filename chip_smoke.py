#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (speech2text_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-with DIR   # also time an earlier port

Phases (any failed check raises and the script exits non-zero):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     no CUDA device → exit 1 with no result;
  2. build the three CUDA kernels from speech2text_torch/csrc (nvcc,
     sm_90a);
  3. attention-weights kernel vs its plain version at every flagship stack
     shape for B=16 and 10 s, bf16 and f32, mask None / ragged pad / chunk,
     and at a 30 s utterance;
  4. fbank kernel vs its plain version at B=16, ragged 2-10 s,
     N % 160 != 0: white noise in the log domain, band-limited audio with
     silence in the linear mel domain, silent frames exactly log(FLT_EPSILON);
  5. serve the flagship (configs/inference/pruned_rnnt_greedy_search.yaml,
     seeded random weights, bf16): 3 requests of B=16 int16 PCM, with one
     attention-weights launch per layer (12) and 1 fbank launch per
     request; then one f32 request (B=2, 3 s) on the card against the
     same module on the CPU;
  6. where a request's time goes, and one profiled request, from which
     each attention-weights launch's device time is read by stack shape;
  7. (training a) kernel B1's gradient (autograd.Function, backward in
     plain torch) at the four flagship stack shapes, bf16 and f32: the
     kernel-fed backward against the same backward fed by the plain
     forward's weights and against autograd through the plain f32 forward
     (every |score| < 100 there); then both kernels and B1's backward
     timed at the training shapes (B=128, 10 s) against their bounds;
  8. (training b) one f32 train step of the flagship dims (dropout off,
     chunk fixed, B=2, 2-3 s) on the card and on the CPU from the same
     weights: losses, gradients and updated parameters;
  9. (training c) the flagship train step at bench.py's shape (bf16,
     B=128 x 10 s, U=48, vocab 128, the YAML's dropout, feature mask and
     chunk sampling, ScaledAdam + Eden): one warm-up step, 5 timed steps
     with 12 attention-weights and 1 fbank launches each, finite losses,
     changed parameters, peak memory, and one profiled step split into its
     phases with the device busy share;
 10. (training d) the flagship YAML trained from manifests through
     speech2text_torch.build_task's main: a synthetic corpus from the seed
     (128 training utterances of 2-12 s, 32 eval, 8 noise clips, written
     to a temporary directory), the subword model trained on it, the
     bucketed pipeline with speed perturbation, add_noise, mix_feats and
     SpecAugment, 20 steps with a metrics line every 5 and an evaluation
     (validation losses, greedy WER) and checkpoint every 10; launches
     (12 attention-weights and 2 fbank per step, 12 + 1 per eval batch),
     finite logged losses, the checkpoints, then a fresh Trainer that
     restores step 20 bitwise and takes 2 more steps, one profiled step
     with its launches and device busy share, and one epoch of steps (one
     batch of each bucket shape) whose B1 and B2 calls, the noise batch's
     B2 included, are held against the plain versions;
 11. (decoding) phase 10's eval set decoded with phase 10's checkpoints
     through speech2text_torch.inference's main: (a) the flagship beam
     YAML (averaged checkpoints, W=4, K=4): the report, 12 B1 and 1 B2
     launches per test batch, one test batch's B1 and B2 calls against
     the plain versions, the time of featurize / encode / decode per
     batch, one profiled batch's device busy share; (b) the greedy YAML
     through the same entry; (c) beam at W=1, K=1 gives greedy's tokens
     (bf16), with phase 10's weights and with seeded ones (phase 10's
     20 steps leave a model that emits almost nothing); (d) an f32 beam
     W=4 request through RnntServer on the card and on the CPU gives the
     same tokens; (e) shallow fusion with a seeded RnnLm at
     configs/training/rnn_lm.yaml's dims (lm_weight 0.3; lm_weight 0
     gives the unfused tokens, with both weights); (f) streaming.
     is_encoder_streaming: every B1 launch of a test batch carries the
     chunk mask;
 12. (streaming) StreamingAsrSession on the flagship (phase 10's YAML and
     subword model, seeded weights, 4 left chunks) over raw PCM cut from
     phase 10's eval wavs: (a) f32, B=2, ~6 s at chunk 32: tokens equal
     the offline chunk-masked decode on the card and the same session on
     the CPU (the count compared is printed and > 0), each chunk's encoder
     output within ENC_TOL of the offline encoder; (b) bf16 at chunks 16,
     32 and 64: 1 B2 and 0 B1 launches per chunk (wrapper counts and the
     trace), every B2 call held to the plain version (linear mel), the
     encoder no more than BF16_STREAM_RMS_RATIO times as far from the f32
     offline encoder as the bf16 offline encoder, token agreement
     reported; (c) latency at chunk 32 over 16 chunks at B=1 and B=16
     (the prime apart; steady p50/p95/max, RTF = p50 / 640 ms), one
     profiled steady chunk (device busy share, device ops, host spans
     featurize / encoder / greedy) and B2's device time at the chunk's
     shape beside its bound; (d) speech2text_torch.tools.stream_demo's
     main on an eval wav with phase 10's checkpoints, its launches counted;
 13. (the Conformer family) on phase 10's corpus, f32 as the YAMLs leave
     it: (a) configs/training/conformer_ctc.yaml (144 x 4, AdamW + Warmup,
     clipping at 5.0) through build_task's main, 20 steps with a metrics
     line every 5 and an evaluation and checkpoint (top-k by wer) every
     10, then a fresh Trainer that restores step 20 (weights and AdamW
     state bitwise) and takes 2 more steps; (b) its greedy and prefix-beam
     (beam 8) inference YAMLs on (a)'s checkpoints, the time of
     featurize / encode / each decoder per test batch, and f32 tokens on
     seeded weights equal on the card and the CPU from the same features;
     (c) configs/training/conformer_pruned_rnnt.yaml at its width (256 x
     12, Projector head, CTC branch) through TrainStep at bench.py's shape:
     dropout on in training only, a warm-up and 5 timed steps with finite
     losses (ctc_loss included) and every parameter changed, the step's
     parts, one profiled step; (d) the same YAML through build_task for 5
     steps and an evaluation, then the pruned_rnnt_ctc_greedy_search
     inference YAML on its checkpoint, f32 tokens on seeded weights equal
     on the card and the CPU; (e) 0 B1 launches throughout, 2 B2 per
     build_task step, 1 per TrainStep step and per eval or test batch,
     and every B2 call of the build_task and inference runs held to the
     plain version with check_mel;
 14. (the remaining transducer recipes) zipformer_heldout.yaml with its
     training dynamics through build_task and beside phase 9's step,
     conformer_rnnt.yaml and conformer_hybrid_rnnt.yaml through
     build_task and TrainStep, their three inference YAMLs with f32
     tokens card = CPU on seeded weights;
 15. (the CIF, SSL and NNLM families) on phase 10's corpus, f32: (a)
     conformer_cif.yaml at its 256 x 12 through build_task (10 steps, an
     evaluation with WER, a bitwise resume), its step at bench.py's shape
     split into encoder / CIF / Projector + CE + MAE / backward /
     optimizer with its peak memory and a profiled step,
     cif_greedy_search.yaml on its checkpoints, f32 tokens on seeded
     weights card = CPU (a difference admitted only at a fire whose
     accumulator came within 1e-5 of a threshold, each printed); (b)
     conformer_ssl.yaml (256 x 12, 16 codebooks x 8192) through
     build_task (5 steps, 3 B2 per step, an evaluation with acc, a
     bitwise resume), its step at B=60 x 10 s in parts with the peak
     memory reckoned beforehand, then conformer_ctc.yaml at the same
     width finetuned from its checkpoint (every encoder tensor copied,
     logits_layer not); (c) rnn_lm.yaml (256 / 512 x 2) through
     build_task (20 steps, no B2, evaluations with acc, a bitwise
     resume), its checkpoint fused into phase 11's beam + LM decode and
     an f32 beam + LM request card = CPU; every B2 call of the runs held
     to the plain version, 0 B1;
 16. (the last two CTC encoders and the loop options) on phase 10's
     corpus, f32, TF32 off: (a) emformer_ctc.yaml (256 x 12) through
     build_task (10 steps, an evaluation, a bitwise resume),
     ctc_greedy_search.yaml on its checkpoints, f32 tokens on seeded
     weights card = CPU (count printed, > 0), its step at B=128 x 2-10 s
     in parts (featurize, encoder, CTC forward, backward, clipping +
     AdamW) with peak memory and a profiled step, the max_memory_size=4
     override's step and 8 streaming_step chunks card = CPU; (b)
     synthetic HF wav2vec2 checkpoints (768 x 12) in both layouts written
     and converted by the port's tool, the base one merged through
     pretrained_path (the stable one raises on the base config),
     wav2vec2_ctc.yaml through build_task (5 steps, an evaluation, a
     resume), its greedy decode with tokens card = CPU, its step at B=64
     x 10 s in parts, 0 B1 and 0 B2 launches throughout; (c) build_task
     with global_cmvn.apply and no statistics file (16 train batches, cut
     from JAX's 200): cmvn.json against the CPU's plain-fbank statistics,
     every B2 call of the run held to the plain version; and
     accumulate_grad_batches 2 over 4 micro-batches, card = CPU (losses,
     AdamW moments, parameters, count 2);
 17. (deployment) on phase 10's checkpoints and corpus: (a) the greedy
     and beam flagship YAMLs with decoding.config.int8=true through
     inference's main (reports written); on seeded weights the int8
     tokens card = CPU from the same f32 encoder output (count printed,
     > 0), the int8 product (torch._int_mm on padded operands) card =
     CPU exactly at the decode's rows (B, B x W) and at rows <= 16, the
     utterances whose int8 tokens equal f32's, an int8 and an f32 greedy
     frame step timed (device and host); (b) conformer_rnnt.yaml's LSTM
     predictor (512 x 2), seeded, int8 greedy and beam card = CPU with
     the card's transcendental functions (the utterances equal with the
     CPU's own printed: requantizing the LSTM state turns their last-ulp
     differences into int8 flips, which move near-tied beams); (c)
     ctc_lexicon_beam_search (the corpus's words, a unigram ARPA LM
     written here, the C++ runtime built by g++ at first use) on phase
     13's CTC checkpoint, texts card = CPU from the log-probs on seeded
     weights, log-probs within ENC_TOL; (d) task.module_export (encoder at
     1 x 2000 frames, predictor, joiner, units.txt, weights.int8.npz) and
     build_task's callbacks.frontend_save (B=1 x 30 s), reloaded and run:
     12 B1 and 1 B2 launches inside them, outputs = eager within ENC_TOL,
     B1 and B2 device times eager against exported; (e) the model-average
     CLI = inference's chkpt_aver average, bitwise. Every run on the card
     has its launches counted, every B1 call held as check_weights holds
     it and every B2 call as check_mel;
 18. the export surfaces (phase_export): (a) stream_demo --export_dir on
     phase 10's checkpoints (bf16, chunk 32, 4 left chunks, B=1); the
     reloaded stream_prime.pt2 / stream_step.pt2 over a prime and 30
     steps of phase 12's eval PCM held to the eager session chunk by
     chunk (tokens equal, state tensors within ENC_TOL), 0 B1 and 1 B2
     launch per chunk, every B2 call held; the same with phase 12's
     seeded weights loaded, tokens compared > 0; the reloaded step's p50
     against the eager step's, in turns; (b) inference.main with
     task.onnx_export (1 x 1000 frames): the nine artifacts and
     encoder_stream_spec.json, every graph in the port's numpy runner
     on the host against the card's eager f32 model (TF32 off) within
     ENC_TOL, each int8 graph within 0.05 x its f32 graph's output
     magnitude (the streaming graph's first call from the zero state
     recorded and held with the frontend projection kept f32), no
     custom-op node; export and runner seconds;
 19. data parallelism and FSDP (phase_parallel): the flagship YAML on
     phase 10's corpus (bf16, augmentation and dropout off, every bucket
     at B=16, PAR_STEPS steps and one evaluation) through build_task's
     main in this process, then through torchrun ranks of this script
     (--parallel-rank): (a) world 1 over NCCL with DDP and (b) with
     trainer.fsdp, each against the one-process run (losses, grad_norm,
     step-6 parameters: bitwise or within PAR_SAME_RTOL, the worst
     printed); (c) 2 ranks on the one card over gloo against it step by
     step (loss and grad_norm within PAR_LOSS_RTOL / PAR_GRAD_RTOL); (d)
     inference of seeded f32 weights (TF32 off) over 2 gloo ranks: rank
     0's report equals one process's byte for byte. In every rank every
     B1 and B2 launch is counted (counts set to 0 before each main, read
     after) and held to its plain version as it returns (HeldCalls); every
     process runs deterministic algorithms. The two torchrun jobs run
     beside the one-process reference; once the rest is done, the 2-rank
     run times PAR_TIMED_STEPS steps per rank (ms, peak memory) and
     profiles one for its collectives;
 20. (recipe options) (a) kernel B2 at every FFT size a 25 ms frame takes at
     8, 16, 32 and 48 kHz (256 to 2048 points) × snip_edges or centred
     framing × dither off or one int16 step (DITHER_STEP): B=16 ragged
     2-10 s clips with N % shift != 0, white noise held at FBANK_TOL and
     band-limited audio by check_mel against the plain version given the
     same noise, and for centred framing a clip shorter than half a
     frame; 8 kHz centred and 16 kHz centred with dither timed at B=128
     x 10 s beside their bounds (the noise's bytes counted); (b) the
     flagship YAML as an 8 kHz telephony recipe (fbank at 8 kHz, centred
     framing, dither) on an 8 kHz synthetic corpus through build_task's
     main (TEL_STEPS steps, one evaluation; 2 B2 launches per step, the
     speech batch's with dither) and pruned_rnnt_greedy_search through
     inference's main, every B1 and B2 call held; (c) recompute
     (encoder.config.remat off, "full", "dots") on phase 9's step at
     B=128 x 10 s and on the heldout step (dynamics, dropout, given
     draws) at B=32, deterministic algorithms: the first step's losses
     and gradients bitwise equal to off's, peak memory ("full" below
     off's, "dots" no higher), B1 launches per step (2x the layers under
     "full", 1x under "dots"), ms per step;
 21. (kernel B3, run right after phase 9, whose timed steps take 4 B3
     launches each (the simple and the pruned loss, forward and backward)
     and walk 0 diagonals of the plain loops) the transducer lattice
     kernels against autograd through the plain loop on the card at the
     benchmark cell's eight bucket shapes (arcs at a fresh model's scale,
     -log 4336 plus noise; lengths with t_len 1 and T, u_len 0 and U):
     totals within LATTICE_TOTAL_RTOL, occupancies (g = 1) and gradients
     (g with a 0) within LATTICE_TOL, and within LATTICE_TOL of the plain
     walk back, 0 without a path or g, no NaN; the prune ranges from the
     kernel's occupancies against the plain ones (equal share, every
     difference); at the 388-utterance bucket also a pruned band through
     rnnt_loss_pruned with an infeasible utterance (loss and gradient 0),
     t_len 0, and B = 1; U+1 > 1024 (two cells a thread); each kernel's
     device time at every bucket shape beside its bytes bound and its
     diagonals, and the plain loop's forward and backward;
timings beside each kernel's bound (phases 3-4, 7). A kernel's time is device
time: the median duration of the kernels of its name in a torch.profiler
trace of 30 wrapper calls (speech2text_torch/tools/timing.py); the
wrapper's host time per call (perf_counter, synchronised before each call)
is reported apart as host_ms.
With --compare-with DIR, DIR is the speech2text_torch package of an earlier
commit (for example unpacked with `git archive <commit> speech2text_torch`
into a directory that .gitignore lists). Its public entry points
(ops.attn_weights.zip_weights, ops.fbank.fbank) build its kernels from
DIR/csrc at first use; they are timed in turns with this tree's (earlier,
this, this, earlier) at every main-path shape, with their host times.
The kernels' record holds the training path's numbers (phase 9's launches,
phase 7's times at its shapes), under "serve" the serving path's (phase
5's launches, phases 3-4's times per request), under "train_run" phase
10's launches (the whole run and one step) and the worst error against
the plain version over its bucket shapes, and under "infer" phase 11's
(the flagship beam YAML's run: launches, per test batch, and the worst
error of the test batches checked), and under "stream" phase 12's (the
demo's launches, launches per chunk, the worst B2 error over phase 12's
chunks, B2's times at the B=1 step shape, and at B=16), and under
"conformer" phase 13's (launches over the phase, per step and per test
batch, the B2 calls checked and their worst error), under "rnnt_family"
phase 14's, and under "task_families" phase 15's per family (cif, ssl,
nnlm: launches, per step, CIF's per test batch, the B2 calls checked and
their worst error), and under "ctc_encoders" phase 16's (emformer:
launches, per step, per test batch, calls checked, worst error; wav2vec2:
0; the CMVN run's and the accumulation run's launches), and under
"deploy" phase 17's (launches over the phase, calls held, worst error,
launches inside the reloaded exported programs), and under "export"
phase 18's (launches over the phase, calls held, worst error, launches
inside the reloaded streaming programs and per chunk, the ONNX graphs'
custom-op nodes: 0), and under "parallel" phase 19's (launches over the
phase's ranks, per run and rank, calls held, worst error), and under
"options" phase 20's (B2: the telephony runs' launches, calls held and
worst error, each variant's calls held and errors, the timed variants;
B1: the telephony runs' launches and, under "remat", the launches per
step, peak memory and ms per step of each recompute setting).
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

import copy
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
SR = 16000
B_SERVE = 16
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# attention weights against the plain version in the same dtype; bf16 is
# also held to half a bf16 ulp of the plain f32 weights (round to nearest)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=2e-3)}
BF16_ROUND_TOL = dict(rtol=2.0 ** -8 + 1e-5, atol=1e-6)
ROW_SUM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
FBANK_TOL = dict(rtol=1e-4, atol=1e-3)
# Band-limited audio leaves mel bands with ~1e-7 of a frame's energy: both
# the FFT and the DFT product hold them as rounding noise, so their logs may
# differ by more than 1e-3. They are compared as linear mel, within 1e-5 of
# the frame's mel energy and 1e-4 relative.
BAND_REL_TOL = 1e-4
BAND_ENERGY_TOL = 1e-5
ENC_TOL = dict(rtol=1e-3, atol=1e-3)
CFG = "configs/inference/pruned_rnnt_greedy_search.yaml"
TRAIN_CFG = "configs/training/zipformer_stateless_pruned_rnnt.yaml"
B_TRAIN, TRAIN_SECS, TRAIN_U = 128, 10, 48        # bench.py's shape
TRAIN_STEPS = 5
# B1's gradient, as max |got - want| over max |want| per tensor: f32 at
# the rtol of the CPU tests; bf16 at JAX's bf16 tolerance
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# f32 train step, card vs CPU: losses within rtol 1e-4; each gradient
# within 1e-3 of its largest entry (summation order, cuDNN's convolution
# algorithms); each parameter within rtol 1e-4 / atol 1e-6 plus what the
# two gradients' difference moves ScaledAdam's first step by (its
# g/(|g|+eps) flips with the sign of a near-zero gradient)
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 1e-3
STEP_PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
# the key biases' gradient (exactly 0 in exact arithmetic), against the key
# weights' largest gradient entry
SHIFT_FREE_TOL = 1e-3
# phase 10: the flagship YAML trained from manifests of a synthetic corpus
RUN_TRAIN_UTTS, RUN_EVAL_UTTS, RUN_NOISE_CLIPS = 128, 32, 8
RUN_STEPS, RUN_VAL_EVERY, RUN_LOG_EVERY, RUN_RESUME_STEPS = 20, 10, 5, 2
RUN_KEYS = ("step", "loss", "lr", "utts_per_sec", "frames_per_sec",
            "simple_loss", "pruned_loss", "train_loss", "grad_norm")
RUN_LAYERS = 12
# phase 11: decoding phase 10's eval set with its checkpoints
BEAM_CFG = "configs/inference/zipformer_stateless_pruned_rnnt_beam_search.yaml"
LM_CFG = "configs/training/rnn_lm.yaml"
LM_WEIGHT = 0.3
# phase 12: true streaming; bf16 streaming must be no more than this many
# times as far (RMS) from the f32 offline encoder as the bf16 offline
# encoder is: both round to bf16, in other summation orders
STREAM_LEFT, STREAM_SECS = 4, 6
STREAM_CHUNKS = (16, 32, 64)
STREAM_TIMED_CHUNKS = 15      # steady chunks timed and held: 9.6 s
BF16_STREAM_RMS_RATIO = 2.0
# phase 13: the Conformer family on phase 10's corpus
CTC_CFG = "configs/training/conformer_ctc.yaml"
CONF_CFG = "configs/training/conformer_pruned_rnnt.yaml"
CTC_INFER = {"greedy": "configs/inference/ctc_greedy_search.yaml",
             "prefix_beam": "configs/inference/ctc_beam_search.yaml"}
CONF_INFER_CFG = "configs/inference/pruned_rnnt_ctc_greedy_search.yaml"
CONF_STEPS, CONF_VAL_EVERY, CONF_LOG_EVERY, CONF_RESUME_STEPS = 20, 10, 5, 2
CONF_RNNT_STEPS = 5
CTC_KEYS = ("step", "loss", "lr", "utts_per_sec", "frames_per_sec",
            "train_loss", "grad_norm")
# f32 tokens, card vs CPU, over the first test batches
CONF_CPU_BATCHES = 2
# phase 14: the remaining transducer recipes on phase 10's corpus
HELDOUT_CFG = "configs/training/zipformer_heldout.yaml"
HELDOUT_STEPS, HELDOUT_LOG_EVERY = 10, 5
RNNT_CFG = "configs/training/conformer_rnnt.yaml"
HYBRID_CFG = "configs/training/conformer_hybrid_rnnt.yaml"
RNNT_STEPS = 5
RNNT_INFER = {
    "rnnt_greedy_search": ("configs/inference/rnnt_greedy_search.yaml",
                           "rnnt"),
    "rnnt_beam_search": ("configs/inference/rnnt_beam_search.yaml", "rnnt"),
    "ctc_hybrid_rnnt_greedy_search": (
        "configs/inference/ctc_hybrid_rnnt_greedy_search.yaml", "hybrid")}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def log(msg, card=None):
    print(msg + (f"  [{card}]" if card else ""), flush=True)


def check_close(name, got, want, rtol, atol):
    diff = (got.float() - want.float()).abs()
    bad = diff > atol + rtol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of "
                             f"tolerance, max abs err {float(diff.max())}")
    return float(diff.max())


def check_mel(name, got, want):
    """Log-mel features of audio whose quiet bands may lie at rounding
    level, held in the linear mel domain: within BAND_ENERGY_TOL of the
    frame's mel energy plus BAND_REL_TOL of the value. Returns the largest
    error as a share of its frame's mel energy."""
    lin, want_lin = got.exp(), want.exp()
    energy = want_lin.sum(-1, keepdim=True)
    diff = (lin - want_lin).abs()
    excess = diff - (BAND_ENERGY_TOL * energy + BAND_REL_TOL * want_lin)
    assert bool((excess <= 0).all()), \
        f"{name}: {int((excess > 0).sum())} mel values out of tolerance"
    return float((diff / energy).max())


def ragged_lengths(rng, n, lo_s, hi_s, n_max):
    lens = rng.integers(int(lo_s * SR), int(hi_s * SR) + 1, n)
    lens[0] = n_max
    return lens


# ------------------------------------------------------------ phase 3: B1
def check_weights(name, got, q, k, qp, p, mask, dt):
    """The kernel's weights against the plain version; rows sum to 1, masked
    keys of a row with a valid key are exactly 0, a fully masked row is
    uniform. Returns the max abs error against the plain version in `dt`."""
    from speech2text_torch.ops import attn_weights as aw
    want = aw.attn_weights_plain(q, k, qp, p, mask, dt)
    err = check_close(name, got, want, **TOL[dt])
    if dt == torch.bfloat16:
        check_close(name + " vs f32 rounded", got,
                    aw.attn_weights_plain(q, k, qp, p, mask, torch.float32),
                    **BF16_ROUND_TOL)
    w = got.float()
    row_err = float((w.sum(-1) - 1).abs().max())
    assert row_err <= ROW_SUM_TOL[dt], f"{name}: row sum off by {row_err}"
    if mask is not None:
        m = mask[:, None].expand_as(w)
        has_key = m.any(-1, keepdim=True).expand_as(w)
        assert bool((w[~m & has_key] == 0).all()), \
            f"{name}: masked key with non-zero weight"
        T = w.shape[-1]
        uni = w[~has_key]
        assert bool(((uni - 1.0 / T).abs() <= 2.0 ** -8 / T).all()), \
            f"{name}: fully masked row not uniform"
    return err


def attn_bound_ms(B, T, H, qd, pd, in_dtype, out_dtype, has_mask):
    es_in = torch.tensor([], dtype=in_dtype).element_size()
    es_out = torch.tensor([], dtype=out_dtype).element_size()
    nbytes = ((2 * B * T * H * qd + B * T * H * pd + (2 * T - 1) * H * pd)
              * es_in + (B * T * T if has_mask else 0)
              + B * H * T * T * es_out)
    ops = 2 * B * H * T * T * (qd + pd)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[in_dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attn_timing(q, k, qp, p, mask, card, err):
    """Device time of the B1 kernel on these inputs (with and without the
    mask), the wrapper's host time, the plain version's time, the bound."""
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.tools.timing import device_ms, events_ms, host_ms
    B, T, H, qd = q.shape
    pd, dt = qp.shape[-1], q.dtype
    name = aw.KERNEL.name
    ms = device_ms(lambda: aw.attn_weights_cuda(q, k, qp, p, mask, dt), name)
    # the same call without a mask: what the mask path costs
    nomask_ms = device_ms(lambda: aw.attn_weights_cuda(q, k, qp, p, None,
                                                       dt), name)
    h_ms = host_ms(lambda: aw.attn_weights_cuda(q, k, qp, p, mask, dt))
    p_ms = events_ms(lambda: aw.attn_weights_plain(q, k, qp, p, mask, dt),
                     iters=10)
    bound, by = attn_bound_ms(B, T, H, qd, pd, dt, dt, True)
    log(f"attn_weights B={B} T={T} H={H} {dt} pad mask: device "
        f"{ms:.4f} ms (no mask {nomask_ms:.4f}), "
        f"{B * H * T * T / ms / 1e6:.1f} weights/ns, wrapper "
        f"host {h_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
        f"{100 * bound / ms:.1f}% of bound, max abs err {err:.3g}", card)
    return dict(ms=ms, ms_no_mask=nomask_ms, host_ms=h_ms, plain_ms=p_ms,
                bound_ms=bound, bound_by=by)


def per_layer_sum(timing, shapes, enc_cfg, keys):
    """Per-shape timings summed over the encoder's layers (one B1 launch
    each), with the bound's kind that holds most of the summed bound."""
    per = [timing[(T, H)]
           for (T, H), n in zip(shapes, enc_cfg["num_encoder_layers"])
           for _ in range(n)]
    total = {key: sum(t[key] for t in per) for key in keys}
    total["layers"] = len(per)
    if "bound_ms" in keys:
        total["bound_by"] = (
            "bytes" if sum(t["bound_ms"] for t in per
                           if t["bound_by"] == "bytes")
            >= total["bound_ms"] / 2 else "operations")
    return total


def phase_attn(enc_cfg, card, report):
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops.masking import chunk_causal_mask
    from speech2text_torch.tools.timing import (attn_inputs, pad_mask_of,
                                                stack_shapes)
    qd, pd = enc_cfg["query_head_dim"], enc_cfg["pos_head_dim"]
    shapes = stack_shapes(enc_cfg, 10 * SR)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    errs = {}
    timing = {}
    for T, H in sorted(set(shapes)):
        B = B_SERVE
        pad_mask = pad_mask_of(rng, B, T)
        chunk_mask = (pad_mask & chunk_causal_mask(T, 16, 4,
                                                   device="cuda")[None])
        for dt in (torch.bfloat16, torch.float32):
            q, k, qp, p = attn_inputs(gen, B, T, H, qd, pd, dt)
            for mname, mask in (("none", None), ("pad", pad_mask),
                                ("chunk16/4", chunk_mask)):
                got = aw.attn_weights_cuda(q, k, qp, p, mask, dt)
                errs[(T, H, str(dt), mname)] = check_weights(
                    f"attn_weights T={T} H={H} {dt} {mname}", got,
                    q, k, qp, p, mask, dt)
            if dt == torch.bfloat16:
                timing[(T, H)] = attn_timing(q, k, qp, p, pad_mask, card,
                                             errs[(T, H, str(dt), "pad")])
    # a 30 s utterance: stack 0's T=1495 (the table window grows with T)
    T, H = stack_shapes(enc_cfg, 30 * SR)[0]
    q, k, qp, p = attn_inputs(gen, 2, T, H, qd, pd, torch.bfloat16)
    pad = torch.arange(T, device="cuda")[None] < torch.tensor(
        [[T], [T // 3]], device="cuda")
    mask = pad[:, None, :] & pad[:, :, None]
    errs[(T, H, "torch.bfloat16", "pad, 30 s")] = check_weights(
        f"attn_weights T={T} H={H} bf16 pad (30 s)",
        aw.attn_weights_cuda(q, k, qp, p, mask, torch.bfloat16),
        q, k, qp, p, mask, torch.bfloat16)
    report["attn_weights_checks"] = {"/".join(map(str, k)): v
                                     for k, v in errs.items()}
    report["attn_weights_timing"] = {f"T={T},H={H}": v
                                     for (T, H), v in timing.items()}
    # the main path: one launch per layer, bf16, pad mask
    summary = per_layer_sum(timing, shapes, enc_cfg,
                            ("ms", "host_ms", "plain_ms", "bound_ms"))
    summary["max_abs_err"] = max(errs.values())
    log(f"attn_weights per request ({summary['layers']} launches, B=16, "
        f"10 s, bf16): device {summary['ms']:.4f} ms, wrapper host "
        f"{summary['host_ms']:.4f} ms, plain {summary['plain_ms']:.4f} ms, "
        f"bound {summary['bound_ms']:.4f} ms ({summary['bound_by']})", card)
    return summary, timing


# ------------------------------------------------------------ phase 4: B2
def band_limited_pcm(rng, B, N, sr=SR):
    """Four sines below 4 kHz per utterance with a stretch of silence."""
    t = np.arange(N) / sr
    x = np.zeros((B, N))
    for b in range(B):
        for _ in range(4):
            x[b] += rng.uniform(0.05, 0.3) * np.sin(
                2 * np.pi * rng.uniform(100, 3900) * t
                + rng.uniform(0, 2 * np.pi))
        a = rng.integers(0, N // 2)
        x[b, a:a + rng.integers(N // 8, N // 3)] = 0.0
    return x.astype(np.float32)


def fbank_fft_flops(frames, flen, n_mels, n_weights, n_fft=512,
                    dither=False):
    """Operations of the FFT kernel: per frame the dither (2 per sample,
    when on), the DC sum, preemphasis and window (4 per sample), the
    radix-4 stages of n_fft/8 butterflies (8 complex adds and 3 complex
    multiplies: 34 each) and the radix-2 stage where n_fft/2 is not a
    power of four (n_fft/4 butterflies of 2 complex adds: 4 each), the
    split into n_fft/2 + 1 bins (19 each), the mel runs (2 per weight) and
    the log (1 per mel). At 512 points: 4 stages of 64 butterflies."""
    nc = n_fft // 2
    log2 = nc.bit_length() - 1
    fft = (log2 // 2) * (nc // 4) * 34 + (log2 % 2) * (nc // 2) * 4
    return frames * ((6 if dither else 4) * flen + fft + 19 * (nc + 1)
                     + 2 * n_weights + n_mels)


def phase_fbank(card, report):
    from speech2text_torch.data.frontend import Fbank
    from speech2text_torch.ops import fbank as fb
    rng = np.random.default_rng(SEED + 1)
    N = 10 * SR + 77                        # N % 160 != 0
    lens = ragged_lengths(rng, B_SERVE, 2, 10, N)
    beyond = np.arange(N)[None] >= lens[:, None]
    pcm = (0.2 * rng.standard_normal((B_SERVE, N))).astype(np.float32)
    pcm[beyond] = 0.0
    fbank = Fbank().cuda()
    x = torch.from_numpy(pcm).cuda()
    cfg = fbank.cfg
    T = cfg.num_frames(N)
    ops = (fbank.window, fbank.dft_cos, fbank.dft_sin, fbank.banks)
    kw = dict(frame_length=cfg.frame_length, frame_shift=cfg.frame_shift,
              preemph=cfg.preemphasis, remove_dc=cfg.remove_dc_offset)
    got = fb.fbank_cuda(x, *ops, T, **kw)
    want = fb.fbank_plain(x, *ops, T, **kw)
    torch.cuda.synchronize()
    assert got.shape == (B_SERVE, T, cfg.num_mel_bins)
    err = check_close("fbank", got, want, **FBANK_TOL)

    # band-limited audio with silence, in the linear mel domain
    band = band_limited_pcm(rng, B_SERVE, N)
    band[beyond] = 0.0
    xb = torch.from_numpy(band).cuda()
    got_b = fb.fbank_cuda(xb, *ops, T, **kw)
    want_b = fb.fbank_plain(xb, *ops, T, **kw)
    band_err = check_mel("fbank band-limited", got_b, want_b)
    silent = (fb.frame_signal(xb, T, cfg.frame_length, cfg.frame_shift)
              == 0).all(-1)
    floor = float(np.log(np.float32(fb.EPSILON)))
    assert int(silent.sum()) > 0 and bool((got_b[silent] == floor).all()), \
        "silent frames do not give exactly log(FLT_EPSILON)"
    log(f"fbank band-limited B={B_SERVE}: max |mel - plain| "
        f"{band_err:.3g} of the frame's mel energy (tol {BAND_ENERGY_TOL}), "
        f"{int(silent.sum())} silent frames exactly log(FLT_EPSILON)", card)

    summary = fbank_timing(fbank, x, card, err)
    summary["band_limited_err_of_energy"] = band_err
    report["fbank"] = summary
    return summary


def fbank_timing(fbank, x, card, err, noise=None):
    """Device time of the B2 kernel on the PCM `x` in `fbank`'s framing
    (and with the dither `noise`, scaled by the config's dither, when
    given), the wrapper's host time, the plain version's time and the
    bound: each input read once (the noise too), the features written
    once."""
    from speech2text_torch.ops import fbank as fb
    from speech2text_torch.tools.timing import device_ms, events_ms, host_ms
    cfg = fbank.cfg
    B, N = x.shape
    T = cfg.num_frames(N)
    n_fft = cfg.padded_window_size
    dither = cfg.dither if noise is not None else 0.0
    args = (x, fbank.window, fbank.dft_cos, fbank.dft_sin, fbank.banks, T,
            cfg.frame_length, cfg.frame_shift, cfg.preemphasis,
            cfg.remove_dc_offset, cfg.snip_edges, noise, dither)
    _, _, weights = fb.fft_operands(*args[2:5])
    k_ms = device_ms(lambda: fb.fbank_cuda(*args), fb.KERNEL.name)
    h_ms = host_ms(lambda: fb.fbank_cuda(*args))
    p_ms = events_ms(lambda: fb.fbank_plain(*args))
    flen, n_mels, n_w = cfg.frame_length, cfg.num_mel_bins, weights.numel()
    nbytes = 4 * (B * N + B * T * n_mels + flen + 2 * n_fft
                  + 3 * n_mels + n_w
                  + (noise.numel() if noise is not None else 0))
    flops = fbank_fft_flops(B * T, flen, n_mels, n_w, n_fft,
                            noise is not None)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    n_bins = n_fft // 2 + 1
    dft_flops = B * T * (4 * flen * n_bins + 2 * n_bins * n_mels)
    summary = {"ms": k_ms, "host_ms": h_ms, "plain_ms": p_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "max_abs_err": err, "fft_gflop": flops / 1e9,
               "dft_product_bound_ms": dft_flops / PEAK_FLOPS[torch.float32]
               * 1e3}
    log(f"fbank B={B} N={N} frames={T} n_fft={n_fft} "
        f"{'snip_edges' if cfg.snip_edges else 'centred'}"
        f"{' dither' if noise is not None else ''}: device {k_ms:.4f} ms, "
        f"wrapper host {h_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"bound {summary['bound_ms']:.4f} ms ({summary['bound_by']}: "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP f32), "
        f"{100 * summary['bound_ms'] / k_ms:.1f}% of bound, max abs err "
        f"{err:.3g}", card)
    return summary


# ------------------------------------------------------------ phase 5
def requests(rng, n_req, B, lo_s, hi_s):
    out = []
    for _ in range(n_req):
        N = int(hi_s * SR)
        lens = ragged_lengths(rng, B, lo_s, hi_s, N)
        pcm = (3000 * rng.standard_normal((B, N))).clip(-32768, 32767)
        pcm = pcm.astype(np.int16)
        pcm[np.arange(N)[None] >= lens[:, None]] = 0
        out.append((pcm, lens.astype(np.int32)))
    return out


def phase_breakdown(server, reqs, layer_shapes, card, report):
    """Where a request's time goes: featurize / encode / decode on the
    host clock (synchronised), and one profiled request's device time,
    with each kernel launch's duration (attention weights by the (T, H)
    of its layer, `layer_shapes` in launch order)."""
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import fbank as fb
    from speech2text_torch.tools.timing import kernel_durations_ms
    parts = {"featurize": [], "encode": [], "decode": []}
    for pcm, lens in reqs:
        t0 = time.perf_counter()
        feats, feat_lens = server.featurize(pcm, lens)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        enc, enc_lens = server.encode(feats, feat_lens)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        server.decoder.decode(enc, enc_lens)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(v * 1e3)
    med = {k: statistics.median(v) for k, v in parts.items()}
    log("request breakdown (median ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in med.items()), card)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.transcribe(*reqs[0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memcpy/memset): the host ops that
    # launched them carry the same time and would count it twice
    rows, busy, _ = profile_summary(prof)
    if busy > 0:
        log(f"profiled request: wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms ({100 * busy / wall:.1f}%), "
            f"{sum(r[2] for r in rows)} device ops", card)
        for key, ms, n in rows[:8]:
            log(f"  {ms:8.3f} ms  x{n:<5d} {key[:90]}", card)
    else:
        log("profiled request: device time not measured (no CUDA events "
            "in the trace)", card)
    b1 = kernel_durations_ms(prof, aw.KERNEL.name)
    b2 = kernel_durations_ms(prof, fb.KERNEL.name)
    served = {}
    if len(b1) == len(layer_shapes) and len(b2) == 1:
        for (T, H), ms in zip(layer_shapes, b1):
            served.setdefault(f"T={T},H={H}", []).append(ms)
        log("profiled request, kernel device ms: attn_weights " + "; ".join(
            f"{k} " + ", ".join(f"{x:.4f}" for x in v)
            for k, v in served.items()) + f" (sum {sum(b1):.4f}); fbank "
            f"{b2[0]:.4f}", card)
    else:   # the tracer dropped a record: launches cannot be told apart
        log(f"profiled request: per-launch kernel times not measured (the "
            f"trace holds {len(b1)} of {len(layer_shapes)} attention-weights "
            f"and {len(b2)} of 1 fbank records)", card)
    report["breakdown"] = {"median_ms": med, "profiled_wall_ms": wall,
                           "device_busy_ms": busy,
                           "attn_weights_served_ms": served,
                           "fbank_served_ms": b2,
                           "top_device_ops": rows[:20]}


def phase_serve(layer_shapes, card, report):
    from speech2text_torch.config import load_config
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import fbank as fb
    from speech2text_torch.serve import RnntServer
    server = RnntServer(CFG, device="cuda", seed=SEED)
    assert server.batch_size == B_SERVE
    vocab = server.model.joiner.config.output_dim
    enc_cfg = server.model.encoder.config
    expect = (sum(enc_cfg.num_encoder_layers), 1)   # B1 per layer, B2 once
    rng = np.random.default_rng(SEED + 2)
    warm = requests(rng, 1, B_SERVE, 2, 10)
    reqs = requests(rng, 3, B_SERVE, 2, 10)
    server.transcribe(*warm[0])               # first-call set-up, uncounted
    torch.cuda.synchronize()

    aw.KERNEL.launches = fb.KERNEL.launches = 0
    lat = []
    per_req = []
    for pcm, lens in reqs:
        a0, f0 = aw.KERNEL.launches, fb.KERNEL.launches
        t0 = time.perf_counter()
        feats, feat_lens = server.featurize(pcm, lens)
        enc, enc_lens = server.encode(feats, feat_lens)
        tokens, counts = server.decoder.decode(enc, enc_lens)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        per_req.append((aw.KERNEL.launches - a0, fb.KERNEL.launches - f0))
        assert bool(torch.isfinite(enc).all()), "non-finite encoder output"
        assert enc.shape[0] == B_SERVE and \
            enc.shape[-1] == enc_cfg.output_dim
        c = counts.cpu().numpy()
        t = tokens.cpu().numpy()
        assert (c >= 0).all() and (c <= t.shape[1]).all()
        emitted = t[np.arange(t.shape[1])[None] < c[:, None]]
        assert ((emitted >= 1) & (emitted <= vocab - 1)).all(), \
            "token ids outside [1, vocab-1]"
    launches = {"attn_weights": aw.KERNEL.launches,
                "fbank": fb.KERNEL.launches}
    assert all(r == expect for r in per_req), \
        f"launches per request (attn_weights, fbank): {per_req}, " \
        f"expected {expect}"
    med = statistics.median(lat)
    log(f"serve flagship bf16 B={B_SERVE} 2-10 s: request latency median "
        f"{med:.2f} ms ({', '.join(f'{x:.2f}' for x in lat)}), "
        f"{B_SERVE / med * 1e3:.1f} utt/s, launches per request "
        f"{per_req[0]}", card)
    report["serve"] = {"latency_ms": lat, "median_ms": med,
                       "utt_per_s": B_SERVE / med * 1e3,
                       "launches_per_request": per_req}
    phase_breakdown(server, reqs, layer_shapes, card, report)
    del server
    torch.cuda.empty_cache()

    # f32: the card against the same module on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("f32 card-vs-CPU check: cudnn.allow_tf32=False, "
        "matmul.allow_tf32=False")
    cfg32 = load_config(CFG)
    train = load_config(cfg32["task"]["train_config"])
    train["encoder"]["config"]["dtype"] = "float32"
    cfg32["task"]["train_config"] = train
    pcm, lens = requests(np.random.default_rng(SEED + 4), 1, 2, 2, 3)[0]
    out = []
    for dev in ("cuda", "cpu"):
        server = RnntServer(cfg32, device=dev, seed=SEED + 3)
        enc, enc_lens = server.encode(*server.featurize(pcm, lens))
        out.append((*server.decoder.decode(enc, enc_lens), enc, enc_lens))
    (tg, cg, eg, lg), (tc, cc, ec, lc) = out
    assert torch.equal(lg.cpu(), lc)
    err = check_close("f32 encoder card vs cpu", eg.cpu(), ec, **ENC_TOL)
    assert torch.equal(cg.cpu(), cc) and torch.equal(tg.cpu(), tc), \
        "f32 tokens differ between card and CPU"
    log(f"f32 B=2 3 s: encoder max abs err card vs CPU {err:.3g} (tol "
        f"{ENC_TOL}), {int(cc.sum())} tokens identical", card)
    report["f32_card_vs_cpu"] = {"enc_max_abs_err": err,
                                 "tokens": int(cc.sum())}
    return launches


# ------------------------------------------------------------ training
def rel_err(got, want):
    """max |got - want| over max |want|."""
    d = float((got.float() - want.float()).abs().max())
    return d / max(float(want.float().abs().max()), 1e-30)


def max_abs_score(q, k, qp, p):
    """The largest |score| before the clip, in f32."""
    from speech2text_torch.ops.attn_weights import toeplitz_index
    T, qd, pd = q.shape[1], q.shape[-1], qp.shape[-1]
    q, k, qp, p = (t.float() for t in (q, k, qp, p))
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(qd)
    s += torch.einsum("bthd,tshd->bhts", qp,
                      p[toeplitz_index(T, q.device)]) / math.sqrt(pd)
    return float(s.abs().max())


def phase_attn_grad(enc_cfg, card, report):
    """Phase 7: kernel B1's gradient on the card, then both kernels and
    B1's backward timed at the training shapes."""
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.tools.timing import (attn_inputs, events_ms,
                                                pad_mask_of, stack_shapes)
    qd, pd = enc_cfg["query_head_dim"], enc_cfg["pos_head_dim"]
    shapes = stack_shapes(enc_cfg, TRAIN_SECS * SR)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rng = np.random.default_rng(SEED + 6)
    errs, bad = {}, []
    for T, H in sorted(set(shapes)):
        B = 8
        mask = pad_mask_of(rng, B, T)
        for dt in (torch.bfloat16, torch.float32):
            q, k, qp, p = attn_inputs(gen, B, T, H, qd, pd, dt)
            dw = torch.randn((B, H, T, T), generator=gen,
                             device="cuda").to(dt)
            leaves = [t.clone().requires_grad_() for t in (q, k, qp, p)]
            aw.zip_weights(*leaves, mask, w_dtype=dt).backward(dw)
            fed = aw.attn_weights_backward(
                q, k, qp, p, aw.attn_weights_plain(q, k, qp, p, mask, dt),
                dw)
            # torch autograd through the plain f32 forward: the same where
            # no score reaches the ±100 clip and no row is fully masked
            # (JAX's backward, and so the port's, gives such a row's
            # uniform weights a gradient; the masked scores give none; in
            # the encoder those rows' cotangent is 0)
            score = max_abs_score(q, k, qp, p)
            assert score < 100.0, f"T={T}: |score| {score} reaches the clip"
            live = mask.any(-1)[:, None, :, None]
            dw_live = dw * live
            leaves_l = [t.clone().requires_grad_() for t in (q, k, qp, p)]
            aw.zip_weights(*leaves_l, mask, w_dtype=dt).backward(dw_live)
            leaves32 = [t.float().requires_grad_() for t in (q, k, qp, p)]
            aw.attn_weights_plain(*leaves32, mask, torch.float32).backward(
                dw_live.float())
            for name, g, f, gl, r in zip(("dq", "dk", "dqp", "dp"), leaves,
                                         fed, leaves_l, leaves32):
                assert g.grad.dtype == dt
                e = (rel_err(g.grad, f), rel_err(gl.grad, r.grad))
                errs[f"T={T},H={H},{dt},{name}"] = e
                if max(e) > GRAD_TOL[dt]:
                    bad.append((T, H, str(dt), name, e))
    worst = {str(dt): max(max(e) for key, e in errs.items()
                          if key.split(",")[2] == str(dt))
             for dt in (torch.bfloat16, torch.float32)}
    log(f"attn_weights gradient, B=8 at T {sorted(set(shapes))}: worst "
        f"error over the largest entry, kernel-fed vs plain-fed backward "
        f"and vs autograd of the plain f32 forward: {worst} (tolerance "
        f"{ {str(k): v for k, v in GRAD_TOL.items()} })", card)
    report["attn_weights_grad"] = errs
    assert not bad, f"attn_weights gradient out of tolerance: {bad}"

    # the training shapes: B=128, 10 s, bf16, pad mask
    timing, bwd, train_errs = {}, {}, []
    for T, H in sorted(set(shapes)):
        q, k, qp, p = attn_inputs(gen, B_TRAIN, T, H, qd, pd,
                                  torch.bfloat16)
        mask = pad_mask_of(rng, B_TRAIN, T)
        w = aw.attn_weights_cuda(q, k, qp, p, mask, torch.bfloat16)
        err = check_weights(f"attn_weights B={B_TRAIN} T={T} H={H} bf16",
                            w, q, k, qp, p, mask, torch.bfloat16)
        train_errs.append(err)
        timing[(T, H)] = attn_timing(q, k, qp, p, mask, card, err)
        dw = torch.randn(w.shape, generator=gen, device="cuda").to(w.dtype)
        bwd[(T, H)] = {"backward_ms": events_ms(
            lambda: aw.attn_weights_backward(q, k, qp, p, w, dw), iters=5)}
        log(f"attn_weights backward B={B_TRAIN} T={T} H={H} bf16 (plain "
            f"torch): {bwd[(T, H)]['backward_ms']:.4f} ms", card)
        del q, k, qp, p, w, dw
    summary = per_layer_sum(timing, shapes, enc_cfg,
                            ("ms", "host_ms", "plain_ms", "bound_ms"))
    summary.update(per_layer_sum(bwd, shapes, enc_cfg, ("backward_ms",)))
    summary["max_abs_err"] = max(train_errs)
    log(f"attn_weights per train step ({summary['layers']} launches, "
        f"B={B_TRAIN}, 10 s, bf16): forward device {summary['ms']:.4f} ms, "
        f"plain {summary['plain_ms']:.4f} ms, bound "
        f"{summary['bound_ms']:.4f} ms ({summary['bound_by']}); backward "
        f"{summary['backward_ms']:.4f} ms", card)
    report["attn_weights_train"] = {
        "per_shape": {f"T={T},H={H}": dict(v, **bwd[(T, H)])
                      for (T, H), v in timing.items()},
        "per_step": summary}
    torch.cuda.empty_cache()

    from speech2text_torch.data.frontend import Fbank
    from speech2text_torch.ops import fbank as fb
    fbank = Fbank().cuda()
    x = torch.from_numpy((0.1 * rng.standard_normal(
        (B_TRAIN, TRAIN_SECS * SR))).astype(np.float32)).cuda()
    cfg = fbank.cfg
    T = cfg.num_frames(x.shape[1])
    ops = (fbank.window, fbank.dft_cos, fbank.dft_sin, fbank.banks)
    kw = dict(frame_length=cfg.frame_length, frame_shift=cfg.frame_shift,
              preemph=cfg.preemphasis, remove_dc=cfg.remove_dc_offset)
    err = check_close("fbank B=128", fb.fbank_cuda(x, *ops, T, **kw),
                      fb.fbank_plain(x, *ops, T, **kw), **FBANK_TOL)
    fsum = fbank_timing(fbank, x, card, err)
    report["fbank_train"] = fsum
    return summary, fsum


def train_pcm(rng, B, lo_s, hi_s, U, vocab):
    """f32 PCM (B, hi_s·SR) with ragged lengths, labels (B, U)."""
    N = int(hi_s * SR)
    lens = ragged_lengths(rng, B, lo_s, hi_s, N)
    pcm = (0.1 * rng.standard_normal((B, N))).astype(np.float32)
    pcm[np.arange(N)[None] >= lens[:, None]] = 0.0
    labels = rng.integers(1, vocab, (B, U)).astype(np.int32)
    lab_lens = np.full((B,), U, np.int32)
    lab_lens[1:] = rng.integers(U // 2, U + 1, B - 1)
    return pcm, lens.astype(np.int32), labels, lab_lens


def phase_train_f32(card, report):
    """Phase 8: one f32 train step on the card and on the CPU."""
    from speech2text_torch.config import load_config
    from speech2text_torch.train.step import TrainStep
    cfg = load_config(TRAIN_CFG)
    cfg["encoder"]["config"].update(dtype="float32", dropout=0.0,
                                    feature_mask_dropout_prob=0.0)
    chunk = (32, 4)
    batch = train_pcm(np.random.default_rng(SEED + 7), 2, 2, 3, 12,
                      cfg["joiner"]["output_dim"])
    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        ts = TrainStep.from_config(cfg, device=dev, seed=SEED + 7)
        opt = ts.optimizer
        rms0 = {id(p): float(r) for gi, idxs in enumerate(opt.groups)
                for p, r in zip((opt.params[i] for i in idxs),
                                opt.param_rms[gi])}
        named = list(ts.model.named_parameters())
        out = ts.step(*batch, chunk=chunk)
        res[dev] = dict(
            losses={k: float(v) for k, v in out.items()},
            grads={n: p.grad.detach().cpu() for n, p in named},
            params={n: p.detach().cpu() for n, p in named},
            rms={n: rms0[id(p)] for n, p in named},
            lr=opt.lr_at(0), seconds=time.perf_counter() - t0)
    gpu, cpu = res["cuda"], res["cpu"]
    for k, v in cpu["losses"].items():
        assert abs(gpu["losses"][k] - v) <= STEP_LOSS_RTOL * abs(v), \
            f"f32 step {k}: card {gpu['losses'][k]} vs CPU {v}"
    # a key bias adds q·b/√qd to every score of a query row, which the
    # softmax ignores: its exact gradient is 0, and what both devices hold
    # is rounding noise, to be small next to the key weights' gradient
    shift_free = [n for n in cpu["grads"] if n.endswith("k_proj.bias")]
    for n in shift_free:
        w = n[:-len("bias")] + "weight"
        for r in (gpu, cpu):
            noise = float(r["grads"][n].abs().max())
            assert noise <= SHIFT_FREE_TOL * float(
                r["grads"][w].abs().max()), f"{n}: gradient {noise}"
    g_err = {n: rel_err(gpu["grads"][n], g) for n, g in cpu["grads"].items()
             if float(g.abs().max()) > 0 and n not in shift_free}
    bad = {n: e for n, e in g_err.items() if e > STEP_GRAD_TOL}
    assert not bad, f"f32 step gradients card vs CPU: {bad}"
    b1, eps = 0.9, 1e-8
    flips, n_el, worst = 0, 0, 0.0
    for n, want in cpu["params"].items():
        got = gpu["params"][n]
        # the first step moves each element by −lr·(1−β1)·scale·u(g),
        # u(g) = g/(|g|+eps) (v̂ = g²), scale = the tensor's rms at least
        # param_min_rms, or scalar_lr_scale for a scalar: the two devices'
        # parameters may differ by what their gradients' u differ by
        scale = 0.1 if want.numel() <= 1 else max(cpu["rms"][n], 1e-5)
        u = [g / (g.abs() + eps) for g in (gpu["grads"][n],
                                           cpu["grads"][n])]
        explained = cpu["lr"] * (1 - b1) * scale * (u[0] - u[1]).abs()
        tol = STEP_PARAM_TOL["atol"] + STEP_PARAM_TOL["rtol"] * want.abs()
        d = (got - want).abs()
        assert bool((d <= tol + explained * (1 + 1e-3)).all()), \
            f"f32 step param {n}: {float(d.max())} apart beyond what the " \
            f"gradients' difference explains"
        flips += int((d > tol).sum())
        n_el += want.numel()
        worst = max(worst, float(d.max()))
    log(f"f32 train step (flagship dims, dropout off, chunk {chunk}, B=2, "
        f"2-3 s): loss card {gpu['losses']['loss']:.6f} vs CPU "
        f"{cpu['losses']['loss']:.6f}; worst gradient error "
        f"{max(g_err.values()):.3g} of its largest entry (tol "
        f"{STEP_GRAD_TOL}; the {len(shift_free)} key biases, whose exact "
        f"gradient is 0, below {SHIFT_FREE_TOL} of the key weights'); "
        f"parameters: {flips} of {n_el} elements beyond "
        f"rtol 1e-4 / atol 1e-6, each within what the gradients' "
        f"difference moves the step by, max abs diff "
        f"{worst:.3g}; step time card {gpu['seconds']:.1f} s, CPU "
        f"{cpu['seconds']:.1f} s (set-up included)", card)
    report["train_f32_card_vs_cpu"] = {
        "losses": {d: r["losses"] for d, r in res.items()},
        "worst_grad_err": max(g_err.values()), "params_apart": flips,
        "params": n_el, "max_param_diff": worst}


SPANS = ("featurize", "encoder", "joiner_losses", "backward", "optimizer")
STREAM_SPANS = ("featurize", "encoder", "greedy")
# spans inside the step's: the data wait, the CTC and full-lattice RNN-T
# losses, the training dynamics' extra backward
EXTRA_SPANS = ("data", "ctc_loss", "rnnt_loss", "regularizers_backward")


def raw_events(prof):
    """(name, on the device, ms) of every event of a finished profile,
    read from the profiler's raw results: key_averages() and events()
    first build a Python event per op, which takes tens of seconds for a
    training step's ~10^4 ops."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.duration_ns() / 1e6)
            for e in prof.profiler.kineto_results.events()]


def profile_summary(prof, span_names=SPANS):
    """A profiled step's device rows (key, ms, count; kernels and copies,
    largest first), their busy ms, and the host ms of each span of
    `span_names`. The spans' GPU-side annotations cover kernels already
    counted and are left out of the rows."""
    device, spans = {}, {}
    for name, on_device, ms in raw_events(prof):
        if on_device:
            if ms > 0 and name not in SPANS + STREAM_SPANS + EXTRA_SPANS:
                total, n = device.get(name, (0.0, 0))
                device[name] = (total + ms, n + 1)
        elif name in span_names:
            spans[name] = spans.get(name, 0.0) + ms
    rows = sorted(((k, ms, n) for k, (ms, n) in device.items()),
                  key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows), spans


def spans_text(spans):
    return ", ".join(f"{name} {spans.get(name, float('nan')):.2f} ms"
                     for name in SPANS)


def bench_batch(vocab):
    """bench.py's batch on the card: B_TRAIN utterances of TRAIN_SECS s of
    noise, TRAIN_U labels each, from SEED."""
    rng = np.random.default_rng(SEED)
    N = TRAIN_SECS * SR
    pcm = torch.from_numpy((0.1 * rng.standard_normal((B_TRAIN, N)))
                           .astype(np.float32)).cuda()
    pcm_lens = torch.full((B_TRAIN,), N, dtype=torch.int32, device="cuda")
    labels = torch.from_numpy(rng.integers(1, vocab, (B_TRAIN, TRAIN_U))
                              .astype(np.int32)).cuda()
    lab_lens = torch.full((B_TRAIN,), TRAIN_U, dtype=torch.int32,
                          device="cuda")
    return pcm, pcm_lens, labels, lab_lens


def phase_train_bf16(card, report):
    """Phase 9: the flagship train step at bench.py's shape."""
    from torch.profiler import ProfilerActivity, profile

    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import fbank as fb
    from speech2text_torch.ops import rnnt as rn
    from speech2text_torch.train.step import TrainStep
    ts = TrainStep.from_config(TRAIN_CFG, device="cuda", seed=SEED)
    enc_cfg = ts.model.encoder.config
    assert enc_cfg.dtype == "bfloat16" and enc_cfg.dropout > 0
    batch = bench_batch(ts.model.joiner.config.output_dim)
    t0 = time.perf_counter()
    warm = ts.step(*batch)
    torch.cuda.synchronize()
    log(f"train warm-up step: {time.perf_counter() - t0:.2f} s, loss "
        f"{float(warm['loss']):.4f}")
    params = [p for p in ts.model.parameters()]
    before = [p.detach().clone() for p in params]
    torch.cuda.reset_peak_memory_stats()

    aw.KERNEL.launches = fb.KERNEL.launches = rn.KERNEL.launches = 0
    per_step, times, losses = [], [], []
    with PlainLatticeTrips() as trips:
        for _ in range(TRAIN_STEPS):
            k0 = (aw.KERNEL.launches, fb.KERNEL.launches, rn.KERNEL.launches)
            t0 = time.perf_counter()
            out = ts.step(*batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            per_step.append(tuple(
                k.launches - n for k, n in zip((aw.KERNEL, fb.KERNEL,
                                                rn.KERNEL), k0)))
            losses.append({k: float(v) for k, v in out.items()})
    launches = {"attn_weights": aw.KERNEL.launches,
                "fbank": fb.KERNEL.launches, "lattice": rn.KERNEL.launches,
                "plain_lattice_trips": trips.trips}
    peak = torch.cuda.max_memory_allocated()
    # B3: the simple loss's forward and backward, the pruned loss's
    expect = (sum(enc_cfg.num_encoder_layers), 1, 4)
    assert all(r == expect for r in per_step), \
        f"launches per train step (attn_weights, fbank, lattice): " \
        f"{per_step}, expected {expect}"
    assert trips.trips == 0, \
        f"{trips.trips} plain lattice diagonals in the timed steps"
    assert all(math.isfinite(v) for r in losses for v in r.values()), \
        f"non-finite train losses {losses}"
    changed = sum(not torch.equal(b, p) for b, p in zip(before, params))
    assert changed >= 0.9 * len(params), \
        f"only {changed} of {len(params)} parameter tensors changed"
    med = statistics.median(times)
    log(f"train step flagship bf16 B={B_TRAIN} x {TRAIN_SECS} s U={TRAIN_U}:"
        f" median {med:.2f} ms/step ({', '.join(f'{x:.2f}' for x in times)})"
        f", {B_TRAIN / med * 1e3:.2f} utt/s, peak memory {peak / 2**30:.2f} "
        f"GiB, launches per step {per_step[0]}, losses "
        f"{[round(r['loss'], 4) for r in losses]}; {changed} of "
        f"{len(params)} parameter tensors changed", card)

    parts = train_parts(ts, batch, card)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts.step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, busy, spans = profile_summary(prof)
    log(f"profiled train step: wall {wall:.2f} ms, device busy {busy:.2f} "
        f"ms ({100 * busy / wall:.1f}%), {sum(r[2] for r in rows)} device "
        f"ops; host time of its spans: {spans_text(spans)}", card)
    for key, ms, n in rows[:12]:
        log(f"  {ms:9.3f} ms  x{n:<6d} {key[:90]}", card)
    report["train_bf16"] = {
        "B": B_TRAIN, "seconds": TRAIN_SECS, "U": TRAIN_U,
        "ms_per_step": times, "median_ms": med,
        "utt_per_s": B_TRAIN / med * 1e3, "peak_memory_bytes": peak,
        "launches_per_step": per_step, "losses": losses,
        "changed_tensors": changed, "tensors": len(params),
        "parts_ms": parts, "profiled_wall_ms": wall,
        "device_busy_ms": busy, "span_host_ms": spans,
        "top_device_ops": rows[:30]}
    return launches


def train_parts(ts, batch, card):
    """Wall time of the step's parts at the step's shapes, each ended by a
    synchronise: featurize; the joiner with the simple loss and prune
    ranges, the pruned loss, and the backward of both down to the encoder
    and predictor outputs (the lattice losses); the optimizer step on the
    gradients the last step left. The encoder's forward and backward are
    the rest of the step. Medians of 3."""
    from speech2text_torch.tasks.rnnt import sample_chunk
    pcm, pcm_lens, labels, lab_lens = batch
    model = ts.model
    cs, lc = sample_chunk(model.encoder.config, ts.host_generator)
    sync = torch.cuda.synchronize
    times = {k: [] for k in ("featurize", "joiner_simple_ranges",
                             "pruned_loss", "losses_backward",
                             "optimizer")}
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        feats, feat_lens = ts.featurize(pcm, pcm_lens)
        sync()
        times["featurize"].append(time.perf_counter() - t0)
        with torch.no_grad():
            enc, enc_lens = model.encoder(feats, feat_lens, cs, lc,
                                          training=True,
                                          generator=ts.generator)
            pred = model.predictor(labels)
        enc.requires_grad_()
        pred.requires_grad_()
        sync()
        t0 = time.perf_counter()
        logits, ranges, simple = model.joiner(enc, enc_lens, pred,
                                              lab_lens, labels)
        sync()
        t1 = time.perf_counter()
        losses = ts.loss_fn({"logits": logits, "ranges": ranges,
                             "enc_lens": enc_lens, "simple_loss": simple},
                            labels, lab_lens)
        sync()
        t2 = time.perf_counter()
        losses["loss"].backward()
        sync()
        t3 = time.perf_counter()
        times["joiner_simple_ranges"].append(t1 - t0)
        times["pruned_loss"].append(t2 - t1)
        times["losses_backward"].append(t3 - t2)
        t0 = time.perf_counter()
        ts.optimizer.step()
        sync()
        times["optimizer"].append(time.perf_counter() - t0)
        del enc, pred, logits, losses
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    log("train step parts (median ms, synchronised): " + ", ".join(
        f"{k} {v:.2f}" for k, v in med.items()), card)
    return med


# ------------------------------------------------------------ phase 10
class KernelCalls(dict):
    """While open, every B1 and B2 launch is recorded here (under
    "attn_weights" and "fbank": a list of (arguments, output)); `close`
    puts the wrappers back and drops the records."""

    def __init__(self):
        from speech2text_torch.ops import attn_weights as aw
        from speech2text_torch.ops import fbank as fb
        super().__init__(attn_weights=[], fbank=[])
        self._wrapped = ((aw, "attn_weights_cuda", aw.attn_weights_cuda,
                          "attn_weights"),
                         (fb, "fbank_cuda", fb.fbank_cuda, "fbank"))
        for mod, attr, fn, name in self._wrapped:
            setattr(mod, attr, self._capture(name, fn))

    def _capture(self, name, fn):
        def wrapped(*args):
            out = fn(*args)
            self[name].append((tuple(a.detach() if isinstance(
                a, torch.Tensor) else a for a in args), out.detach()))
            return out
        return wrapped

    def close(self):
        for mod, attr, fn, _ in self._wrapped:
            setattr(mod, attr, fn)
        for v in self.values():
            v.clear()


def _finite_record(rec, keys):
    return all(k in rec and math.isfinite(float(rec[k])) for k in keys)


def _same_state(saved, live):
    """Bitwise equality of two nested dicts/lists of CPU tensors."""
    if isinstance(saved, dict):
        return saved.keys() == live.keys() and all(
            _same_state(saved[k], live[k]) for k in saved)
    if isinstance(saved, list):
        return len(saved) == len(live) and all(
            _same_state(a, b) for a, b in zip(saved, live))
    if isinstance(saved, torch.Tensor):
        return saved.dtype == live.dtype and torch.equal(saved, live.cpu())
    return saved == live


def check_run_shapes(trainer, card):
    """Kernels B1 and B2 held against their plain versions at the shapes
    the train run gives them: one epoch of a fresh train pipeline (one
    batch of each bucket shape), each batch a train step whose B1 calls
    (each layer's inputs and output) and B2 calls (the speech batch after
    add_noise, the noise batch) are captured and compared: B1 as
    check_weights does (TOL and half a bf16 ulp of the plain f32 weights,
    row sums, masked keys), B2 as check_mel does (the corpus's quiet bands
    near an utterance's end lie at rounding level, where the logs may
    differ by more than FBANK_TOL; the log-domain error is reported).
    Every batch is checked before the disagreements, if any, are raised
    together. Returns one row per batch."""
    from speech2text_torch.ops import fbank as fb
    task = trainer.task
    n_layers = sum(task.model.encoder.config.num_encoder_layers)
    pipe = task.make_train_pipeline(seed=trainer.seed,
                                    pin_memory=trainer.device.type == "cuda")
    specs = pipe.specs
    want = {(specs[b].batch_size, specs[b].pcm_len, specs[b].label_len)
            for b, _ in pipe.batcher.epoch_batches(0)}
    rows, failures = [], []

    def checked(fn, *args):
        try:
            return fn(*args)
        except AssertionError as e:
            failures.append(str(e))
            return math.nan

    it = iter(pipe)
    calls = KernelCalls()
    try:
        for i in range(pipe.batches_per_epoch()):
            batch = next(it)
            for v in calls.values():
                v.clear()
            out = trainer.train_step(trainer.to_device(batch), 10_000 + i)
            torch.cuda.synchronize()
            assert all(math.isfinite(float(v)) for v in out.values()), out
            shape = (int(batch["pcm"].shape[0]), int(batch["pcm"].shape[1]),
                     int(batch["label"].shape[1]))
            assert len(calls["attn_weights"]) == n_layers and \
                len(calls["fbank"]) == 2, \
                f"{shape}: {len(calls['attn_weights'])} B1 and " \
                f"{len(calls['fbank'])} B2 calls"
            row = {"B": shape[0], "N": shape[1], "U": shape[2],
                   "noise_N": int(batch["noise_pcm"].shape[1]),
                   "attn_T": sorted({int(a[0].shape[1])
                                     for a, _ in calls["attn_weights"]})}
            with torch.no_grad():
                row["attn_max_abs_err"] = max(
                    checked(check_weights, f"train run B1 {shape} layer {j}",
                            w, *a)
                    for j, (a, w) in enumerate(calls["attn_weights"]))
                for what, (a, got) in zip(("speech", "noise"),
                                          calls["fbank"]):
                    want_f = fb.fbank_plain(*a)
                    row[f"fbank_{what}_log_err"] = float(
                        (got - want_f).abs().max())
                    row[f"fbank_{what}_err_of_energy"] = checked(
                        check_mel, f"train run B2 {shape} {what}", got,
                        want_f)
            rows.append(row)
    finally:
        calls.close()
        it.close()
    for r in rows:
        log(f"train run kernels vs plain at B={r['B']} N={r['N']} U="
            f"{r['U']} (B1 T {r['attn_T']}, noise N={r['noise_N']}): B1 max "
            f"abs err {r['attn_max_abs_err']:.3g}; B2 speech "
            f"{r['fbank_speech_err_of_energy']:.3g} of the frame's mel energy"
            f" (log {r['fbank_speech_log_err']:.3g}), noise "
            f"{r['fbank_noise_err_of_energy']:.3g} (log "
            f"{r['fbank_noise_log_err']:.3g})", card)
    assert not failures, "\n".join(failures)
    seen = {(r["B"], r["N"], r["U"]) for r in rows}
    assert seen == want, f"bucket shapes checked {sorted(seen)}, the " \
        f"epoch's {sorted(want)}"
    return rows


def phase_train_run(card, report, tmp):
    """Phase 10: the flagship recipe trained from manifests through
    speech2text_torch.build_task's main on a synthetic corpus, its
    evaluations, checkpoints and resume, and one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from speech2text_torch import build_task
    from speech2text_torch.config import load_config
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import fbank as fb
    from speech2text_torch.tools.synth_corpus import write_corpus

    t0 = time.perf_counter()
    corpus = write_corpus(os.path.join(tmp, "corpus"), seed=SEED,
                          n_train=RUN_TRAIN_UTTS, n_eval=RUN_EVAL_UTTS,
                          n_noise=RUN_NOISE_CLIPS)
    corpus_s = time.perf_counter() - t0
    argv = ["--training_config", TRAIN_CFG,
            "--override", f"task.export_path={tmp}/tasks",
            "--override", f"dataset.base_dir={tmp}/corpus",
            "--override", f"trainer.val_check_interval={RUN_VAL_EVERY}",
            "--override", f"trainer.log_interval={RUN_LOG_EVERY}"]
    for key, path in corpus.items():
        argv += ["--override", f"dataset.{key}={path}"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    aw.KERNEL.launches = fb.KERNEL.launches = 0
    t0 = time.perf_counter()
    trainer = build_task.main(argv + ["--max_steps", str(RUN_STEPS)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"attn_weights": aw.KERNEL.launches,
                "fbank": fb.KERNEL.launches}
    peak = torch.cuda.max_memory_allocated()
    task = trainer.task
    workdir = trainer.workdir
    enc_cfg = task.model.encoder.config
    n_layers = sum(enc_cfg.num_encoder_layers)

    # the subword model was trained and is the task's tokenizer
    backup = load_config(os.path.join(workdir,
                                      os.path.basename(TRAIN_CFG)))
    spm = backup["tokenizer"]["config"]["spm_model"]
    assert spm == os.path.join(workdir, "spm", "tokenizer.model") and \
        os.path.exists(spm), f"subword model not trained: {spm}"
    assert type(task.tokenizer).__name__ == "SubwordTokenizer"
    vocab = task.model.joiner.config.output_dim
    assert len(task.tokenizer) == vocab, \
        f"{len(task.tokenizer)} labels for a joiner of {vocab}"
    # every logged line: JAX's keys, finite values
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines] == list(
        range(RUN_LOG_EVERY, RUN_STEPS + 1, RUN_LOG_EVERY)), lines
    bad = [r for r in lines if not _finite_record(r, RUN_KEYS)]
    assert not bad, f"metrics lines missing keys or not finite: {bad}"
    # two evaluations, each with finite validation losses and a WER
    evals = [h for h in trainer.history if h["eval_s"] > 0]
    assert [h["step"] for h in evals] == list(
        range(RUN_VAL_EVERY, RUN_STEPS + 1, RUN_VAL_EVERY)), evals
    with open(os.path.join(workdir, "checkpoints", "index.json")) as f:
        index = json.load(f)["checkpoints"]
    assert sorted(index, key=int) == [str(h["step"]) for h in evals]
    for step, m in index.items():
        assert _finite_record(m, ("val_loss", "val_simple_loss",
                                  "val_pruned_loss", "wer")), (step, m)
        assert os.path.exists(trainer.ckpt.path(int(step)))
    # launches: 12 B1 and 2 B2 (speech, noise) per step, 12 + 1 per eval
    # batch
    eval_batches = task.make_eval_pipeline().batches_per_epoch()
    n_eval = len(evals) * eval_batches
    want = {"attn_weights": n_layers * (RUN_STEPS + n_eval),
            "fbank": 2 * RUN_STEPS + n_eval}
    assert launches == want, f"launches {launches}, expected {want}"

    # time: host clock between step ends (no step synchronises), over the
    # steps after the first that follow no evaluation
    hist = trainer.history
    step_ms = [1e3 * (b["end"] - a["end"]) for a, b in zip(hist, hist[1:])
               if a["eval_s"] == 0.0]
    med = statistics.median(step_ms)
    waits = [1e3 * h["data_wait_s"] for h in hist]
    specs = task.make_train_pipeline().specs
    buckets = [(s.batch_size, s.pcm_len, s.label_len) for s in specs]
    log(f"train run (build_task main, flagship bf16, {RUN_TRAIN_UTTS} "
        f"utterances of 2-12 s, {RUN_STEPS} steps): {run_s:.1f} s "
        f"(corpus written in {corpus_s:.1f} s); median {med:.2f} ms/step "
        f"over {len(step_ms)} steps ({min(step_ms):.2f}-{max(step_ms):.2f});"
        f" loop's utt/s {[round(r['utts_per_sec'], 2) for r in lines]}, "
        f"frames/s {[round(r['frames_per_sec'], 1) for r in lines]}; "
        f"data wait median {statistics.median(waits):.3f} ms/step (max "
        f"{max(waits):.2f}); eval s {[round(h['eval_s'], 2) for h in evals]}"
        f" over {eval_batches} batches of 16; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches} (= {n_layers} B1 and 2"
        f" B2 per step, {n_layers} + 1 per eval batch)", card)
    rounded = {s: {k: round(v, 4) for k, v in m.items()}
               for s, m in index.items()}
    log(f"train run buckets (B, N samples, U): {buckets}; losses "
        f"{[round(r['loss'], 3) for r in lines]}; evals {rounded}", card)

    # resume: a fresh Trainer restores the saved step bitwise, then steps on
    trainer2, fit_kw = build_task.prepare(
        argv + ["--max_steps", str(RUN_STEPS + RUN_RESUME_STEPS)])
    assert trainer2.init_state(fit_kw["resume"],
                               fit_kw["finetune_state"]) == RUN_STEPS
    saved = trainer2.ckpt.restore(RUN_STEPS)
    assert _same_state(saved["model"], trainer2.task.model.state_dict()), \
        "restored weights differ from the checkpoint"
    assert _same_state(saved["optimizer"], trainer2.optimizer.state_dict()), \
        "restored ScaledAdam state differs from the checkpoint"
    assert saved["optimizer"]["step_count"] == RUN_STEPS
    trainer2.fit(**fit_kw)
    assert [h["step"] for h in trainer2.history] == list(
        range(RUN_STEPS + 1, RUN_STEPS + RUN_RESUME_STEPS + 1))
    last = trainer2.last_eval
    assert _finite_record(last, ("val_loss", "wer")), last
    log(f"resume: fresh Trainer restored step {RUN_STEPS} (weights and "
        f"ScaledAdam state bitwise equal to the file), took steps "
        f"{[h['step'] for h in trainer2.history]}, eval {last}", card)

    # one profiled step on the first batch of a fresh train pipeline
    pipe = task.make_train_pipeline(seed=trainer2.seed,
                                    pin_memory=trainer2.device.type == "cuda")
    it = iter(pipe)
    batch = next(it)
    it.close()
    dev = trainer2.to_device(batch)
    step = RUN_STEPS + RUN_RESUME_STEPS
    trainer2.train_step(dev, step)
    torch.cuda.synchronize()
    aw.KERNEL.launches = fb.KERNEL.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = trainer2.train_step(dev, step + 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per_step = {"attn_weights": aw.KERNEL.launches,
                "fbank": fb.KERNEL.launches}
    assert per_step == {"attn_weights": n_layers, "fbank": 2}, per_step
    assert all(math.isfinite(float(v)) for v in out.values()), out
    rows, busy, spans = profile_summary(prof)
    log(f"profiled run step (B={batch['pcm'].shape[0]}, N="
        f"{batch['pcm'].shape[1]}, U={batch['label'].shape[1]}): wall "
        f"{wall:.2f} ms, device busy {busy:.2f} ms ({100 * busy / wall:.1f}"
        f"%), {sum(r[2] for r in rows)} device ops, launches {per_step}; "
        f"host time of its spans: {spans_text(spans)}", card)

    shape_checks = check_run_shapes(trainer2, card)
    trainer2.close()
    worst = {"attn_weights": max(r["attn_max_abs_err"] for r in shape_checks),
             "fbank": max(max(r["fbank_speech_log_err"],
                              r["fbank_noise_log_err"])
                          for r in shape_checks)}
    report["train_run"] = {
        "steps": RUN_STEPS, "run_s": run_s, "corpus_s": corpus_s,
        "ms_per_step": step_ms, "median_ms": med,
        "metrics_lines": lines, "data_wait_ms": waits,
        "eval_s": [h["eval_s"] for h in evals], "eval_batches":
        eval_batches, "evals": index, "buckets": buckets,
        "peak_memory_bytes": peak, "launches": launches,
        "launches_per_step": per_step, "resume_eval": last,
        "profiled_step": {"B": int(batch["pcm"].shape[0]),
                          "N": int(batch["pcm"].shape[1]),
                          "wall_ms": wall, "device_busy_ms": busy,
                          "span_host_ms": spans,
                          "top_device_ops": rows[:30]},
        "kernel_checks": shape_checks, "max_abs_err": worst}
    del trainer, trainer2, task
    torch.cuda.empty_cache()
    return launches, per_step, worst, {"workdir": workdir, "corpus": corpus}


# ------------------------------------------------------------ phase 11
def check_batch_calls(calls, label, n_layers):
    """One test batch's B1 calls (one per layer) and B2 call against the
    plain versions, as phase 10 holds them; returns the worst errors (B1
    abs, B2 log-domain) and each B1 call's mask."""
    from speech2text_torch.ops import fbank as fb
    assert len(calls["attn_weights"]) == n_layers and \
        len(calls["fbank"]) == 1, f"{label}: " \
        f"{len(calls['attn_weights'])} B1 and {len(calls['fbank'])} B2 calls"
    with torch.no_grad():
        b1 = max(check_weights(f"{label} B1 layer {j}", w, *a)
                 for j, (a, w) in enumerate(calls["attn_weights"]))
        (a, got), = calls["fbank"]
        want = fb.fbank_plain(*a)
        check_mel(f"{label} B2", got, want)
        b2 = float((got - want).abs().max())
    return {"attn_weights": b1, "fbank": b2}, \
        [a[4] for a, _ in calls["attn_weights"]]


def device_batches(task, device):
    """The task's test batches, on `device`."""
    from speech2text_torch.inference import to_device
    return [to_device(b, device) for b in task.make_test_pipeline()]


def infer_parts(task, batches):
    """Per test batch, each part ended by a synchronise: featurize, the
    encoder (chunk-masked under encoder_streaming), decode. Returns the
    seconds of each part per batch and the hypotheses' token counts."""
    sync = torch.cuda.synchronize
    parts = {"featurize": [], "encode": [], "decode": []}
    tokens = 0
    with torch.no_grad():
        for batch in batches:
            sync()
            t0 = time.perf_counter()
            feats, lens = task.featurize(batch)
            sync()
            t1 = time.perf_counter()
            enc, enc_lens = task.model.encoder(feats, lens, *task.streaming)
            sync()
            t2 = time.perf_counter()
            _, counts = task.decode_session.decode(enc, enc_lens)
            sync()
            t3 = time.perf_counter()
            for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[k].append(v)
            tokens += int(counts.sum())
    return parts, tokens


def same_tokens(task, dec_a, dec_b, batches, what):
    """Two decoders on each test batch's encoder output (the task's
    model): identical tokens and counts; returns the tokens emitted."""
    n = 0
    for batch in batches:
        enc = task.eval_forward(batch, losses=False)
        a = dec_a.decode(enc["enc"], enc["enc_lens"])
        b = dec_b.decode(enc["enc"], enc["enc_lens"])
        assert all(torch.equal(x, y) for x, y in zip(a, b)), what
        n += int(a[1].sum())
    return n


def run_inference(name, argv, card, n_layers, fbank_per_batch=1):
    """speech2text_torch.inference's main with the kernel counts set to 0
    just before it and read just after; checks the report (a block for
    every row of every test batch, which covers each eval utterance: the
    bucketed test pipeline, as JAX's, tops a bucket's last batch up with
    repeats; a finite corpus WER) and the launches (n_layers B1 and
    `fbank_per_batch` B2 per test batch)."""
    from speech2text_torch import inference
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import fbank as fb
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    aw.KERNEL.launches = fb.KERNEL.launches = 0
    t0 = time.perf_counter()
    run = inference.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"attn_weights": aw.KERNEL.launches,
                "fbank": fb.KERNEL.launches}
    run.update(wall_s=wall, launches=launches,
               peak=torch.cuda.max_memory_allocated())
    with open(run["report"]) as f:
        lines = f.read().splitlines()
    last = lines[-1]
    utts = [line for line in lines if line.startswith("utt: ")]
    assert len(utts) == run["num_utts"] and \
        len(set(utts)) == RUN_EVAL_UTTS, \
        f"{name}: {len(utts)} report blocks of {len(set(utts))} utterances"
    assert last == f"corpus wer: {run['wer']:.4f} ({len(utts)} utts)" \
        and math.isfinite(run["wer"]), f"{name}: {last!r}"
    want = {"attn_weights": n_layers * run["batches"],
            "fbank": fbank_per_batch * run["batches"]}
    assert launches == want, f"{name}: launches {launches}, expected {want}"
    log(f"infer {name}: inference.main {wall:.2f} s for {run['batches']} "
        f"test batches, corpus WER {run['wer']:.4f}, peak memory "
        f"{run['peak'] / 2**30:.2f} GiB, launches {launches}", card)
    return run


def timed_parts(name, task, batches, card, report):
    parts, tokens = infer_parts(task, batches)
    per = {k: statistics.mean(v) for k, v in parts.items()}
    total = sum(per.values())
    utts = sum(int(b["pcm"].shape[0]) for b in batches)
    log(f"infer {name}: s per test batch (mean of {len(batches)}, B "
        f"{[int(b['pcm'].shape[0]) for b in batches]}): featurize "
        f"{per['featurize']:.4f}, encode {per['encode']:.4f}, decode "
        f"{per['decode']:.4f}, total {total:.4f} (decode "
        f"{100 * per['decode'] / total:.1f} %); "
        f"{utts / (total * len(batches)):.2f} utt/s; {tokens} tokens", card)
    report[name] = {"parts_s": parts, "mean_s": per, "total_s": total,
                    "utt_per_s": utts / (total * len(batches)),
                    "tokens": tokens}


def phase_infer(card, report, tmp, trained):
    """Phase 11: decode phase 10's eval set with phase 10's checkpoints
    through speech2text_torch.inference's main."""
    from torch.profiler import ProfilerActivity, profile

    from speech2text_torch.config import load_config
    from speech2text_torch.models.rnn_lm import RnnLm, RnnLmConfig
    from speech2text_torch.serve import RnntServer
    from speech2text_torch.tasks.rnnt import RnntModel, decoding_of
    from speech2text_torch.train.checkpoint import CheckpointManager
    out = {}
    train_cfg = os.path.join(trained["workdir"], os.path.basename(TRAIN_CFG))

    def argv(cfg, name, *extra):
        args = ["--inference_config", cfg,
                "--override", f"task.train_config={train_cfg}",
                "--override", f"task.export_path={tmp}/infer/{name}",
                "--override",
                f"testset.test_data={trained['corpus']['eval_data']}"]
        for ov in extra:
            args += ["--override", ov]
        return args

    # (a) the flagship beam YAML: averaged checkpoints, W=4, K=4
    beam = run_inference("beam", argv(BEAM_CFG, "beam"), card,
                         RUN_LAYERS)
    task = beam["task"]
    n_layers = sum(task.model.encoder.config.num_encoder_layers)
    assert n_layers == RUN_LAYERS
    metric = beam["train_config"]["metric"]
    assert metric["decode_method"] == "rnnt_beam_search" and \
        (metric["beam_size"], metric["cutoff_top_k"]) == (4, 4)
    assert beam["infer_config"]["task"]["chkpt_aver"]
    batches = device_batches(task, beam["device"])
    seeded_model = RnntModel.from_config(beam["train_config"])
    seeded_model.init_weights(torch.Generator().manual_seed(SEED + 14))
    seeded = seeded_model.state_dict()
    calls = KernelCalls()
    try:
        task.eval_forward(batches[-1], losses=False)
        errs, masks = check_batch_calls(calls, "infer test batch",
                                        n_layers)
    finally:
        calls.close()
    assert all(torch.equal(m, m.transpose(1, 2)) for m in masks), \
        "full-context B1 masks are not symmetric"
    timed_parts("beam", task, batches, card, out)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = task.eval_forward(batches[-1], losses=False)
        task.decode_session.decode(enc["enc"], enc["enc_lens"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, busy, _ = profile_summary(prof)
    log(f"profiled beam test batch (B={batches[-1]['pcm'].shape[0]}, N="
        f"{batches[-1]['pcm'].shape[1]}): wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(r[2] for r in rows)} device ops", card)
    for key, ms, n in rows[:8]:
        log(f"  {ms:8.3f} ms  x{n:<6d} {key[:90]}", card)
    out["profiled_beam_batch"] = {"wall_ms": wall, "device_busy_ms": busy,
                                  "top_device_ops": rows[:20]}

    # (b) greedy through the same entry and checkpoint selection; (c) beam
    # at W=1, K=1 gives the greedy tokens on the same encoder output
    greedy = run_inference("greedy", argv(CFG, "greedy"), card, n_layers)
    gtask = greedy["task"]
    timed_parts("greedy", gtask, batches, card, out)
    beam1 = decoding_of({"decode_method": "rnnt_beam_search",
                         "beam_size": 1, "cutoff_top_k": 1}, gtask.model,
                        None, 0.0)
    what = "beam W=1, K=1 tokens differ from greedy's"
    n_trained = same_tokens(gtask, gtask.decode_session, beam1, batches,
                            what)
    gtask.model.load_state_dict(seeded)
    n_seeded = same_tokens(gtask, gtask.decode_session, beam1, batches,
                           what)
    assert n_seeded > 0, "the seeded model emitted no token"
    log(f"infer beam W=1 K=1 = greedy (bf16), tokens identical over "
        f"{len(batches)} test batches: {n_trained} with phase 10's "
        f"weights, {n_seeded} with seeded weights", card)
    del greedy, gtask

    # (d) f32 beam W=4 on the card against the same module on the CPU
    cfg32 = load_config(BEAM_CFG)
    train32 = load_config(train_cfg)
    train32["encoder"]["config"]["dtype"] = "float32"
    cfg32["task"]["train_config"] = train32
    pcm, lens = requests(np.random.default_rng(SEED + 11), 1, 2, 2, 3)[0]
    dev_out = []
    for dev in ("cuda", "cpu"):
        server = RnntServer(cfg32, device=dev, seed=SEED + 12)
        assert server.decoder._W == 4
        dev_out.append(server.transcribe(pcm, lens))
    (tg, cg), (tc, cc) = dev_out
    assert torch.equal(cg.cpu(), cc) and torch.equal(tg.cpu(), tc), \
        "f32 beam tokens differ between card and CPU"
    log(f"infer f32 beam W=4 B=2 3 s: {int(cc.sum())} tokens identical on "
        f"the card and the CPU", card)
    del server

    # (e) shallow fusion with a seeded RnnLm at rnn_lm.yaml's dims
    lm_dims = load_config(LM_CFG)["lm"]["config"]
    vocab = task.model.joiner.config.output_dim
    lm = RnnLm(RnnLmConfig(num_symbols=vocab, **lm_dims))
    lm.init_weights(torch.Generator().manual_seed(SEED + 13))
    lm_dir = os.path.join(tmp, "lm", "checkpoints")
    CheckpointManager(lm_dir, monitor="acc", mode="max").save(
        1, {"model": lm.state_dict(), "step": 1, "seed": SEED + 13},
        {"acc": 0.5})
    fused = run_inference(
        "beam+lm", argv(BEAM_CFG, "beam_lm",
                        f"decoding.config.lm_fusion.checkpoint_dir={lm_dir}",
                        f"decoding.config.lm_fusion.lm_weight={LM_WEIGHT}",
                        *(f"decoding.config.lm_fusion.lm_config.{k}={v}"
                          for k, v in lm_dims.items())), card, n_layers)
    ftask = fused["task"]
    assert ftask.lm is not None and ftask.decode_session._lm_weight == \
        LM_WEIGHT
    timed_parts("beam_lm", ftask, batches, card, out)
    zero = decoding_of(metric, ftask.model, ftask.lm, 0.0)
    plain = decoding_of(metric, ftask.model, None, 0.0)
    what = "lm_weight 0 tokens differ from unfused decoding"
    n_trained = same_tokens(ftask, zero, plain, batches, what)
    ftask.model.load_state_dict(seeded)
    n_seeded = same_tokens(ftask, zero, plain, batches, what)
    assert n_seeded > 0, "the seeded model emitted no token"
    moved = 0
    for batch in batches:
        enc = ftask.eval_forward(batch, losses=False)
        a = ftask.decode_session.decode(enc["enc"], enc["enc_lens"])
        b = plain.decode(enc["enc"], enc["enc_lens"])
        moved += int(((a[0] != b[0]).any(1) | (a[1] != b[1])).sum())
    rows = sum(int(b["pcm"].shape[0]) for b in batches)
    log(f"infer beam+lm: lm_weight 0 gives the unfused tokens ({n_trained} "
        f"with phase 10's weights, {n_seeded} with seeded weights); "
        f"lm_weight {LM_WEIGHT} changes {moved} of {rows} rows' tokens "
        f"with seeded weights; corpus WER {fused['wer']:.4f} against "
        f"{beam['wer']:.4f} unfused", card)
    out["lm_rows_changed"] = [moved, rows]
    del fused, ftask, zero, plain

    # (f) simulated streaming: B1 launched with the chunk mask
    stream = run_inference("streaming", argv(
        BEAM_CFG, "streaming", "streaming.is_encoder_streaming=true"),
        card, n_layers)
    stask = stream["task"]
    assert stask.streaming == (32, 4)
    calls = KernelCalls()
    try:
        stask.eval_forward(batches[-1], losses=False)
        serrs, masks = check_batch_calls(calls, "streaming test batch",
                                         n_layers)
    finally:
        calls.close()
    chunked = sum(not torch.equal(m, m.transpose(1, 2)) for m in masks)
    assert chunked == n_layers, \
        f"{chunked} of {n_layers} B1 launches carried a chunk mask"
    log(f"infer streaming: every B1 launch of a test batch carried the "
        f"chunk mask (32 frames, 4 chunks left); corpus WER "
        f"{stream['wer']:.4f} against {beam['wer']:.4f} full context", card)
    del stream, stask
    worst = {k: max(errs[k], serrs[k]) for k in errs}
    log(f"infer kernels vs plain on a test batch: B1 "
        f"{worst['attn_weights']:.3g}, B2 log {worst['fbank']:.3g}", card)
    out.update(
        batches=beam["batches"], wer={"beam": beam["wer"]},
        main_wall_s={"beam": beam["wall_s"]},
        peak_memory_bytes=beam["peak"], launches=beam["launches"],
        max_abs_err=worst)
    report["infer"] = out
    per_batch = {k: v // beam["batches"] for k, v in beam["launches"].items()}
    launches = beam["launches"]
    del beam, task
    torch.cuda.empty_cache()
    return launches, per_batch, worst


# ------------------------------------------------------------ phase 12
def stream_audio(corpus, B, n):
    """B streams of n samples cut from the synthetic eval set's wavs, read
    in order, joined and repeated as needed (f32 in [-1, 1))."""
    from speech2text_torch.data.audio import read_wav
    from speech2text_torch.data.manifest import load_manifest
    pcm = np.concatenate([read_wav(e["audio_filepath"])[0] for e in
                          load_manifest(corpus["eval_data"])])
    pcm = np.tile(pcm, -(-B * n // len(pcm)))
    return pcm[:B * n].reshape(B, n).astype(np.float32)


def stream_samples(sess, secs):
    """The longest prime + k·step samples within `secs` seconds."""
    k = (int(secs * SR) - sess.prime_samples) // sess.step_samples
    return sess.prime_samples + k * sess.step_samples


def stream_chunks(sess, pcm):
    """The session over (B, N) PCM of prime + k·step samples → (final
    state, each chunk's encoder output)."""
    state = sess.prime(pcm[:, :sess.prime_samples], sess.init_state(
        pcm.shape[0]))
    outs = [state["enc_out"]]
    for off in range(sess.prime_samples, pcm.shape[1], sess.step_samples):
        state = sess.step(pcm[:, off:off + sess.step_samples], state)
        outs.append(state["enc_out"])
    return state, outs


def offline_decode(task, pcm, chunk):
    """The offline chunk-masked decode of the whole PCM (B2 featurize, the
    chunk-masked encoder, greedy): (enc, enc_lens, tokens, counts)."""
    B, n = pcm.shape
    task.streaming = (chunk, STREAM_LEFT)
    dev = next(task.parameters()).device
    batch = {"pcm": torch.from_numpy(pcm).to(dev),
             "pcm_length": torch.full((B,), n, dtype=torch.int32,
                                      device=dev)}
    out = task.eval_forward(batch, losses=False)
    tokens, counts = task.decode_session.decode(out["enc"], out["enc_lens"])
    return out["enc"], out["enc_lens"], tokens, counts


def stream_tasks(trained):
    """The flagship task (phase 10's YAML and subword model) in bf16 and in
    f32, with the same seeded weights, on the card."""
    from speech2text_torch.inference import inference_train_config
    from speech2text_torch.tasks.rnnt import PrunedRnntTask
    path = os.path.join(trained["workdir"], os.path.basename(TRAIN_CFG))
    cfg = inference_train_config({"task": {"train_config": path}})
    cfg["metric"] = {"decode_method": "rnnt_greedy_search",
                     "max_token_step": 1, "encoder_streaming": True,
                     "streaming_chunk_size": 32,
                     "streaming_left_chunks": STREAM_LEFT}
    task16 = PrunedRnntTask(cfg)
    task16.model.init_weights(torch.Generator().manual_seed(SEED + 14))
    cfg32 = json.loads(json.dumps(cfg))
    cfg32["encoder"]["config"]["dtype"] = "float32"
    task32 = PrunedRnntTask(cfg32)
    task32.model.load_state_dict(task16.model.state_dict())
    assert task16.model.encoder.config.dtype == "bfloat16"
    return task16.to("cuda").eval(), task32.to("cuda").eval(), path


def rms(x):
    return float(torch.sqrt(torch.mean(torch.square(x.float()))))


def phase_stream(card, report, trained):
    """Phase 12: true streaming of the flagship (StreamingAsrSession) on
    the card: (a) f32 parity, (b) bf16 at chunks 16/32/64 with every B2
    call held to the plain version, (c) latency at B=1 and B=16, (d) the
    stream demo entry."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import fbank as fb
    from speech2text_torch.streaming import StreamingAsrSession
    from speech2text_torch.tools import stream_demo
    from speech2text_torch.tools.timing import TRACES, kernel_durations_ms
    out = {}
    task16, task32, train_cfg = stream_tasks(trained)
    corpus = trained["corpus"]

    # (a) f32 on the card: tokens equal the offline chunk-masked decode and
    # the same session on the CPU; each chunk's encoder output within
    # ENC_TOL of the offline encoder's frames
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sess = StreamingAsrSession(task32, chunk_size=32,
                               left_context_chunks=STREAM_LEFT,
                               device="cuda")
    pcm = stream_audio(corpus, 2, stream_samples(sess, STREAM_SECS))
    t0 = time.perf_counter()
    state, outs = stream_chunks(sess, pcm)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    enc, enc_lens, tokens, counts = offline_decode(task32, pcm, 32)
    f = 32 // task32.model.encoder.config.output_downsampling_factor
    assert int(enc_lens.min()) == f * len(outs) == enc.shape[1], \
        (enc_lens, len(outs))
    enc_err = max(check_close(f"f32 stream chunk {i} encoder", o,
                              enc[:, i * f:(i + 1) * f], **ENC_TOL)
                  for i, o in enumerate(outs))
    n_tok = int(counts.sum())
    assert n_tok > 0, "the seeded model emitted no token"
    assert torch.equal(state["counts"], counts.long()) and \
        torch.equal(state["tokens"], tokens.long()), \
        "f32 streaming tokens differ from the offline chunk-masked decode"
    cpu_task = copy.deepcopy(task32).to("cpu")
    cpu_sess = StreamingAsrSession(cpu_task, chunk_size=32,
                                   left_context_chunks=STREAM_LEFT,
                                   device="cpu")
    t0 = time.perf_counter()
    cpu_state, _ = stream_chunks(cpu_sess, pcm)
    cpu_s = time.perf_counter() - t0
    assert torch.equal(cpu_state["counts"], state["counts"].cpu()) and \
        torch.equal(cpu_state["tokens"], state["tokens"].cpu()), \
        "f32 streaming tokens differ between the card and the CPU"
    log(f"stream f32 B=2 {pcm.shape[1] / SR:.3f} s, chunk 32, "
        f"{STREAM_LEFT} left chunks, {len(outs)} chunks: {n_tok} tokens "
        f"identical to the offline chunk-masked decode and to the CPU "
        f"session; encoder per chunk max abs err {enc_err:.3g} (tol "
        f"{ENC_TOL}); {card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU",
        card)
    out["f32"] = {"chunks": len(outs), "tokens": n_tok,
                  "enc_max_abs_err": enc_err, "card_s": card_s,
                  "cpu_s": cpu_s}
    del cpu_sess, cpu_task

    # (b) bf16 at the chunks the flagship trains on: 1 B2 and 0 B1 launch
    # per chunk (wrapper counts and the trace), every B2 call against the
    # plain version, the encoder against the offline one, the tokens
    bf16 = {}
    worst_mel = worst_log = 0.0
    for chunk in STREAM_CHUNKS:
        sess = StreamingAsrSession(task16, chunk_size=chunk,
                                   left_context_chunks=STREAM_LEFT,
                                   device="cuda")
        pcm = stream_audio(corpus, 2, stream_samples(sess, STREAM_SECS))
        stream_chunks(sess, pcm[:, :sess.prime_samples + sess.step_samples])
        torch.cuda.synchronize()
        calls = KernelCalls()
        try:
            # the tracer drops a kernel's record now and then (timing.py):
            # a trace missing more than a tenth of B2's records is taken
            # again, up to TRACES runs, each with its counts checked
            for trace in range(1, TRACES + 1):
                for v in calls.values():
                    v.clear()
                aw.KERNEL.launches = fb.KERNEL.launches = 0
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    state, outs = stream_chunks(sess, pcm)
                    torch.cuda.synchronize()
                launches = (aw.KERNEL.launches, fb.KERNEL.launches)
                n = len(outs)
                assert launches == (0, n), \
                    f"chunk {chunk}: (B1, B2) launches {launches} for " \
                    f"{n} chunks"
                assert len(calls["fbank"]) == n and not calls["attn_weights"]
                traced = (len(kernel_durations_ms(prof, aw.KERNEL.name)),
                          len(kernel_durations_ms(prof, fb.KERNEL.name)))
                if traced[1] >= n - n // 10:
                    break
                log(f"stream bf16 chunk {chunk}: trace {trace} holds (B1, "
                    f"B2) records {traced} of (0, {n}) launches", card)
            assert traced[0] == 0 and n - n // 10 <= traced[1] <= n, \
                f"chunk {chunk}: the trace holds (B1, B2) {traced} in " \
                f"each of {TRACES} runs"
            frames = set()
            for i, (a, got) in enumerate(calls["fbank"]):
                want = fb.fbank_plain(*a)
                worst_mel = max(worst_mel, check_mel(
                    f"stream chunk {chunk} B2 call {i}", got, want))
                worst_log = max(worst_log, float((got - want).abs().max()))
                frames.add(int(got.shape[1]))
        finally:
            calls.close()
        s16 = torch.cat(outs, 1)
        enc, enc_lens, tokens, counts = offline_decode(task16, pcm, chunk)
        enc32, _, _, _ = offline_decode(task32, pcm, chunk)
        assert s16.shape == enc.shape and bool(torch.isfinite(s16).all())
        ratio = rms(s16 - enc32) / rms(enc - enc32)
        assert ratio <= BF16_STREAM_RMS_RATIO, \
            f"chunk {chunk}: bf16 streaming is {ratio:.3f}x as far from " \
            f"the f32 encoder as the offline bf16 encoder"
        rows_equal = int(((state["tokens"] == tokens.long()).all(1)
                          & (state["counts"] == counts.long())).sum())
        n_stream, n_off = int(state["counts"].sum()), int(counts.sum())
        assert n_stream > 0 and n_off > 0, "no token emitted"
        bf16[chunk] = {
            "chunks": n, "pcm_samples": pcm.shape[1],
            "fbank_frames": sorted(frames), "launches": list(launches),
            "traced": list(traced), "traces": trace,
            "enc_max_abs_diff": float((s16 - enc).abs().max()),
            "enc_rel_rms_diff": rms(s16 - enc) / rms(enc),
            "rms_ratio_vs_f32": ratio, "rows_equal": rows_equal,
            "tokens_stream": n_stream, "tokens_offline": n_off}
        log(f"stream bf16 B=2 chunk {chunk}: {n} chunks, (B1, B2) launches "
            f"{launches}, traced {traced} (trace {trace}), B2 frames {sorted(frames)} held "
            f"to the plain version; encoder vs offline bf16 max abs diff "
            f"{bf16[chunk]['enc_max_abs_diff']:.3g}, rel RMS "
            f"{bf16[chunk]['enc_rel_rms_diff']:.3g}, distance to f32 "
            f"{ratio:.3f}x the offline bf16's (limit "
            f"{BF16_STREAM_RMS_RATIO}); rows with equal tokens {rows_equal}"
            f"/2, tokens {n_stream} streamed vs {n_off} offline", card)
    out["bf16"] = bf16

    # (c) latency at chunk 32: B=1 and B=16, the prime apart, then one
    # profiled steady chunk; B2's device time per chunk beside its bound
    sess = StreamingAsrSession(task16, chunk_size=32,
                               left_context_chunks=STREAM_LEFT,
                               device="cuda")
    n = sess.prime_samples + STREAM_TIMED_CHUNKS * sess.step_samples
    latency = {}
    for B in (1, 16):
        pcm = stream_audio(corpus, B, n)
        sess.run_utterance(pcm[:, :sess.prime_samples
                               + 2 * sess.step_samples])
        texts, lat = sess.run_utterance(pcm, measure_latency=True)
        summ = stream_demo.latency_summary(lat, sess.chunk_ms)
        state, _ = stream_chunks(sess, pcm[:, :sess.prime_samples
                                           + sess.step_samples])
        step_pcm = torch.from_numpy(pcm[:, :sess.step_samples]).cuda()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sess.step(step_pcm, state)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows, busy, spans = profile_summary(prof, STREAM_SPANS)
        ops = sum(r[2] for r in rows)
        x = torch.cat([state["pcm_tail"], step_pcm], 1)
        timing = fbank_timing(task16.frontend, x, card, worst_log)
        latency[B] = dict(summ, chunks=len(lat), latency_ms=lat,
                          profiled_wall_ms=wall, device_busy_ms=busy,
                          device_ops=ops, span_host_ms=spans,
                          top_device_ops=rows[:12], fbank=timing)
        log(f"stream latency bf16 chunk 32 B={B}, {len(lat)} chunks of "
            f"{sess.chunk_ms:.0f} ms: first (prime) {summ['first_ms']:.2f} "
            f"ms, steady p50 {summ['p50_ms']:.2f} / p95 "
            f"{summ['p95_ms']:.2f} / max {summ['max_ms']:.2f} ms, RTF "
            f"{summ['rtf']:.4f}; profiled chunk {wall:.2f} ms wall, device "
            f"busy {busy:.2f} ms ({100 * busy / wall:.1f}%), {ops} device "
            f"ops, host spans featurize {spans.get('featurize', 0):.2f} / "
            f"encoder {spans.get('encoder', 0):.2f} / greedy "
            f"{spans.get('greedy', 0):.2f} ms; B2 {timing['ms']:.4f} ms "
            f"device per chunk, bound {timing['bound_ms']:.4f} ms", card)
        for key, ms, cnt in rows[:6]:
            log(f"  {ms:8.3f} ms  x{cnt:<5d} {key[:90]}", card)
    out["latency"] = latency

    # (d) the demo entry on a wav of the corpus with phase 10's checkpoints
    from speech2text_torch.data.manifest import load_manifest
    wav = max(load_manifest(corpus["eval_data"]),
              key=lambda e: e["duration"])["audio_filepath"]
    aw.KERNEL.launches = fb.KERNEL.launches = 0
    demo = stream_demo.main([
        "--train_config", train_cfg, "--wav", wav,
        "--checkpoints_dir", os.path.join(trained["workdir"],
                                          "checkpoints")])
    torch.cuda.synchronize()
    (res,) = demo["results"]
    launches = {"attn_weights": aw.KERNEL.launches,
                "fbank": fb.KERNEL.launches}
    n_chunks = len(res["latency_ms"])
    assert launches == {"attn_weights": 0, "fbank": n_chunks}, \
        f"stream demo launches {launches} for {n_chunks} chunks"
    assert all(math.isfinite(v) for v in res["summary"].values())
    log(f"stream demo on {os.path.basename(wav)} ({res['seconds']:.2f} s, "
        f"{n_chunks} chunks, phase 10's checkpoints): launches {launches}, "
        f"steady p50 {res['summary']['p50_ms']:.2f} ms, transcript "
        f"{res['text']!r}", card)
    out["demo"] = {"wav": wav, "launches": launches,
                   "summary": res["summary"], "text": res["text"]}
    out["fbank_worst"] = {"mel_energy_share": worst_mel, "log": worst_log}
    report["stream"] = out
    del task16, task32, sess, demo
    torch.cuda.empty_cache()
    return {"attn_weights": dict(
                launches=launches["attn_weights"],
                launches_per_chunk=launches["attn_weights"] / n_chunks),
            "fbank": dict(launches=launches["fbank"],
                          launches_per_chunk=launches["fbank"] / n_chunks,
                          max_abs_err=worst_log,
                          **{k: latency[1]["fbank"][k] for k in (
                              "ms", "host_ms", "plain_ms", "bound_ms",
                              "bound_by")},
                          ms_b16=latency[16]["fbank"]["ms"],
                          bound_ms_b16=latency[16]["fbank"]["bound_ms"])}


# ------------------------------------------------------------ phase 13
def check_fbank_calls(calls, label):
    """Every captured B2 call against the plain version (check_mel);
    returns (calls checked, the worst log-domain error, the worst error as
    a share of its frame's mel energy) and drops the records."""
    from speech2text_torch.ops import fbank as fb
    assert not calls["attn_weights"], \
        f"{label}: {len(calls['attn_weights'])} B1 calls"
    worst_log = worst_energy = 0.0
    with torch.no_grad():
        for i, (a, got) in enumerate(calls["fbank"]):
            want = fb.fbank_plain(*a)
            worst_energy = max(worst_energy,
                               check_mel(f"{label} B2 call {i}", got, want))
            worst_log = max(worst_log, float((got - want).abs().max()))
    n = len(calls["fbank"])
    for v in calls.values():
        v.clear()
    return n, worst_log, worst_energy


def counted_main(fn, argv):
    """`fn(argv)` (build_task's or inference's main) with the kernel
    counts set to 0 just before it and read just after, and every kernel
    call captured; returns (its result, wall s, launches, peak memory,
    captured calls: check and close them)."""
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import fbank as fb
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls = KernelCalls()
    aw.KERNEL.launches = fb.KERNEL.launches = 0
    t0 = time.perf_counter()
    try:
        result = fn(argv)
        torch.cuda.synchronize()
    except BaseException:
        calls.close()
        raise
    wall = time.perf_counter() - t0
    launches = {"attn_weights": aw.KERNEL.launches,
                "fbank": fb.KERNEL.launches}
    return result, wall, launches, torch.cuda.max_memory_allocated(), calls


def checked_calls(calls, label, fbank_calls):
    """check_fbank_calls, then the capture closed; `fbank_calls` (the
    launches counted) must equal the calls checked."""
    try:
        n, worst_log, worst_energy = check_fbank_calls(calls, label)
    finally:
        calls.close()
    assert n == fbank_calls, f"{label}: {n} B2 calls checked of " \
        f"{fbank_calls} launched"
    return n, worst_log, worst_energy


def recipe_argv(cfg, export_path, tmp, corpus, *overrides):
    """build_task's argv for the training YAML `cfg` on phase 10's corpus
    (written under `tmp`), exported to `export_path`."""
    argv = ["--training_config", cfg,
            "--override", f"task.export_path={export_path}",
            "--override", f"dataset.base_dir={tmp}/corpus"]
    for key, path in corpus.items():
        argv += ["--override", f"dataset.{key}={path}"]
    for ov in overrides:
        argv += ["--override", ov]
    return argv


def recipe_infer_argv(cfg, export_path, train_cfg, corpus):
    """inference's argv for the inference YAML `cfg` on the run whose
    resolved training config is `train_cfg`, over phase 10's eval set."""
    return ["--inference_config", cfg,
            "--override", f"task.train_config={train_cfg}",
            "--override", f"task.export_path={export_path}",
            "--override", f"testset.test_data={corpus['eval_data']}"]


def conformer_train_run(card, name, cfg, argv, steps, val_every, keys,
                        eval_keys=("val_loss", "wer"), fbank_per_step=2,
                        fbank_per_eval_batch=1, vocab=128):
    """build_task's main on `cfg` for `steps` steps (an evaluation with
    `eval_keys` and a checkpoint every `val_every`), every B2 call held to
    the plain version, `fbank_per_step` B2 launches per step and
    `fbank_per_eval_batch` per eval batch; returns the trainer and the
    run's record."""
    from speech2text_torch import build_task
    trainer, run_s, launches, peak, calls = counted_main(
        build_task.main, argv + ["--max_steps", str(steps)])
    task, workdir = trainer.task, trainer.workdir
    n_checked, worst_log, worst_energy = checked_calls(
        calls, f"{name} run", launches["fbank"])
    assert vocab is None or len(task.tokenizer) == vocab, \
        f"{name}: the subword model has {len(task.tokenizer)} labels"
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines] == list(
        range(CONF_LOG_EVERY, steps + 1, CONF_LOG_EVERY)), lines
    bad = [r for r in lines if not _finite_record(r, keys)]
    assert not bad, f"{name}: metrics lines missing keys or not finite: " \
        f"{bad}"
    evals = [h for h in trainer.history if h["eval_s"] > 0]
    assert [h["step"] for h in evals] == list(
        range(val_every, steps + 1, val_every)), evals
    with open(os.path.join(workdir, "checkpoints", "index.json")) as f:
        index = json.load(f)["checkpoints"]
    assert sorted(index, key=int) == [str(h["step"]) for h in evals]
    for step, m in index.items():
        assert _finite_record(m, eval_keys), (step, m)
        assert os.path.exists(trainer.ckpt.path(int(step)))
    eval_batches = task.make_eval_pipeline().batches_per_epoch()
    want = {"attn_weights": 0, "fbank": fbank_per_step * steps + len(evals)
            * eval_batches * fbank_per_eval_batch}
    assert launches == want, f"{name}: launches {launches}, expected {want}"
    hist = trainer.history
    step_ms = [1e3 * (b["end"] - a["end"]) for a, b in zip(hist, hist[1:])
               if a["eval_s"] == 0.0]
    med = statistics.median(step_ms)
    log(f"conformer {name} (build_task main, {steps} steps, f32): {run_s:.1f}"
        f" s; median {med:.2f} ms/step over {len(step_ms)} steps "
        f"({min(step_ms):.2f}-{max(step_ms):.2f}); loop's utt/s "
        f"{[round(r['utts_per_sec'], 2) for r in lines]}; grad_norm "
        f"{[round(r['grad_norm'], 2) for r in lines]}; losses "
        f"{[round(r['loss'], 3) for r in lines]}; eval s "
        f"{[round(h['eval_s'], 2) for h in evals]} over {eval_batches} "
        f"batches; evals {index}; peak memory {peak / 2**30:.2f} GiB; "
        f"launches {launches} (0 B1, {fbank_per_step} B2 per step, "
        f"{fbank_per_eval_batch} per eval batch); "
        f"{n_checked} B2 calls within check_mel (worst "
        f"{worst_energy:.3g} of the frame's mel energy, log "
        f"{worst_log:.3g})", card)
    return trainer, {
        "run_s": run_s, "ms_per_step": step_ms, "median_ms": med,
        "metrics_lines": lines, "eval_s": [h["eval_s"] for h in evals],
        "eval_batches": eval_batches, "evals": index,
        "peak_memory_bytes": peak, "launches": launches,
        "fbank_calls_checked": n_checked, "fbank_max_abs_err": worst_log,
        "fbank_err_of_energy": worst_energy}


def conformer_inference(card, name, argv, fbank_per_batch=1):
    """inference.main (0 B1 and `fbank_per_batch` B2 launches per test
    batch; run_inference checks the report), every B2 call held to the
    plain version; returns the run and the worst log-domain B2 error."""
    run, _, launches, _, calls = counted_main(
        lambda args: run_inference(name, args, card, 0, fbank_per_batch),
        argv)
    _, worst_log, _ = checked_calls(calls, name, launches["fbank"])
    assert launches == run["launches"]
    return run, worst_log


def ctc_parts(task, batches):
    """Per test batch, each part ended by a synchronise: featurize, the
    model to log-probabilities, each decoder; seconds per batch and the
    tokens each decoder emitted."""
    from speech2text_torch.decoding import build_decoding
    decs = {"greedy": build_decoding({"decode_method": "ctc_greedy_search"}),
            "prefix_beam": build_decoding({
                "decode_method": "ctc_prefix_beam_search", "beam_size": 8,
                "cand_size": 8})}
    sync = torch.cuda.synchronize
    parts = {k: [] for k in ("featurize", "encode", *decs)}
    tokens = dict.fromkeys(decs, 0)
    with torch.no_grad():
        for batch in batches:
            sync()
            t0 = time.perf_counter()
            feats, lens = task.featurize(batch)
            sync()
            t1 = time.perf_counter()
            logits, out_lens = task.model(feats, lens)
            lp = task.loss.predict(logits)
            sync()
            parts["featurize"].append(t1 - t0)
            parts["encode"].append(time.perf_counter() - t1)
            for name, dec in decs.items():
                t0 = time.perf_counter()
                _, counts = dec.decode(lp, out_lens)
                sync()
                parts[name].append(time.perf_counter() - t0)
                tokens[name] += int(counts.sum())
    return {k: statistics.mean(v) for k, v in parts.items()}, tokens


def same_tokens_card_cpu(card_fn, cpu_fn, feats_of, batches, what):
    """Each of the first CONF_CPU_BATCHES test batches featurized on the
    card (B2), then decoded by `card_fn` on the card and `cpu_fn` on the
    CPU from the same features: identical tokens and counts; returns the
    tokens compared."""
    n = 0
    with torch.no_grad():
        for batch in batches[:CONF_CPU_BATCHES]:
            feats, lens = feats_of(batch)
            tg, cg = card_fn(feats, lens)
            tc, cc = cpu_fn(feats.cpu(), lens.cpu())
            assert torch.equal(cg.cpu(), cc) and torch.equal(tg.cpu(), tc), \
                f"{what}: f32 tokens differ between the card and the CPU"
            n += int(cc.sum())
    assert n > 0, f"{what}: the seeded model emitted no token"
    return n


def ctc_step_parts(trainer, card):
    """Wall time of a CTC recipe step's parts on the first batch of a
    fresh train pipeline, each ended by a synchronise: the training
    featurize, the model to logits, the CTC loss, the backward, the
    clipping and AdamW. Medians of 3."""
    from speech2text_torch.optim import clip_by_global_norm_
    task = trainer.task
    it = iter(task.make_train_pipeline(seed=trainer.seed, pin_memory=True))
    batch = trainer.to_device(next(it))
    it.close()
    sync = torch.cuda.synchronize
    names = ("featurize", "model", "ctc_loss", "backward", "optimizer")
    times = {k: [] for k in names}
    for rep in range(3):
        aug, drop, _ = trainer.generators(rep)
        marks = []
        sync()
        marks.append(time.perf_counter())
        feats, lens = task.featurize(batch, aug, training=True)
        sync()
        marks.append(time.perf_counter())
        logits, out_lens = task.model(feats, lens, training=True,
                                      generator=drop)
        sync()
        marks.append(time.perf_counter())
        loss = task.loss({"logits": logits, "logits_length": out_lens,
                          "label": batch["label"],
                          "label_length": batch["label_length"]})
        sync()
        marks.append(time.perf_counter())
        trainer.optimizer.zero_grad()
        loss.backward()
        sync()
        marks.append(time.perf_counter())
        grads = [p.grad for p in task.model.parameters()
                 if p.grad is not None]
        clip_by_global_norm_(grads, trainer.clip,
                             torch.nn.utils.get_total_norm(grads))
        trainer.optimizer.step()
        sync()
        marks.append(time.perf_counter())
        for k, a, b in zip(names, marks, marks[1:]):
            times[k].append(b - a)
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    shape = {"B": int(batch["pcm"].shape[0]), "N": int(batch["pcm"].shape[1]),
             "T_out": int(out_lens.max()), "U": int(batch["label"].shape[1])}
    log(f"conformer ctc step parts at B={shape['B']} N={shape['N']} (T' = "
        f"{shape['T_out']} CTC frames, U = {shape['U']}; median ms, "
        f"synchronised): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                      med.items()), card)
    return dict(shape, parts_ms=med)


def conformer_step_parts(ts, batch, card):
    """Wall time of the pruned-RNN-T + CTC step's parts, each ended by a
    synchronise: featurize; the encoder with the Projector head and the
    predictor; the joiner with the simple loss and prune ranges; the
    pruned loss; the CTC loss; the backward of the whole loss; the
    optimizer; and, apart, the CTC loss's forward and backward on the
    head's logits alone (the frame loop's cost). Medians of 3."""
    from speech2text_torch.tasks.rnnt import sample_chunk
    pcm, pcm_lens, labels, lab_lens = batch
    model, fn = ts.model, ts.loss_fn
    chunk = sample_chunk(model.encoder.config, ts.host_generator)
    assert chunk == (-1, -1)
    sync = torch.cuda.synchronize
    names = ("featurize", "encoder", "joiner_simple_ranges", "pruned_loss",
             "ctc_loss", "backward", "optimizer", "ctc_fwd_bwd")
    times = {k: [] for k in names}
    for _ in range(3):
        marks = []
        sync()
        marks.append(time.perf_counter())
        feats, feat_lens = ts.featurize(pcm, pcm_lens)
        sync()
        marks.append(time.perf_counter())
        enc, enc_lens = model.encoder(feats, feat_lens, training=True,
                                      generator=ts.generator)
        dec, dec_lens = model.decoder(enc, enc_lens, training=True,
                                      generator=ts.generator)
        pred = model.predictor(labels)
        sync()
        marks.append(time.perf_counter())
        logits, ranges, simple = model.joiner(enc, enc_lens, pred, lab_lens,
                                              labels)
        sync()
        marks.append(time.perf_counter())
        pruned = fn.pruned_loss({"logits": logits, "ranges": ranges,
                                 "logits_length": enc_lens, "label": labels,
                                 "label_length": lab_lens})
        sync()
        marks.append(time.perf_counter())
        ctc_in = {"logits": dec, "logits_length": dec_lens, "label": labels,
                  "label_length": lab_lens}
        ctc = fn.ctc_loss(ctc_in)
        sync()
        marks.append(time.perf_counter())
        ts.optimizer.zero_grad()
        (fn.simple_scale * simple + fn.pruned_scale * pruned
         + fn.ctc_weight * ctc).backward()
        sync()
        marks.append(time.perf_counter())
        ts.optimizer.step()
        sync()
        marks.append(time.perf_counter())
        leaf = dec.detach().requires_grad_()
        fn.ctc_loss(dict(ctc_in, logits=leaf)).backward()
        sync()
        marks.append(time.perf_counter())
        for k, a, b in zip(names, marks, marks[1:]):
            times[k].append(b - a)
        del enc, dec, pred, logits, pruned, ctc, leaf
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    log("conformer train step parts (median ms, synchronised): " + ", ".join(
        f"{k} {v:.2f}" for k, v in med.items()) + f" (T' = "
        f"{int(dec_lens.max())} CTC frames, S = {2 * labels.shape[1] + 1})",
        card)
    return med


def phase_conformer_step(card, out):
    """Phase 13 (c): conformer_pruned_rnnt.yaml at its published width
    through TrainStep at bench.py's shape."""
    from torch.profiler import ProfilerActivity, profile

    from speech2text_torch.models.conformer import Conformer
    from speech2text_torch.train.step import TrainStep
    from speech2text_torch.config import load_config
    ts = TrainStep.from_config(CONF_CFG, device="cuda", seed=SEED + 31)
    model = ts.model
    enc = model.encoder.config
    # the YAML's own width and depth (256 x 12, ffn 1024, 4 heads), f32
    assert isinstance(model.encoder, Conformer) and \
        dataclasses.asdict(enc) == dict(
            dataclasses.asdict(type(enc)()),
            **load_config(CONF_CFG)["encoder"]["config"]) and \
        enc.dtype == "float32" and enc.dropout > 0
    assert type(model.decoder).__name__ == "ProjectorDecoder" and \
        ts.loss_fn.enable_ctc and model.joiner.config.output_dim == 128
    rng = np.random.default_rng(SEED + 31)
    pcm, lens, labels, lab_lens = train_pcm(rng, B_TRAIN, 2, TRAIN_SECS,
                                            TRAIN_U, 128)
    batch = tuple(torch.from_numpy(x).cuda()
                  for x in (pcm, lens, labels, lab_lens))

    # dropout is on in training, off in evaluation
    with torch.no_grad():
        feats, feat_lens = ts.featurize(batch[0][:2], batch[1][:2])
        a, _ = model.encoder(feats, feat_lens, training=True,
                             generator=torch.Generator("cuda").manual_seed(1))
        b, _ = model.encoder(feats, feat_lens, training=True,
                             generator=torch.Generator("cuda").manual_seed(2))
        e1, _ = model.encoder(feats, feat_lens)
        e2, _ = model.encoder(feats, feat_lens)
    assert not torch.equal(a, b) and torch.equal(e1, e2), \
        "dropout is not on in training only"

    # (0, 1) launches per step: TrainStep featurizes the speech batch alone
    launches, times, losses, peak, n_par = timed_train_steps(
        ts, batch, (0, 1), "conformer train step", card)
    assert all("ctc_loss" in r for r in losses), losses
    per_step = [(0, 1)] * TRAIN_STEPS
    med = statistics.median(times)
    log(f"conformer train step ({enc.input_dim} x {enc.num_layers}, ffn "
        f"{enc.ffn_dim}, {enc.num_heads} heads, f32, Projector + CTC branch) "
        f"B={B_TRAIN} x {TRAIN_SECS} s U={TRAIN_U}: median {med:.2f} ms/step"
        f" ({', '.join(f'{x:.2f}' for x in times)}), "
        f"{B_TRAIN / med * 1e3:.2f} utt/s, peak memory {peak / 2**30:.2f} "
        f"GiB, launches per step {per_step[0]}, ctc_loss "
        f"{[round(r['ctc_loss'], 4) for r in losses]}, loss "
        f"{[round(r['loss'], 4) for r in losses]}; all {n_par} "
        f"parameter tensors changed (decoder head included)", card)

    parts, held_parts = held_run("conformer step parts",
                                 lambda: conformer_step_parts(ts, batch,
                                                              card))
    spans_names = SPANS + ("ctc_loss",)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts.step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, busy, spans = profile_summary(prof, spans_names)
    log(f"profiled conformer train step: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(r[2] for r in rows)} device ops; host time of its spans: "
        + ", ".join(f"{k} {spans.get(k, float('nan')):.2f} ms"
                    for k in spans_names), card)
    for key, ms, n in rows[:10]:
        log(f"  {ms:9.3f} ms  x{n:<6d} {key[:90]}", card)
    out["train_step"] = {
        "B": B_TRAIN, "seconds": TRAIN_SECS, "U": TRAIN_U,
        "ms_per_step": times, "median_ms": med,
        "utt_per_s": B_TRAIN / med * 1e3, "peak_memory_bytes": peak,
        "launches_per_step": per_step, "losses": losses, "parts_ms": parts,
        "ctc_share": parts["ctc_fwd_bwd"] / med, "profiled_wall_ms": wall,
        "device_busy_ms": busy, "span_host_ms": spans,
        "top_device_ops": rows[:30]}
    del ts, model
    torch.cuda.empty_cache()
    return launches, held_parts


def phase_conformer(card, report, tmp, trained):
    """Phase 13: the Conformer family on phase 10's synthetic corpus:
    (a) conformer_ctc.yaml trained through build_task's main, with a
    bitwise AdamW resume; (b) its greedy and prefix-beam inference YAMLs,
    f32 tokens on the card equal to the CPU's on seeded weights; (c)
    conformer_pruned_rnnt.yaml's train step at full width and bench.py's
    shape; (d) the same YAML through build_task and the
    pruned_rnnt_ctc_greedy_search inference YAML, f32 tokens on the card
    equal to the CPU's; (e) 0 B1 launches and every B2 call within
    check_mel throughout."""
    from speech2text_torch import build_task
    from speech2text_torch.decoding import build_decoding
    from speech2text_torch.optim import Adam
    from speech2text_torch.tasks.ctc import CtcModel
    from speech2text_torch.tasks.rnnt import RnntModel

    t_phase = time.perf_counter()
    out = {}
    corpus = trained["corpus"]

    def train_argv(cfg, name, *extra):
        return recipe_argv(cfg, f"{tmp}/conformer", tmp, corpus,
                           f"trainer.log_interval={CONF_LOG_EVERY}", *extra)

    def infer_argv(cfg, name, train_cfg):
        return recipe_infer_argv(cfg, f"{tmp}/conformer_infer/{name}",
                                 train_cfg, corpus)

    # (a) CTC training: 20 steps, an evaluation every 10, top-k by wer
    argv = train_argv(CTC_CFG, "ctc",
                      f"trainer.val_check_interval={CONF_VAL_EVERY}")
    trainer, rec = conformer_train_run(card, "ctc", CTC_CFG, argv,
                                       CONF_STEPS, CONF_VAL_EVERY, CTC_KEYS)
    assert isinstance(trainer.optimizer, Adam) and \
        trainer.optimizer.weight_decay == 1e-2 and trainer.clip == 5.0
    clipped = sum(r["grad_norm"] > trainer.clip for r in rec["metrics_lines"])
    workdir = trainer.workdir
    trainer2, fit_kw = build_task.prepare(
        argv + ["--max_steps", str(CONF_STEPS + CONF_RESUME_STEPS)])
    assert trainer2.init_state(fit_kw["resume"],
                               fit_kw["finetune_state"]) == CONF_STEPS
    saved = trainer2.ckpt.restore(CONF_STEPS)
    assert _same_state(saved["model"], trainer2.task.model.state_dict()), \
        "restored weights differ from the checkpoint"
    assert _same_state(saved["optimizer"], trainer2.optimizer.state_dict()), \
        "restored AdamW state differs from the checkpoint"
    assert saved["optimizer"]["count"] == CONF_STEPS
    # every run below on the card: launches counted, B2 calls held
    held = {}
    _, held["ctc_resume"] = held_run("conformer ctc resume",
                                     lambda: trainer2.fit(**fit_kw))
    trainer2.close()
    assert [h["step"] for h in trainer2.history] == list(
        range(CONF_STEPS + 1, CONF_STEPS + CONF_RESUME_STEPS + 1))
    assert _finite_record(trainer2.last_eval, ("val_loss", "wer"))
    log(f"conformer ctc resume: a fresh Trainer restored step {CONF_STEPS} "
        f"(weights and AdamW moments and count bitwise equal to the file), "
        f"took steps {[h['step'] for h in trainer2.history]}, eval "
        f"{trainer2.last_eval}; {clipped} of {len(rec['metrics_lines'])} "
        f"logged steps clipped (grad_norm > {trainer.clip})", card)
    parts, held["ctc_step_parts"] = held_run(
        "conformer ctc step parts", lambda: ctc_step_parts(trainer2, card))
    rec.update(resume_eval=trainer2.last_eval, logged_clipped=clipped,
               step_parts=parts)
    out["ctc_train"] = rec
    ctc_train_cfg = os.path.join(workdir, os.path.basename(CTC_CFG))
    out["ctc_train_config"] = ctc_train_cfg
    del trainer, trainer2

    # (b) CTC decoding with (a)'s checkpoints: greedy and prefix beam (8)
    runs, infer_worst = {}, 0.0
    for name, cfg in CTC_INFER.items():
        runs[name], err = conformer_inference(
            card, f"ctc_{name}", infer_argv(cfg, name, ctc_train_cfg))
        infer_worst = max(infer_worst, err)
    beam_metric = runs["prefix_beam"]["train_config"]["metric"]
    assert beam_metric["decode_method"] == "ctc_prefix_beam_search" and \
        beam_metric["beam_size"] == 8
    task, dev = runs["greedy"]["task"], runs["greedy"]["device"]
    batches = device_batches(task, dev)
    per, ctc_tokens = ctc_parts(task, batches)
    log(f"conformer ctc decoding: s per test batch (mean of {len(batches)}):"
        f" featurize {per['featurize']:.4f}, encode {per['encode']:.4f}, "
        f"greedy {per['greedy']:.4f}, prefix beam (8, 8) "
        f"{per['prefix_beam']:.4f}; tokens {ctc_tokens} (phase (a)'s "
        f"weights); corpus WER greedy {runs['greedy']['wer']:.4f}, beam "
        f"{runs['prefix_beam']['wer']:.4f}", card)
    seeded = CtcModel.from_config(runs["greedy"]["train_config"])
    seeded.init_weights(torch.Generator().manual_seed(SEED + 32))
    task.model.load_state_dict(seeded.state_dict())
    cpu_model = seeded.eval()
    n_tok = {}
    for name in CTC_INFER:
        dec = build_decoding(runs[name]["train_config"]["metric"])

        def run_on(model, feats, lens, dec=dec):
            logits, out_lens = model(feats, lens)
            return dec.decode(torch.log_softmax(logits, -1), out_lens)

        n_tok[name] = same_tokens_card_cpu(
            lambda f, l: run_on(task.model, f, l),
            lambda f, l: run_on(cpu_model, f, l), task.featurize, batches,
            f"ctc {name}")
    log(f"conformer ctc f32 tokens on seeded weights identical on the card "
        f"and the CPU over {CONF_CPU_BATCHES} test batches (the same B2 "
        f"features): greedy {n_tok['greedy']}, prefix beam "
        f"{n_tok['prefix_beam']}", card)
    out["ctc_decode"] = {
        "s_per_batch": per, "tokens": ctc_tokens,
        "wer": {k: r["wer"] for k, r in runs.items()},
        "wall_s": {k: r["wall_s"] for k, r in runs.items()},
        "launches": {k: r["launches"] for k, r in runs.items()},
        "batches": runs["greedy"]["batches"], "card_cpu_tokens": n_tok}
    infer_fbank = sum(r["launches"]["fbank"] for r in runs.values())
    infer_batches = sum(r["batches"] for r in runs.values())
    per_batch = {f"ctc_{k}": {kernel: n / r["batches"]
                              for kernel, n in r["launches"].items()}
                 for k, r in runs.items()}
    del runs, task, seeded, cpu_model
    torch.cuda.empty_cache()

    # (c) the pruned RNN-T + CTC step at full width, bench.py's shape
    step_launches, held["pruned_step_parts"] = phase_conformer_step(card,
                                                                    out)

    # (d) the same YAML through build_task, then its inference YAML
    argv = train_argv(CONF_CFG, "pruned",
                      f"trainer.val_check_interval={CONF_RNNT_STEPS}")
    trainer, rec = conformer_train_run(
        card, "pruned_rnnt", CONF_CFG, argv, CONF_RNNT_STEPS,
        CONF_RNNT_STEPS, RUN_KEYS + ("ctc_loss",))
    assert all("val_ctc_loss" in m for m in rec["evals"].values())
    out["pruned_train"] = rec
    rnnt_train_cfg = os.path.join(trainer.workdir, os.path.basename(CONF_CFG))
    del trainer
    run, err = conformer_inference(card, "pruned_rnnt_ctc_greedy",
                                   infer_argv(CONF_INFER_CFG, "pruned_greedy",
                                              rnnt_train_cfg))
    infer_worst = max(infer_worst, err)
    task, dev = run["task"], run["device"]
    batches = device_batches(task, dev)
    parts, tokens = infer_parts(task, batches)
    per_r = {k: statistics.mean(v) for k, v in parts.items()}
    log(f"conformer pruned greedy decoding: s per test batch (mean of "
        f"{len(batches)}): featurize {per_r['featurize']:.4f}, encode "
        f"{per_r['encode']:.4f}, decode {per_r['decode']:.4f}; {tokens} "
        f"tokens; corpus WER {run['wer']:.4f}", card)
    seeded = RnntModel.from_config(run["train_config"])
    seeded.init_weights(torch.Generator().manual_seed(SEED + 33))
    task.model.load_state_dict(seeded.state_dict())
    cpu_model = seeded.eval()
    cpu_dec = build_decoding(run["train_config"]["metric"],
                             cpu_model.predictor_step,
                             cpu_model.predictor.init_state,
                             cpu_model.joiner_step)

    def rnnt_on(model, dec, feats, lens):
        enc, enc_lens = model.encoder(feats, lens)
        return dec.decode(enc, enc_lens)

    n_rnnt = same_tokens_card_cpu(
        lambda f, l: rnnt_on(task.model, task.decode_session, f, l),
        lambda f, l: rnnt_on(cpu_model, cpu_dec, f, l), task.featurize,
        batches, "pruned greedy")
    log(f"conformer pruned greedy f32 tokens on seeded weights identical on "
        f"the card and the CPU over {CONF_CPU_BATCHES} test batches: "
        f"{n_rnnt}", card)
    out["pruned_decode"] = {"s_per_batch": per_r, "tokens": tokens,
                            "wer": run["wer"], "wall_s": run["wall_s"],
                            "launches": run["launches"],
                            "batches": run["batches"],
                            "card_cpu_tokens": n_rnnt}
    infer_fbank += run["launches"]["fbank"]
    infer_batches += run["batches"]
    per_batch["pruned_greedy"] = {kernel: n / run["batches"]
                                  for kernel, n in run["launches"].items()}
    del run, task, seeded, cpu_model, cpu_dec
    torch.cuda.empty_cache()

    # (e) launches over the phase: 0 B1; 2 B2 per build_task step, 1 per
    # TrainStep step and per eval or test batch
    runs = (out["ctc_train"], out["pruned_train"])
    fbank_total = sum(r["launches"]["fbank"] for r in runs) + \
        step_launches["fbank"] + infer_fbank + \
        sum(h["launches"]["fbank"] for h in held.values())
    b1_total = sum(r["launches"]["attn_weights"] for r in runs) + \
        step_launches["attn_weights"] + \
        sum(h["launches"]["attn_weights"] for h in held.values())
    assert b1_total == 0
    checked = sum(r["fbank_calls_checked"] for r in runs) + infer_fbank + \
        sum(h["calls_checked"] for h in held.values())
    worst = max([r["fbank_max_abs_err"] for r in runs] + [infer_worst]
                + [h["max_abs_err"] for h in held.values()])
    wall = time.perf_counter() - t_phase
    log(f"conformer phase: {wall:.1f} s; launches B1 0, B2 {fbank_total} "
        f"(2 per build_task step, 1 per TrainStep step, 1 per eval or test "
        f"batch: {infer_fbank} over {infer_batches} test batches; the "
        f"resume and step parts: " + ", ".join(
            f"{k} {h['launches']['fbank']}" for k, h in held.items())
        + f"); {checked} B2 calls of the build_task, inference, resume and "
        f"step-parts runs within check_mel (worst log error {worst:.3g})",
        card)
    out["wall_s"] = wall
    out["held_runs"] = held
    report["conformer"] = out

    def per_step(kernel):
        """Launches per training step of each run, measured: the
        build_task runs' launches less their eval batches', over steps."""
        steps = {"ctc_build_task": (out["ctc_train"], CONF_STEPS),
                 "pruned_build_task": (out["pruned_train"], CONF_RNNT_STEPS)}
        got = {k: (r["launches"][kernel] - (kernel == "fbank")
                   * len(r["eval_s"]) * r["eval_batches"]) / n
               for k, (r, n) in steps.items()}
        got["train_step"] = step_launches[kernel] / TRAIN_STEPS
        return got

    return {kernel: dict(launches=b1_total if kernel == "attn_weights"
                         else fbank_total,
                         launches_per_step=per_step(kernel),
                         launches_per_batch={k: v[kernel]
                                             for k, v in per_batch.items()},
                         **({} if kernel == "attn_weights" else dict(
                             calls_checked=checked, max_abs_err=worst)))
            for kernel in ("attn_weights", "fbank")}


# ------------------------------------------------------------ phase 14
def unchanged_params(model, config, seed):
    """Names of `model`'s parameters equal to a fresh model of the
    training config `config` seeded with `seed` (the Trainer's init): the
    ones training did not move."""
    fresh = type(model).from_config(config)
    fresh.init_weights(torch.Generator().manual_seed(seed))
    live = dict(model.named_parameters())
    return [k for k, v in fresh.named_parameters()
            if v.requires_grad and torch.equal(v, live[k].cpu())]


def dynamics_profile(step_fn, card, label):
    """One profiled call of `step_fn` (a training step): wall ms, device
    busy ms, device ops and the host ms of the step's spans, the training
    dynamics' extra backward ("regularizers_backward") among them."""
    from torch.profiler import ProfilerActivity, profile
    names = SPANS + ("regularizers_backward",)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    assert all(math.isfinite(float(v)) for v in out.values()), out
    rows, busy, spans = profile_summary(prof, names)
    n_reg = sum(1 for name, on_device, _ in raw_events(prof)
                if name == "regularizers_backward" and not on_device)
    assert n_reg > 0, f"{label}: no regularizers_backward span in the trace"
    log(f"profiled {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%), {sum(r[2] for r in rows)} device ops;"
        f" host time of its spans: " + ", ".join(
            f"{k} {spans.get(k, float('nan')):.2f} ms" for k in names)
        + f" ({n_reg} regularizer backwards)", card)
    return {"wall_ms": wall, "device_busy_ms": busy, "span_host_ms": spans,
            "regularizer_backwards": n_reg, "top_device_ops": rows[:30]}


def phase_heldout_run(card, out, tmp, corpus, flagship_ms):
    """Phase 14 (a): zipformer_heldout.yaml (flagship width, bf16,
    dynamics: true, seperate_lr, max_rss_gb) through build_task's main."""
    from speech2text_torch import build_task
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import fbank as fb
    from speech2text_torch.optim.setup import MultiOptimizer
    argv = recipe_argv(HELDOUT_CFG, f"{tmp}/heldout", tmp, corpus,
                       f"trainer.val_check_interval={HELDOUT_STEPS}",
                       f"trainer.log_interval={HELDOUT_LOG_EVERY}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    aw.KERNEL.launches = fb.KERNEL.launches = 0
    t0 = time.perf_counter()
    trainer = build_task.main(argv + ["--max_steps", str(HELDOUT_STEPS)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"attn_weights": aw.KERNEL.launches,
                "fbank": fb.KERNEL.launches}
    peak = torch.cuda.max_memory_allocated()
    task = trainer.task
    enc = task.model.encoder.config
    n_layers = sum(enc.num_encoder_layers)
    assert n_layers == RUN_LAYERS and enc.dynamics and \
        enc.dtype == "bfloat16" and max(enc.encoder_dim) == 256, enc
    assert trainer.max_rss_gb == 100.0 and trainer.rss_restart
    assert isinstance(trainer.optimizer, MultiOptimizer) and sorted(
        trainer.optimizer.optimizers) == ["default", "joiner", "predictor"]
    assert len(task.tokenizer) == task.model.joiner.config.output_dim
    with open(os.path.join(trainer.workdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines] == list(
        range(HELDOUT_LOG_EVERY, HELDOUT_STEPS + 1, HELDOUT_LOG_EVERY))
    bad = [r for r in lines if not _finite_record(r, RUN_KEYS)]
    assert not bad, f"heldout: metrics lines not finite: {bad}"
    evals = [h for h in trainer.history if h["eval_s"] > 0]
    assert [h["step"] for h in evals] == [HELDOUT_STEPS], evals
    index = trainer.ckpt._index["checkpoints"]
    assert _finite_record(index[str(HELDOUT_STEPS)],
                          ("val_loss", "val_simple_loss", "val_pruned_loss",
                           "wer")), index
    eval_batches = task.make_eval_pipeline().batches_per_epoch()
    n_eval = len(evals) * eval_batches
    want = {"attn_weights": n_layers * (HELDOUT_STEPS + n_eval),
            "fbank": 2 * HELDOUT_STEPS + n_eval}
    assert launches == want, f"heldout launches {launches}, expected {want}"
    still = unchanged_params(task.model, trainer.config, trainer.seed)
    assert not still, f"heldout: parameters not changed: {still}"
    hist = trainer.history
    step_ms = [1e3 * (b["end"] - a["end"]) for a, b in zip(hist, hist[1:])
               if a["eval_s"] == 0.0]
    med = statistics.median(step_ms)
    specs = task.make_train_pipeline().specs
    buckets = [(s.batch_size, s.pcm_len, s.label_len) for s in specs]
    log(f"heldout run (build_task main, zipformer_heldout.yaml: flagship "
        f"bf16 with dynamics, seperate_lr, {HELDOUT_STEPS} steps): "
        f"{run_s:.1f} s; median {med:.2f} ms/step over {len(step_ms)} steps "
        f"({min(step_ms):.2f}-{max(step_ms):.2f}; phase 10's flagship run "
        f"without dynamics {flagship_ms:.2f}, other buckets); buckets "
        f"{buckets}; loop's utt/s "
        f"{[round(r['utts_per_sec'], 2) for r in lines]}; losses "
        f"{[round(r['loss'], 3) for r in lines]}; eval "
        f"{ {k: round(v, 4) for k, v in index[str(HELDOUT_STEPS)].items()} }"
        f" in {evals[0]['eval_s']:.2f} s over {eval_batches} batches; peak "
        f"memory {peak / 2**30:.2f} GiB; launches {launches} (= {n_layers} "
        f"B1 and 2 B2 per step, {n_layers} + 1 per eval batch); all "
        f"{sum(p.requires_grad for p in task.model.parameters())} trained "
        f"parameter tensors changed",
        card)

    pipe = task.make_train_pipeline(seed=trainer.seed, pin_memory=True)
    it = iter(pipe)
    batch = trainer.to_device(next(it))
    it.close()
    step = HELDOUT_STEPS
    trainer.train_step(batch, step)
    torch.cuda.synchronize()
    aw.KERNEL.launches = fb.KERNEL.launches = 0
    prof = dynamics_profile(lambda: trainer.train_step(batch, step + 1),
                            card, f"heldout run step (B="
                            f"{batch['pcm'].shape[0]}, N="
                            f"{batch['pcm'].shape[1]})")
    per_step = {"attn_weights": aw.KERNEL.launches,
                "fbank": fb.KERNEL.launches}
    assert per_step == {"attn_weights": n_layers, "fbank": 2}, per_step
    shape_checks = check_run_shapes(trainer, card)
    worst = {"attn_weights": max(r["attn_max_abs_err"] for r in shape_checks),
             "fbank": max(max(r["fbank_speech_log_err"],
                              r["fbank_noise_log_err"])
                          for r in shape_checks)}
    out["heldout_run"] = {
        "steps": HELDOUT_STEPS, "run_s": run_s, "ms_per_step": step_ms,
        "median_ms": med, "flagship_run_median_ms": flagship_ms,
        "buckets": buckets, "metrics_lines": lines,
        "eval_s": [h["eval_s"] for h in evals],
        "eval_batches": eval_batches, "evals": index,
        "peak_memory_bytes": peak, "launches": launches,
        "launches_per_step": per_step, "profiled_step": prof,
        "kernel_checks": shape_checks, "max_abs_err": worst}
    del trainer, task
    torch.cuda.empty_cache()
    return launches, per_step, worst, len(shape_checks)


def timed_train_steps(ts, batch, per_step_want, label, card):
    """A warm-up and TRAIN_STEPS timed TrainStep steps on `batch` with the
    kernel counts set to 0 before them: (launches, ms per step, losses,
    peak memory); launches per step must be `per_step_want` (B1, B2),
    every loss finite and every parameter changed."""
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import fbank as fb
    t0 = time.perf_counter()
    ts.step(*batch)
    torch.cuda.synchronize()
    log(f"{label} warm-up step: {time.perf_counter() - t0:.2f} s")
    params = {k: p for k, p in ts.model.named_parameters() if p.requires_grad}
    before = {k: p.detach().clone() for k, p in params.items()}
    torch.cuda.reset_peak_memory_stats()
    aw.KERNEL.launches = fb.KERNEL.launches = 0
    per_step, times, losses = [], [], []
    for _ in range(TRAIN_STEPS):
        a0, f0 = aw.KERNEL.launches, fb.KERNEL.launches
        t0 = time.perf_counter()
        res = ts.step(*batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append((aw.KERNEL.launches - a0, fb.KERNEL.launches - f0))
        losses.append({k: float(v) for k, v in res.items()})
    launches = {"attn_weights": aw.KERNEL.launches,
                "fbank": fb.KERNEL.launches}
    peak = torch.cuda.max_memory_allocated()
    assert all(r == per_step_want for r in per_step), \
        f"{label}: launches per step {per_step}, expected {per_step_want}"
    assert all(math.isfinite(v) for r in losses for v in r.values()), \
        f"{label}: non-finite losses {losses}"
    unchanged = [k for k, p in params.items() if torch.equal(before[k], p)]
    assert not unchanged, f"{label}: parameters not changed: {unchanged}"
    del before
    return launches, times, losses, peak, len(params)


def phase_heldout_step(card, out, flagship_ms):
    """Phase 14 (b): the heldout model's TrainStep at bench.py's shape
    (bf16, dynamics at global steps 0-5), beside phase 9's flagship step
    on the same batch."""
    from speech2text_torch.train.step import TrainStep
    ts = TrainStep.from_config(HELDOUT_CFG, device="cuda", seed=SEED)
    enc = ts.model.encoder.config
    assert enc.dynamics and enc.dtype == "bfloat16"
    batch = bench_batch(ts.model.joiner.config.output_dim)
    n_layers = sum(enc.num_encoder_layers)
    launches, times, losses, peak, n_par = timed_train_steps(
        ts, batch, (n_layers, 1), "heldout train step", card)
    med = statistics.median(times)
    log(f"heldout train step (dynamics, bf16) B={B_TRAIN} x {TRAIN_SECS} s "
        f"U={TRAIN_U}: median {med:.2f} ms/step "
        f"({', '.join(f'{x:.2f}' for x in times)}), "
        f"{B_TRAIN / med * 1e3:.2f} utt/s; phase 9's flagship step without "
        f"dynamics {flagship_ms:.2f} ms (ratio {med / flagship_ms:.3f}); "
        f"peak memory {peak / 2**30:.2f} GiB; launches per step "
        f"({n_layers}, 1); losses {[round(r['loss'], 4) for r in losses]}; "
        f"all {n_par} parameter tensors changed", card)
    batch_args = batch
    prof = dynamics_profile(lambda: ts.step(*batch_args), card,
                            f"heldout train step B={B_TRAIN}")
    out["heldout_step"] = {
        "B": B_TRAIN, "seconds": TRAIN_SECS, "U": TRAIN_U,
        "ms_per_step": times, "median_ms": med,
        "flagship_step_median_ms": flagship_ms,
        "utt_per_s": B_TRAIN / med * 1e3, "peak_memory_bytes": peak,
        "losses": losses, "profiled_step": prof}
    del ts
    torch.cuda.empty_cache()
    return launches


def rnnt_step_parts(ts, batch, card):
    """Wall time of the full-lattice RNN-T step's parts, each ended by a
    synchronise: featurize; the encoder; the LSTM predictor and the full
    joiner; the RNN-T loss's forward; the backward of the loss; the
    clipping and AdamW. Medians of 3."""
    from speech2text_torch.optim import clip_by_global_norm_
    pcm, pcm_lens, labels, lab_lens = batch
    model, fn = ts.model, ts.loss_fn
    sync = torch.cuda.synchronize
    names = ("featurize", "encoder", "predictor_joiner", "rnnt_loss_forward",
             "backward", "optimizer")
    times = {k: [] for k in names}
    for _ in range(3):
        marks = []
        sync()
        marks.append(time.perf_counter())
        feats, feat_lens = ts.featurize(pcm, pcm_lens)
        sync()
        marks.append(time.perf_counter())
        enc, enc_lens = model.encoder(feats, feat_lens, training=True,
                                      generator=ts.generator)
        sync()
        marks.append(time.perf_counter())
        logits, _, _ = model.joiner(enc, enc_lens, model.predictor(labels),
                                    lab_lens, labels)
        sync()
        marks.append(time.perf_counter())
        loss = fn({"logits": logits, "enc_lens": enc_lens}, labels,
                  lab_lens)["loss"]
        sync()
        marks.append(time.perf_counter())
        ts.optimizer.zero_grad()
        loss.backward()
        sync()
        marks.append(time.perf_counter())
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        clip_by_global_norm_(grads, ts.clip,
                             torch.nn.utils.get_total_norm(grads))
        ts.optimizer.step()
        sync()
        marks.append(time.perf_counter())
        for k, a, b in zip(names, marks, marks[1:]):
            times[k].append(b - a)
        shape = tuple(logits.shape)
        del enc, logits, loss
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    log(f"rnnt train step parts at logits {shape} (median ms, "
        f"synchronised): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                      med.items()), card)
    return med, shape


def phase_rnnt_step(card, out):
    """Phase 14 (c, second part): conformer_rnnt.yaml at its width (256 x
    12, LSTM predictor 512 x 2, the full joiner) through TrainStep at
    bench.py's shape, f32 with TF32 off."""
    from speech2text_torch.models.predictor import LstmPredictor
    from speech2text_torch.train.step import TrainStep
    assert not torch.backends.cuda.matmul.allow_tf32 and \
        not torch.backends.cudnn.allow_tf32
    ts = TrainStep.from_config(RNNT_CFG, device="cuda", seed=SEED + 41)
    model = ts.model
    assert isinstance(model.predictor, LstmPredictor) and \
        model.joiner.config.prune_range == -1 and ts.clip == 5.0 and \
        model.encoder.config.dtype == "float32"
    rng = np.random.default_rng(SEED + 41)
    pcm, lens, labels, lab_lens = train_pcm(rng, B_TRAIN, 2, TRAIN_SECS,
                                            TRAIN_U, 128)
    batch = tuple(torch.from_numpy(x).cuda()
                  for x in (pcm, lens, labels, lab_lens))
    launches, times, losses, peak, n_par = timed_train_steps(
        ts, batch, (0, 1), "rnnt train step", card)
    med = statistics.median(times)
    log(f"rnnt train step (conformer_rnnt.yaml: 256 x 12, LSTM 512 x 2, "
        f"full lattice, f32) B={B_TRAIN} x 2-{TRAIN_SECS} s U<={TRAIN_U}: "
        f"median {med:.2f} ms/step ({', '.join(f'{x:.2f}' for x in times)})"
        f", {B_TRAIN / med * 1e3:.2f} utt/s, peak memory "
        f"{peak / 2**30:.2f} GiB, launches per step (0, 1), losses "
        f"{[round(r['loss'], 4) for r in losses]}; all {n_par} parameter "
        f"tensors changed", card)
    (parts, shape), held = held_run(
        "rnnt step parts", lambda: rnnt_step_parts(ts, batch, card))
    out["rnnt_step_parts_held"] = held
    torch.cuda.reset_peak_memory_stats()
    from torch.profiler import ProfilerActivity, profile
    names = SPANS + ("rnnt_loss",)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts.step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, busy, spans = profile_summary(prof, names)
    log(f"profiled rnnt train step: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(r[2] for r in rows)} device ops; host time of its spans: "
        + ", ".join(f"{k} {spans.get(k, float('nan')):.2f} ms"
                    for k in names), card)
    for key, ms, n in rows[:8]:
        log(f"  {ms:9.3f} ms  x{n:<6d} {key[:90]}", card)
    out["rnnt_step"] = {
        "B": B_TRAIN, "seconds": TRAIN_SECS, "U": TRAIN_U,
        "logits_shape": shape, "ms_per_step": times, "median_ms": med,
        "utt_per_s": B_TRAIN / med * 1e3, "peak_memory_bytes": peak,
        "losses": losses, "parts_ms": parts,
        "rnnt_loss_share": parts["rnnt_loss_forward"] / med,
        "profiled_wall_ms": wall, "device_busy_ms": busy,
        "span_host_ms": spans, "top_device_ops": rows[:30]}
    del ts, model
    torch.cuda.empty_cache()
    return launches


def phase_rnnt_family(card, report, tmp, trained):
    """Phase 14: the remaining transducer recipes on phase 10's corpus:
    (a) zipformer_heldout.yaml through build_task with every B1 and B2
    call of an epoch held to the plain versions; (b) its TrainStep at
    bench.py's shape beside phase 9's; (c) conformer_rnnt.yaml and
    conformer_hybrid_rnnt.yaml through build_task, conformer_rnnt.yaml's
    TrainStep at bench.py's shape with its parts; (d) the three inference
    YAMLs on (c)'s checkpoints, f32 tokens on seeded weights equal on the
    card and the CPU."""
    from speech2text_torch.decoding import build_decoding
    from speech2text_torch.tasks.rnnt import (CtcHybridRnntTask, RnntModel,
                                              RnntTask)
    t_phase = time.perf_counter()
    out = {}
    corpus = trained["corpus"]
    run_launches, run_per_step, run_worst, n_shapes = phase_heldout_run(
        card, out, tmp, corpus, report["train_run"]["median_ms"])
    step_launches = {"heldout_step": phase_heldout_step(
        card, out, report["train_bf16"]["median_ms"])}

    # (c) the Conformer RNN-T and hybrid recipes through build_task
    train_cfgs, fam_runs = {}, {}
    for name, cfg, cls, keys in (
            ("rnnt", RNNT_CFG, RnntTask, CTC_KEYS),
            ("hybrid", HYBRID_CFG, CtcHybridRnntTask,
             CTC_KEYS + ("rnnt_loss", "ctc_loss"))):
        argv = recipe_argv(cfg, f"{tmp}/rnnt_family", tmp, corpus,
                           f"trainer.log_interval={CONF_LOG_EVERY}",
                           f"trainer.val_check_interval={RNNT_STEPS}")
        trainer, rec = conformer_train_run(card, name, cfg, argv, RNNT_STEPS,
                                           RNNT_STEPS, keys)
        assert type(trainer.task) is cls and trainer.clip == 5.0
        want = {"val_loss", "wer"} | ({"val_rnnt_loss", "val_ctc_loss"}
                                      if name == "hybrid" else set())
        assert all(set(m) == want for m in rec["evals"].values()), \
            rec["evals"]
        fam_runs[name] = rec
        train_cfgs[name] = os.path.join(trainer.workdir,
                                        os.path.basename(cfg))
        del trainer
    step_launches["rnnt_step"] = phase_rnnt_step(card, out)
    out["build_task"] = fam_runs

    # (d) the three inference YAMLs on (c)'s checkpoints
    per_batch, infer_fbank, infer_batches, infer_worst = {}, 0, 0, 0.0
    decode = {}
    for name, (cfg, kind) in RNNT_INFER.items():
        run, err = conformer_inference(
            card, name, recipe_infer_argv(cfg, f"{tmp}/rnnt_infer/{name}",
                                          train_cfgs[kind], corpus))
        infer_worst = max(infer_worst, err)
        infer_fbank += run["launches"]["fbank"]
        infer_batches += run["batches"]
        per_batch[name] = {k: n / run["batches"]
                           for k, n in run["launches"].items()}
        task, dev = run["task"], run["device"]
        batches = device_batches(task, dev)
        parts, tokens = infer_parts(task, batches)
        per = {k: statistics.mean(v) for k, v in parts.items()}
        seeded = RnntModel.from_config(run["train_config"])
        seeded.init_weights(torch.Generator().manual_seed(SEED + 42))
        task.model.load_state_dict(seeded.state_dict())
        cpu_model = seeded.eval()
        cpu_dec = build_decoding(run["train_config"]["metric"],
                                 cpu_model.predictor_step,
                                 cpu_model.predictor.init_state,
                                 cpu_model.joiner_step)

        def rnnt_on(model, dec, feats, lens):
            enc, enc_lens = model.encoder(feats, lens)
            return dec.decode(enc, enc_lens)

        n_tok = same_tokens_card_cpu(
            lambda f, l: rnnt_on(task.model, task.decode_session, f, l),
            lambda f, l: rnnt_on(cpu_model, cpu_dec, f, l), task.featurize,
            batches, name)
        log(f"{name}: s per test batch (mean of {len(batches)}): featurize "
            f"{per['featurize']:.4f}, encode {per['encode']:.4f}, decode "
            f"{per['decode']:.4f} ({tokens} tokens of (c)'s weights); f32 "
            f"tokens on seeded weights identical on the card and the CPU "
            f"over {CONF_CPU_BATCHES} test batches: {n_tok} tokens compared",
            card)
        decode[name] = {"s_per_batch": per, "tokens": tokens,
                        "wer": run["wer"], "wall_s": run["wall_s"],
                        "launches": run["launches"],
                        "batches": run["batches"], "card_cpu_tokens": n_tok}
        del run, task, seeded, cpu_model, cpu_dec
        torch.cuda.empty_cache()
    out["decode"] = decode

    runs = list(fam_runs.values())
    held = out["rnnt_step_parts_held"]
    b1_total = run_launches["attn_weights"] + sum(
        r["launches"]["attn_weights"] for r in runs) + sum(
        s["attn_weights"] for s in step_launches.values()) + \
        held["launches"]["attn_weights"]
    fbank_total = run_launches["fbank"] + sum(
        r["launches"]["fbank"] for r in runs) + sum(
        s["fbank"] for s in step_launches.values()) + infer_fbank + \
        held["launches"]["fbank"]
    checked = sum(r["fbank_calls_checked"] for r in runs) + infer_fbank + \
        held["calls_checked"]
    infer_worst = max(infer_worst, held["max_abs_err"])
    wall = time.perf_counter() - t_phase
    log(f"rnnt family phase: {wall:.1f} s; launches B1 {b1_total} (the "
        f"heldout runs: {RUN_LAYERS} per step and per eval batch; 0 in the "
        f"Conformer recipes), B2 {fbank_total}; {n_shapes} heldout batch "
        f"shapes with every B1 and B2 call against the plain versions "
        f"(worst B1 {run_worst['attn_weights']:.3g}, B2 log "
        f"{run_worst['fbank']:.3g}); {checked} B2 calls of the Conformer "
        f"runs, the rnnt step parts' {held['calls_checked']} included, "
        f"within check_mel (worst log error {infer_worst:.3g})", card)
    out["wall_s"] = wall
    report["rnnt_family"] = out

    def per_step(kernel):
        """Launches per training step of each run, measured."""
        got = {"heldout_build_task": run_per_step[kernel]}
        for name, r in fam_runs.items():
            got[f"{name}_build_task"] = (
                r["launches"][kernel] - (kernel == "fbank")
                * len(r["eval_s"]) * r["eval_batches"]) / RNNT_STEPS
        for name, s in step_launches.items():
            got[name] = s[kernel] / TRAIN_STEPS
        return got

    worst_b2 = max([run_worst["fbank"], infer_worst]
                   + [r["fbank_max_abs_err"] for r in runs])
    return {kernel: dict(
        launches=b1_total if kernel == "attn_weights" else fbank_total,
        launches_per_step=per_step(kernel),
        launches_per_batch={k: v[kernel] for k, v in per_batch.items()},
        max_abs_err=run_worst["attn_weights"] if kernel == "attn_weights"
        else worst_b2,
        **({} if kernel == "attn_weights" else dict(calls_checked=checked)))
        for kernel in ("attn_weights", "fbank")}


# ------------------------------------------------------------ phase 15
CIF_CFG = "configs/training/conformer_cif.yaml"
CIF_INFER_CFG = "configs/inference/cif_greedy_search.yaml"
SSL_CFG = "configs/training/conformer_ssl.yaml"
CIF_STEPS, SSL_STEPS, FAM_RESUME_STEPS = 10, 5, 2
LM_STEPS, LM_VAL_EVERY = 20, 10
SSL_B, SSL_SECS = 60, 10
# a CIF token that differs between the card and the CPU is admitted only
# where the utterance's accumulator passed within this of a threshold
CIF_EDGE = 1e-5
CIF_KEYS = CTC_KEYS + ("ce_loss", "mae_loss")
SSL_KEYS = CTC_KEYS + ("acc", "mask_rate")
LM_KEYS = CTC_KEYS + ("acc",)
FAM_SPANS = ("featurize", "backward", "optimizer")


def at_width(enc_cfg, yaml_path):
    """The encoder runs at the training YAML's own width and depth."""
    from speech2text_torch.config import load_config
    want = load_config(yaml_path)["encoder"]["config"]
    got = dataclasses.asdict(enc_cfg)
    assert all(got[k] == v for k, v in want.items()), (yaml_path, got)


def fam_resume(card, name, argv, steps):
    """A fresh Trainer from build_task.prepare restores step `steps`
    (weights and optimizer state bitwise equal to the file) and takes
    FAM_RESUME_STEPS more; returns its last evaluation."""
    from speech2text_torch import build_task
    trainer, fit_kw = build_task.prepare(
        argv + ["--max_steps", str(steps + FAM_RESUME_STEPS)])
    assert trainer.init_state(fit_kw["resume"],
                              fit_kw["finetune_state"]) == steps
    saved = trainer.ckpt.restore(steps)
    assert _same_state(saved["model"], trainer.task.model.state_dict()), \
        f"{name}: restored weights differ from the checkpoint"
    assert _same_state(saved["optimizer"], trainer.optimizer.state_dict()), \
        f"{name}: restored optimizer state differs from the checkpoint"
    trainer.fit(**fit_kw)
    trainer.close()
    assert [h["step"] for h in trainer.history] == list(
        range(steps + 1, steps + FAM_RESUME_STEPS + 1))
    log(f"{name} resume: a fresh Trainer restored step {steps} (weights and "
        f"AdamW state bitwise equal to the file), took steps "
        f"{[h['step'] for h in trainer.history]}, eval {trainer.last_eval}",
        card)
    return trainer.last_eval


def fire_margin(alphas, tail_threshold, threshold=1.0):
    """The least distance of one utterance's integrate-and-fire
    accumulator (f32, in frame order) from `threshold` over its frames, and
    of the final residual from `tail_threshold`."""
    acc = torch.zeros((), dtype=torch.float32)
    margin = math.inf
    for a in alphas:
        new = acc + a
        margin = min(margin, abs(float(new) - threshold))
        acc = new - threshold if new >= threshold else new
    return min(margin, abs(float(acc) - tail_threshold))


def cif_card_cpu(task, cpu_model, batches, card):
    """The free pass on the first CONF_CPU_BATCHES test batches (features
    from the card's B2) on the card and on the CPU: counts and tokens
    equal, but where an utterance's accumulator came within CIF_EDGE of a
    threshold (each such case printed); returns the tokens compared and
    the cases."""
    n, cases = 0, []
    tail = cpu_model.cif.config.tail_threshold
    with torch.no_grad():
        for i, batch in enumerate(batches[:CONF_CPU_BATCHES]):
            feats, lens = task.featurize(batch)
            got = task.model(feats, lens)
            want = cpu_model(feats.cpu(), lens.cpu())
            tok_g = got["logits"].argmax(-1).cpu()
            tok_c = want["logits"].argmax(-1)
            cg, cc = got["emit_counts"].cpu(), want["emit_counts"]
            enc, enc_lens = cpu_model.encoder(feats.cpu(), lens.cpu())
            alphas = cpu_model.cif.alphas(enc, enc_lens)
            for b in range(len(cc)):
                k = int(cc[b])
                if int(cg[b]) == k and torch.equal(tok_g[b, :k],
                                                   tok_c[b, :k]):
                    n += k
                    continue
                margin = fire_margin(alphas[b, :int(enc_lens[b])], tail)
                log(f"cif card/CPU: batch {i} row {b}: counts {int(cg[b])} /"
                    f" {k}, accumulator margin {margin:.3g}", card)
                assert margin < CIF_EDGE, \
                    f"cif tokens differ on the card away from a fire edge " \
                    f"(batch {i} row {b}, margin {margin})"
                cases.append({"batch": i, "row": b, "margin": margin})
    assert n > 0, "cif: the seeded model emitted no token"
    return n, cases


def cif_step_parts(task, optimizer, clip, batch, card):
    """The CIF step at bench.py's shape split into its parts, each ended
    by a synchronise: the encoder, CIF (α predictor and the frame loop,
    Σα rescaled to U), the Projector with CE and MAE, the backward, the
    clipping and AdamW; medians of 3 after a warm-up, the peak memory,
    and one profiled step of the Trainer's own (`step_losses` →
    take_step)."""
    from torch.profiler import ProfilerActivity, profile

    from speech2text_torch.optim import clip_by_global_norm_
    from speech2text_torch.train.step import take_step
    model = task.model
    pcm, pcm_lens, labels, lab_lens = batch
    tb = {"pcm": pcm, "pcm_length": pcm_lens, "label": labels,
          "label_length": lab_lens}
    feats, feat_lens = task.featurize(tb)
    gen = torch.Generator("cuda").manual_seed(SEED + 51)
    sync = torch.cuda.synchronize
    names = ("encoder", "cif", "projector_ce_mae", "backward", "optimizer")
    times = {k: [] for k in names}
    torch.cuda.reset_peak_memory_stats()
    for rep in range(4):
        marks = []
        sync()
        marks.append(time.perf_counter())
        enc, enc_lens = model.encoder(feats, feat_lens, training=True,
                                      generator=gen)
        sync()
        marks.append(time.perf_counter())
        embeds, pred, counts = model.cif(enc, enc_lens, lab_lens)
        sync()
        marks.append(time.perf_counter())
        logits, _ = model.decoder(embeds, counts, training=True,
                                  generator=gen)
        ce = task.ce(logits, tb)
        mae = task.mae_loss({"pred_token_counts": pred,
                             "true_token_counts": lab_lens})
        loss = ce + task.mae_weight * mae
        sync()
        marks.append(time.perf_counter())
        optimizer.zero_grad()
        loss.backward()
        sync()
        marks.append(time.perf_counter())
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        clip_by_global_norm_(grads, clip, torch.nn.utils.get_total_norm(grads))
        optimizer.step()
        sync()
        marks.append(time.perf_counter())
        if rep:
            for k, a, b in zip(names, marks, marks[1:]):
                times[k].append(b - a)
        assert math.isfinite(loss.item()), f"cif step: loss {loss.item()}"
        del enc, embeds, logits, loss
    peak = torch.cuda.max_memory_allocated()
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    total = sum(med.values())
    fired = int(counts.sum())
    gens = tuple(torch.Generator(d).manual_seed(SEED + 52)
                 for d in ("cuda", "cuda", "cpu"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = take_step(model, task.step_losses(tb, 0, gens), optimizer,
                        clip)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    assert all(math.isfinite(float(v)) for v in out.values()), out
    rows, busy, spans = profile_summary(prof, FAM_SPANS)
    log(f"cif train step (B={pcm.shape[0]} x 2-{TRAIN_SECS} s, U <= "
        f"{labels.shape[1]}, T' = {int(enc_lens.max())} CIF frames, {fired} "
        f"fires; median ms of 3, synchronised): " + ", ".join(
            f"{k} {v:.2f}" for k, v in med.items())
        + f"; sum {total:.2f} ms ({pcm.shape[0] / total * 1e3:.2f} utt/s), "
        f"peak memory {peak / 2**30:.2f} GiB; profiled Trainer step: wall "
        f"{wall:.2f} ms, device busy {busy:.2f} ms ({100 * busy / wall:.1f}"
        f"%), {sum(r[2] for r in rows)} device ops; host time of its spans "
        + ", ".join(f"{k} {spans.get(k, float('nan')):.2f} ms"
                    for k in FAM_SPANS), card)
    for key, ms, n in rows[:6]:
        log(f"  {ms:9.3f} ms  x{n:<6d} {key[:90]}", card)
    return {"B": int(pcm.shape[0]), "T_out": int(enc_lens.max()),
            "U": int(labels.shape[1]), "fires": fired, "parts_ms": med,
            "sum_ms": total, "cif_share": med["cif"] / total,
            "peak_memory_bytes": peak, "profiled_wall_ms": wall,
            "device_busy_ms": busy, "span_host_ms": spans,
            "top_device_ops": rows[:20]}


def ssl_batch(rng, B, secs):
    """B utterances of `secs` s of noise and a noise batch of 3-9 s, on
    the card, as the training pipeline hands them over (int16)."""
    def q(x):
        return torch.from_numpy(np.clip(np.round(x * 32768), -32768, 32767)
                                .astype(np.int16)).cuda()
    N, Nn = secs * SR, 9 * SR
    pcm = 0.1 * rng.standard_normal((B, N))
    nlens = rng.integers(3 * SR, Nn + 1, B)
    noise = 0.1 * rng.standard_normal((B, Nn))
    noise[np.arange(Nn)[None] >= nlens[:, None]] = 0.0
    return {"pcm": q(pcm), "pcm_length": torch.full(
        (B,), N, dtype=torch.int32, device="cuda"),
        "noise_pcm": q(noise),
        "noise_length": torch.from_numpy(nlens.astype(np.int32)).cuda()}


def ssl_step_parts(task, optimizer, clip, card):
    """The SSL step at B=SSL_B x SSL_SECS s split into its parts, each
    ended by a synchronise: the raw featurize, the augmented featurize,
    the quantizer's labels and the masking, the encoder, the logits with
    the codebooks' CE losses, the backward, the clipping and AdamW;
    medians of 3 after a warm-up, the peak memory (reckoned beforehand
    from the logits), one profiled step of the Trainer's own."""
    from torch.profiler import ProfilerActivity, profile

    from speech2text_torch.optim import clip_by_global_norm_
    from speech2text_torch.train.step import take_step
    model, brq = task.model, task.best_rq
    batch = ssl_batch(np.random.default_rng(SEED + 61), SSL_B, SSL_SECS)
    gen = torch.Generator("cuda").manual_seed(SEED + 61)
    n, K = brq.cfg.num_codebooks, brq.cfg.codebook_size
    frames = (SSL_SECS * SR - 400) // 160 + 1          # snip_edges, 25/10 ms
    T_out = int(model.encoder.ConvSubsampling_0.output_lengths(
        torch.tensor([frames]))[0])
    logits_gb = n * SSL_B * T_out * K * 4 / 1e9
    log(f"ssl step at B={SSL_B} x {SSL_SECS} s: logits ({n}, {SSL_B}, "
        f"{T_out}, {K}) f32 = {logits_gb:.2f} GB; kept for the backward "
        f"with their log-softmax and their gradient, about "
        f"{3 * logits_gb:.1f} GB at the peak; the label distances one "
        f"codebook at a time, {logits_gb / n:.2f} GB", card)
    sync = torch.cuda.synchronize
    names = ("featurize_raw", "featurize_augmented", "labels_mask",
             "encoder", "logits_ce", "backward", "optimizer")
    times = {k: [] for k in names}
    torch.cuda.reset_peak_memory_stats()
    for rep in range(4):
        marks = []
        sync()
        marks.append(time.perf_counter())
        raw, lens = task.featurize(batch, training=False)
        sync()
        marks.append(time.perf_counter())
        auged, _ = task.featurize(batch, gen, training=True)
        sync()
        marks.append(time.perf_counter())
        masked, labels, mask2, lens2 = brq(raw, auged, lens, gen)
        sync()
        marks.append(time.perf_counter())
        enc, enc_lens = model.encoder(masked, lens, training=True,
                                      generator=gen)
        sync()
        marks.append(time.perf_counter())
        out = task.losses(model.logits(enc), enc_lens, labels, mask2, lens2,
                          True)
        sync()
        marks.append(time.perf_counter())
        optimizer.zero_grad()
        out["loss"].backward()
        sync()
        marks.append(time.perf_counter())
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        clip_by_global_norm_(grads, clip, torch.nn.utils.get_total_norm(grads))
        optimizer.step()
        sync()
        marks.append(time.perf_counter())
        if rep:
            for k, a, b in zip(names, marks, marks[1:]):
                times[k].append(b - a)
        res = {k: float(v) for k, v in out.items()}
        assert all(math.isfinite(v) for v in res.values()), res
        del raw, auged, masked, enc, out
    peak = torch.cuda.max_memory_allocated()
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    total = sum(med.values())
    gens = tuple(torch.Generator(d).manual_seed(SEED + 62)
                 for d in ("cuda", "cuda", "cpu"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_out = take_step(model, task.step_losses(batch, 0, gens),
                             optimizer, clip)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    assert all(math.isfinite(float(v)) for v in step_out.values()), step_out
    rows, busy, spans = profile_summary(prof, FAM_SPANS)
    log(f"ssl train step (B={SSL_B} x {SSL_SECS} s, {n} codebooks x {K}; "
        f"median ms of 3, synchronised): " + ", ".join(
            f"{k} {v:.2f}" for k, v in med.items())
        + f"; sum {total:.2f} ms ({SSL_B / total * 1e3:.2f} utt/s), peak "
        f"memory {peak / 2**30:.2f} GiB; loss {res['loss']:.4f}, acc "
        f"{res['acc']:.4f}, mask_rate {res['mask_rate']:.4f}; profiled "
        f"Trainer step: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%), {sum(r[2] for r in rows)} device ops",
        card)
    for key, ms, cnt in rows[:6]:
        log(f"  {ms:9.3f} ms  x{cnt:<6d} {key[:90]}", card)
    return {"B": SSL_B, "seconds": SSL_SECS, "logits_gb": logits_gb,
            "parts_ms": med, "sum_ms": total, "peak_memory_bytes": peak,
            "losses": res, "profiled_wall_ms": wall, "device_busy_ms": busy,
            "span_host_ms": spans, "top_device_ops": rows[:20]}


def ssl_finetune(card, tmp, corpus, ssl_ckpt, ssl_encoder):
    """conformer_ctc.yaml at the SSL encoder's width and depth, finetuned
    from the SSL checkpoint `ssl_ckpt`: every encoder tensor copied,
    `logits_layer` not; two steps and an evaluation."""
    from speech2text_torch import build_task
    overrides = [f"encoder.config.{k}={v}" for k, v in ssl_encoder.items()
                 if k in ("input_dim", "ffn_dim", "num_layers", "output_dim",
                          "num_heads")]
    argv = recipe_argv(CTC_CFG, f"{tmp}/ssl_finetune", tmp, corpus,
                       f"finetune.base_model={ssl_ckpt}",
                       f"decoder.config.input_dim={ssl_encoder['output_dim']}",
                       "trainer.val_check_interval=2",
                       "trainer.log_interval=1", *overrides)
    trainer, kw = build_task.prepare(argv + ["--max_steps", "2"])
    base = kw["finetune_state"]
    encoder = [k for k in base if k.startswith("encoder.")]
    assert set(base) - set(encoder) == {"logits_layer.weight",
                                        "logits_layer.bias"}, sorted(base)
    trainer.init_state(finetune_state=base)
    live = trainer.task.model.state_dict()
    want = [k for k in live if k.startswith("encoder.")]
    assert trainer.finetune_copied == len(encoder) == len(want), \
        (trainer.finetune_copied, len(encoder), len(want))
    assert all(torch.equal(live[k].cpu(), base[k]) for k in encoder)
    assert not any(k.startswith("logits_layer") for k in live)
    result = trainer.fit(**kw)
    trainer.close()
    assert _finite_record(result, ("val_loss", "wer")), result
    log(f"ssl -> ctc finetune: {trainer.finetune_copied} encoder tensors "
        f"copied of the SSL checkpoint's {len(base)} (logits_layer not), "
        f"equal to the CTC model's {len(want)} encoder tensors; 2 steps, "
        f"eval {result}", card)
    return {"copied": trainer.finetune_copied, "base_tensors": len(base),
            "ctc_encoder_tensors": len(want), "eval": result}


def lm_fusion_checks(card, tmp, trained, lm_dir, lm_dims):
    """Phase 15 (c): the trained LM (averaged by acc) fused into phase
    11's beam + LM decode of the flagship test set through inference's
    main, and an f32 beam + LM request through RnntServer on seeded
    flagship weights equal on the card and the CPU."""
    from speech2text_torch.config import load_config
    from speech2text_torch.serve import RnntServer
    from speech2text_torch.train.checkpoint import average_checkpoints
    train_cfg = os.path.join(trained["workdir"], os.path.basename(TRAIN_CFG))
    fusion = [f"decoding.config.lm_fusion.checkpoint_dir={lm_dir}",
              f"decoding.config.lm_fusion.lm_weight={LM_WEIGHT}"] + [
        f"decoding.config.lm_fusion.lm_config.{k}={v}"
        for k, v in lm_dims.items()]
    argv = ["--inference_config", BEAM_CFG,
            "--override", f"task.train_config={train_cfg}",
            "--override", f"task.export_path={tmp}/infer/beam_trained_lm",
            "--override",
            f"testset.test_data={trained['corpus']['eval_data']}"]
    for ov in fusion:
        argv += ["--override", ov]
    run = run_inference("beam+trained lm", argv, card, RUN_LAYERS)
    task = run["task"]
    want = average_checkpoints(lm_dir, best_k=1, monitor="acc", mode="max")
    assert task.lm is not None and all(
        torch.equal(v.cpu(), want[k]) for k, v in task.lm.state_dict().items())
    del run, task
    torch.cuda.empty_cache()

    cfg32 = load_config(BEAM_CFG)
    train32 = load_config(train_cfg)
    train32["encoder"]["config"]["dtype"] = "float32"
    cfg32["task"]["train_config"] = train32
    cfg32["decoding"].setdefault("config", {})["lm_fusion"] = {
        "checkpoint_dir": lm_dir, "lm_weight": LM_WEIGHT,
        "lm_config": dict(lm_dims)}
    pcm, lens = requests(np.random.default_rng(SEED + 71), 1, 4, 2, 6)[0]
    dev_out = []
    for dev in ("cuda", "cpu"):
        server = RnntServer(cfg32, device=dev, seed=SEED + 72)
        assert server.lm is not None
        dev_out.append(server.transcribe(pcm, lens))
    (tg, cg), (tc, cc) = dev_out
    assert torch.equal(cg.cpu(), cc) and torch.equal(tg.cpu(), tc), \
        "f32 beam + trained LM tokens differ between card and CPU"
    assert int(cc.sum()) > 0, "beam + trained LM: no token emitted"
    log(f"beam + trained LM: f32 W=4 B=4 2-6 s on seeded flagship weights, "
        f"{int(cc.sum())} tokens identical on the card and the CPU", card)
    return int(cc.sum())


def phase_task_families(card, report, tmp, trained):
    """Phase 15: the CIF, SSL (BEST-RQ) and NNLM families on phase 10's
    corpus: (a) conformer_cif.yaml through build_task with a bitwise
    resume, cif_greedy_search.yaml on its checkpoints, f32 tokens on
    seeded weights card = CPU, its step at bench.py's shape in parts;
    (b) conformer_ssl.yaml through build_task with a resume, its step at
    B=60 x 10 s in parts, the SSL -> CTC finetune; (c) rnn_lm.yaml through
    build_task with a bitwise resume, its checkpoint fused into phase
    11's beam + LM decode."""
    from speech2text_torch.config import load_config
    from speech2text_torch.tasks.cif import CifModel, CifTask
    from speech2text_torch.tasks.nnlm import NnLmTask
    from speech2text_torch.tasks.ssl import SslTask
    t_phase = time.perf_counter()
    out = {}
    corpus = trained["corpus"]
    spm = load_config(os.path.join(trained["workdir"], os.path.basename(
        TRAIN_CFG)))["tokenizer"]["config"]["spm_model"]

    def argv_of(cfg, steps, *extra):
        return recipe_argv(cfg, f"{tmp}/families", tmp, corpus,
                           f"trainer.log_interval={CONF_LOG_EVERY}",
                           f"trainer.val_check_interval={steps}", *extra)

    # the resumes and step parts of each family, through held_run: their
    # launches counted and every B2 call held to the plain version
    held = {"cif": {}, "ssl": {}, "nnlm": {}}

    def held_fam(name, run, fn):
        result, held[name][run] = held_run(f"{name} {run}", fn)
        return result

    # (a) CIF: build_task, resume, inference, card = CPU, the step's parts
    argv = argv_of(CIF_CFG, CIF_STEPS)
    trainer, rec = conformer_train_run(card, "cif", CIF_CFG, argv, CIF_STEPS,
                                       CIF_STEPS, CIF_KEYS)
    task = trainer.task
    assert isinstance(task, CifTask) and trainer.clip == 5.0
    at_width(task.model.encoder.config, CIF_CFG)
    rec["resume_eval"] = held_fam("cif", "resume", lambda: fam_resume(
        card, "cif", argv, CIF_STEPS))
    cif_train_cfg = os.path.join(trainer.workdir, os.path.basename(CIF_CFG))
    rng = np.random.default_rng(SEED + 51)
    pcm, lens, labels, lab_lens = train_pcm(rng, B_TRAIN, 2, TRAIN_SECS,
                                            TRAIN_U, 128)
    batch = tuple(torch.from_numpy(x).cuda()
                  for x in (pcm, lens, labels, lab_lens))
    rec["step_parts"] = held_fam("cif", "step_parts", lambda: cif_step_parts(
        task, trainer.optimizer, trainer.clip, batch, card))
    out["cif_train"] = rec
    del trainer, task, batch
    torch.cuda.empty_cache()
    run, cif_worst = conformer_inference(
        card, "cif_greedy", recipe_infer_argv(
            CIF_INFER_CFG, f"{tmp}/families_infer/cif", cif_train_cfg,
            corpus))
    task, dev = run["task"], run["device"]
    assert isinstance(task, CifTask)
    batches = device_batches(task, dev)
    seeded = CifModel.from_config(run["train_config"])
    seeded.init_weights(torch.Generator().manual_seed(SEED + 53))
    task.model.load_state_dict(seeded.state_dict())
    n_tok, cases = cif_card_cpu(task, seeded.eval(), batches, card)
    log(f"cif_greedy_search: corpus WER {run['wer']:.4f}, "
        f"{run['batches']} test batches in {run['wall_s']:.2f} s; f32 tokens "
        f"on seeded weights identical on the card and the CPU over "
        f"{CONF_CPU_BATCHES} test batches: {n_tok} tokens compared, "
        f"{len(cases)} utterances at a fire edge", card)
    out["cif_decode"] = {"wer": run["wer"], "wall_s": run["wall_s"],
                         "launches": run["launches"],
                         "batches": run["batches"], "card_cpu_tokens": n_tok,
                         "fire_edge_cases": cases}
    cif_infer = run["launches"]
    del run, task, seeded, batches
    torch.cuda.empty_cache()

    # (b) SSL: build_task (3 B2 per step), resume, the step's parts, the
    # finetune chain
    argv = argv_of(SSL_CFG, SSL_STEPS)
    trainer, rec = conformer_train_run(
        card, "ssl", SSL_CFG, argv, SSL_STEPS, SSL_STEPS, SSL_KEYS,
        eval_keys=("val_loss", "acc"), fbank_per_step=3, vocab=None)
    task = trainer.task
    brq = load_config(SSL_CFG)["ssl"]["best_rq"]
    assert isinstance(task, SslTask) and tuple(
        task.best_rq.codebooks.shape) == (brq["num_codebooks"],
                                          brq["codebook_size"],
                                          brq["codebook_dim"])
    at_width(task.model.encoder.config, SSL_CFG)
    assert (trainer.ckpt.monitor, trainer.ckpt.mode) == ("acc", "max")
    assert all(set(m) == {"val_loss", "acc"} for m in rec["evals"].values())
    rec["resume_eval"] = held_fam("ssl", "resume", lambda: fam_resume(
        card, "ssl", argv, SSL_STEPS))
    rec["step_parts"] = held_fam("ssl", "step_parts", lambda: ssl_step_parts(
        task, trainer.optimizer, trainer.clip, card))
    ssl_ckpt = trainer.ckpt.path(SSL_STEPS)
    ssl_encoder = dataclasses.asdict(task.model.encoder.config)
    out["ssl_train"] = rec
    del trainer, task
    torch.cuda.empty_cache()
    out["ssl_finetune"] = ssl_finetune(card, tmp, corpus, ssl_ckpt,
                                       ssl_encoder)
    torch.cuda.empty_cache()

    # (c) NNLM: build_task (no B2), resume, fusion into phase 11's decode
    lm_dims = load_config(LM_CFG)["lm"]["config"]
    argv = recipe_argv(LM_CFG, f"{tmp}/families", tmp, corpus,
                       f"trainer.log_interval={CONF_LOG_EVERY}",
                       f"trainer.val_check_interval={LM_VAL_EVERY}",
                       f"tokenizer.config.spm_model={spm}",
                       "tokenizer.apply_train=false")
    trainer, rec = conformer_train_run(
        card, "rnn_lm", LM_CFG, argv, LM_STEPS, LM_VAL_EVERY, LM_KEYS,
        eval_keys=("val_loss", "acc"), fbank_per_step=0,
        fbank_per_eval_batch=0)
    assert isinstance(trainer.task, NnLmTask) and trainer.clip == 5.0
    assert all(set(m) == {"val_loss", "acc"} for m in rec["evals"].values())
    tokens_s = [r["frames_per_sec"] for r in rec["metrics_lines"]]
    log(f"rnn_lm ({lm_dims}): {rec['median_ms']:.2f} ms per step, tokens/s "
        f"{[round(x, 1) for x in tokens_s]}", card)
    rec["tokens_per_s"] = tokens_s
    rec["resume_eval"] = held_fam("nnlm", "resume", lambda: fam_resume(
        card, "rnn_lm", argv, LM_STEPS))
    lm_dir = trainer.ckpt.directory
    out["lm_train"] = rec
    del trainer
    out["lm_fusion_card_cpu_tokens"] = lm_fusion_checks(card, tmp, trained,
                                                        lm_dir, lm_dims)
    torch.cuda.empty_cache()

    runs = {"cif": out["cif_train"], "ssl": out["ssl_train"],
            "nnlm": out["lm_train"]}
    worst = max([r["fbank_max_abs_err"] for r in runs.values()]
                + [cif_worst] + [h["max_abs_err"] for f in held.values()
                                 for h in f.values()])
    wall = time.perf_counter() - t_phase

    def held_b2(name):
        return sum(h["launches"]["fbank"] for h in held[name].values())

    log(f"task families phase: {wall:.1f} s; launches B1 0; B2 cif "
        f"{runs['cif']['launches']['fbank']} + {cif_infer['fbank']} in "
        f"inference + {held_b2('cif')} in the resume and step parts, ssl "
        f"{runs['ssl']['launches']['fbank']} + {held_b2('ssl')} in the "
        f"resume and step parts, nnlm {held_b2('nnlm')}; every B2 call "
        f"within check_mel (worst log error {worst:.3g})", card)
    out["wall_s"] = wall
    out["held_runs"] = held
    report["task_families"] = out

    steps = {"cif": CIF_STEPS, "ssl": SSL_STEPS, "nnlm": LM_STEPS}

    def record(name, kernel):
        """A family's launches (its build_task run, and CIF's inference
        run), the launches per training step, measured (less the eval
        batches' B2), and for B2 the calls checked and the worst error."""
        r = runs[name]
        evals = len(r["eval_s"]) * r["eval_batches"] * (name != "nnlm")
        rec = {"launches": r["launches"][kernel],
               "launches_per_step": (r["launches"][kernel] - (
                   kernel == "fbank") * evals) / steps[name]}
        if kernel == "fbank":
            rec.update(calls_checked=r["fbank_calls_checked"],
                       max_abs_err=r["fbank_max_abs_err"])
        rec["launches"] += sum(h["launches"][kernel]
                               for h in held[name].values())
        if kernel == "fbank":
            rec["calls_checked"] += sum(h["calls_checked"]
                                        for h in held[name].values())
            rec["max_abs_err"] = max([rec["max_abs_err"]] + [
                h["max_abs_err"] for h in held[name].values()])
        if name == "cif":
            rec["launches"] += cif_infer[kernel]
            rec["launches_per_test_batch"] = \
                cif_infer[kernel] / out["cif_decode"]["batches"]
            if kernel == "fbank":
                rec["calls_checked"] += cif_infer[kernel]
                rec["max_abs_err"] = max(rec["max_abs_err"], cif_worst)
        return rec

    return {kernel: {name: record(name, kernel) for name in runs}
            for kernel in ("attn_weights", "fbank")}


# ------------------------------------------------------------ phase 16
EMF_CFG = "configs/training/emformer_ctc.yaml"
W2V_CFG = "configs/training/wav2vec2_ctc.yaml"
EMF_STEPS, W2V_STEPS = 10, 5
# wav2vec2's step: B=128 would keep ~8.4 GB per extractor activation and
# ~12 GB of attention weights; 64 x 10 s
W2V_B, W2V_SECS, W2V_CPU_BATCHES = 64, 10, 1
EMF_MEMORY, EMF_STREAM_CHUNKS = 4, 8
# raw fbank frames of one 16-frame segment after the rate-4 subsampling
EMF_CHUNK_FRAMES = 67
# the CMVN run reads this many train batches (JAX's build_task reads 200;
# at ~0.3 s of host loading a batch the phase takes a few)
CMVN_CHIP_BATCHES = 16
# card vs CPU statistics: the B2 and plain features differ by rounding
CMVN_TOL = dict(rtol=1e-4, atol=1e-5)
ACCUM, ACCUM_MICRO, ACCUM_LAYERS = 2, 4, 2
# the accumulation run's buckets (the YAML's 600 s of audio per batch and
# 16 utterances at least): its CPU twin takes ~8 s per such micro-batch
ACCUM_VOLUME, ACCUM_MIN_BATCH = 60.0, 4
ENC_SPANS = ("featurize", "backward", "optimizer")


def ctc_recipe_step_parts(name, task, optimizer, clip, batch, card):
    """A CTC recipe's step split into its parts, each ended by a
    synchronise: featurize, the encoder, the CTC forward (Projector head
    and CTC loss), the backward, the clipping and AdamW; medians of 3
    after a warm-up, the peak memory, and one profiled step of the
    Trainer's own (`step_losses` → take_step) with its device busy share.
    The kernel launches of those five steps are counted and every call
    captured; each step's B2 calls are held to the plain version after
    its last mark. The peak is reset at each step and read before that
    check: it includes the step's captured B2 inputs and outputs."""
    from torch.profiler import ProfilerActivity, profile

    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import fbank as fb
    from speech2text_torch.optim import clip_by_global_norm_
    from speech2text_torch.train.step import take_step
    model = task.model
    pcm, pcm_lens, labels, lab_lens = batch
    tb = {"pcm": pcm, "pcm_length": pcm_lens, "label": labels,
          "label_length": lab_lens}
    gen = torch.Generator("cuda").manual_seed(SEED + 61)
    gens = tuple(torch.Generator(d).manual_seed(SEED + 62)
                 for d in ("cuda", "cuda", "cpu"))
    sync = torch.cuda.synchronize
    names = ("featurize", "encoder", "ctc_forward", "backward", "optimizer")
    times = {k: [] for k in names}
    peak = n_checked = 0
    worst = 0.0
    sync()
    calls = KernelCalls()
    aw.KERNEL.launches = fb.KERNEL.launches = 0
    try:
        for rep in range(4):
            torch.cuda.reset_peak_memory_stats()
            marks = []
            sync()
            marks.append(time.perf_counter())
            feats, feat_lens = task.featurize(tb)
            sync()
            marks.append(time.perf_counter())
            enc, enc_lens = model.encoder(feats, feat_lens, training=True,
                                          generator=gen)
            sync()
            marks.append(time.perf_counter())
            logits, out_lens = model.decoder(enc, enc_lens, training=True,
                                             generator=gen)
            loss = task.loss({"logits": logits, "logits_length": out_lens,
                              "label": labels, "label_length": lab_lens})
            sync()
            marks.append(time.perf_counter())
            optimizer.zero_grad()
            loss.backward()
            sync()
            marks.append(time.perf_counter())
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            clip_by_global_norm_(grads, clip,
                                 torch.nn.utils.get_total_norm(grads))
            optimizer.step()
            sync()
            marks.append(time.perf_counter())
            peak = max(peak, torch.cuda.max_memory_allocated())
            if rep:
                for k, a, b in zip(names, marks, marks[1:]):
                    times[k].append(b - a)
            assert math.isfinite(loss.item()), \
                f"{name} step: loss {loss.item()}"
            del feats, enc, logits, loss, grads
            n, w, _ = check_fbank_calls(calls, f"{name} step {rep}")
            n_checked, worst = n_checked + n, max(worst, w)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = take_step(model, task.step_losses(tb, 0, gens), optimizer,
                            clip)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        launches = {"attn_weights": aw.KERNEL.launches,
                    "fbank": fb.KERNEL.launches}
        n, w, _ = check_fbank_calls(calls, f"{name} profiled step")
        n_checked, worst = n_checked + n, max(worst, w)
    finally:
        calls.close()
    assert n_checked == launches["fbank"], \
        f"{name}: {n_checked} B2 calls checked of {launches['fbank']}"
    assert all(math.isfinite(float(v)) for v in out.values()), out
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    total = sum(med.values())
    rows, busy, spans = profile_summary(prof, ENC_SPANS)
    log(f"{name} train step (B={pcm.shape[0]}, N={pcm.shape[1]} samples, U "
        f"<= {labels.shape[1]}, T' = {int(out_lens.max())} CTC frames; "
        f"median ms of 3, synchronised): " + ", ".join(
            f"{k} {v:.2f}" for k, v in med.items())
        + f"; sum {total:.2f} ms ({pcm.shape[0] / total * 1e3:.2f} utt/s), "
        f"peak memory {peak / 2**30:.2f} GiB; launches {launches} over 5 "
        f"steps, {n_checked} B2 calls within check_mel (worst log error "
        f"{worst:.3g}); profiled Trainer step: wall {wall:.2f} ms, device "
        f"busy {busy:.2f} ms ({100 * busy / wall:.1f} %), "
        f"{sum(r[2] for r in rows)} device ops; host time of its spans "
        + ", ".join(f"{k} {spans.get(k, float('nan')):.2f} ms"
                    for k in ENC_SPANS), card)
    for key, ms, n in rows[:6]:
        log(f"  {ms:9.3f} ms  x{n:<6d} {key[:90]}", card)
    return {"B": int(pcm.shape[0]), "N": int(pcm.shape[1]),
            "T_out": int(out_lens.max()), "U": int(labels.shape[1]),
            "parts_ms": med, "sum_ms": total, "peak_memory_bytes": peak,
            "launches": launches, "fbank_calls_checked": n_checked,
            "fbank_max_abs_err": worst, "profiled_wall_ms": wall,
            "device_busy_ms": busy, "span_host_ms": spans,
            "top_device_ops": rows[:20]}


def greedy_card_cpu(task, run, batches, seed, what):
    """Seeded weights of the run's model on the card and on the CPU, from
    the same features (the card's featurize), over the test batches
    given: the encoder's output and the logits within ENC_TOL of the
    CPU's, the frame-wise argmax and the greedy CTC tokens identical;
    returns (tokens, frames, the worst encoder and logit errors) compared
    (a seeded model may repeat one label over many frames, which the
    greedy collapse folds into a few tokens)."""
    from speech2text_torch.decoding import build_decoding
    from speech2text_torch.ops.masking import make_non_pad_mask
    from speech2text_torch.tasks.ctc import CtcModel
    seeded = CtcModel.from_config(run["train_config"])
    seeded.init_weights(torch.Generator().manual_seed(seed))
    task.model.load_state_dict(seeded.state_dict())
    cpu_model = seeded.eval()
    dec = build_decoding({"decode_method": "ctc_greedy_search"})
    n_tok = n_frames = 0
    worst_enc = worst_logit = 0.0
    with torch.no_grad():
        for i, batch in enumerate(batches):
            feats, lens = task.featurize(batch)
            enc_g, enc_lens = task.model.encoder(feats, lens)
            got, got_lens = task.model.decoder(enc_g, enc_lens)
            enc_c, enc_lens_c = cpu_model.encoder(feats.cpu(), lens.cpu())
            want, want_lens = cpu_model.decoder(enc_c, enc_lens_c)
            assert torch.equal(got_lens.cpu(), want_lens), what
            worst_enc = max(worst_enc, check_close(
                f"{what} encoder output, batch {i}", enc_g.cpu(), enc_c,
                **ENC_TOL))
            worst_logit = max(worst_logit, check_close(
                f"{what} logits, batch {i}", got.cpu(), want, **ENC_TOL))
            valid = make_non_pad_mask(want_lens, want.shape[1])
            diff = (got.argmax(-1).cpu() != want.argmax(-1)) & valid
            assert not bool(diff.any()), \
                f"{what}: {int(diff.sum())} frames' argmax differ"
            tg, cg = dec.decode(torch.log_softmax(got, -1), got_lens)
            tc, cc = dec.decode(torch.log_softmax(want, -1), want_lens)
            assert torch.equal(cg.cpu(), cc) and torch.equal(tg.cpu(), tc), \
                f"{what}: f32 tokens differ between the card and the CPU"
            n_tok += int(cc.sum())
            n_frames += int(want_lens.sum())
    assert n_tok > 0, f"{what}: the seeded model emitted no token"
    return n_tok, n_frames, worst_enc, worst_logit


def emformer_streaming_card_cpu(cfg, card):
    """`max_memory_size` EMF_MEMORY: EMF_STREAM_CHUNKS streaming steps of
    seeded weights on the card and on the CPU from the same features:
    each chunk's output and every cache, bank and counter within ENC_TOL
    of the CPU's; returns the chunks' worst error and the ms per chunk on
    the card."""
    from speech2text_torch.models.emformer import Emformer, EmformerConfig
    from speech2text_torch.models.layers import init_parameters
    enc_cfg = EmformerConfig(**dict(cfg["encoder"]["config"],
                                    max_memory_size=EMF_MEMORY))
    cpu = Emformer(enc_cfg)
    init_parameters(cpu, torch.Generator().manual_seed(SEED + 63))
    dev = Emformer(enc_cfg)
    dev.load_state_dict(cpu.state_dict())
    dev.cuda()
    rng = np.random.default_rng(SEED + 64)
    chunks = torch.from_numpy(rng.standard_normal(
        (EMF_STREAM_CHUNKS, 2, EMF_CHUNK_FRAMES, enc_cfg.feats_dim))
        .astype(np.float32))
    s_cpu, s_dev = cpu.init_state(2), dev.init_state(2, device="cuda")
    worst, ms = 0.0, []
    with torch.no_grad():
        for c in chunks:
            out_cpu, s_cpu = cpu.streaming_step(c, s_cpu)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_dev, s_dev = dev.streaming_step(c.cuda(), s_dev)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            assert out_dev.shape == (2, enc_cfg.segment_length,
                                     enc_cfg.output_dim)
            for i, (g, w) in enumerate(zip([out_dev] + s_dev,
                                           [out_cpu] + s_cpu)):
                check_close(f"emformer streaming step tensor {i}", g.cpu(),
                            w, **ENC_TOL)
            worst = max(worst, float((out_dev.cpu() - out_cpu).abs().max()))
    assert s_dev[-1].tolist() == [EMF_STREAM_CHUNKS] * 2
    log(f"emformer max_memory_size={EMF_MEMORY}: {EMF_STREAM_CHUNKS} "
        f"streaming_step chunks ({EMF_CHUNK_FRAMES} fbank frames -> "
        f"{enc_cfg.segment_length}, B=2, f32, seeded weights) on the card "
        f"equal the CPU's within {ENC_TOL} (outputs, {enc_cfg.num_layers} "
        f"caches, {enc_cfg.num_layers} banks, the counter; worst output "
        f"error {worst:.3g}); ms per chunk on the card "
        f"{[round(x, 2) for x in ms]}", card)
    return {"chunks": EMF_STREAM_CHUNKS, "max_abs_err": worst,
            "ms_per_chunk": ms}


def w2v2_checkpoints(tmp, enc_cfg, card):
    """Synthetic HF checkpoints at the YAML's width from the seed, written
    by the port's writer in both layouts (the stable one with torch's
    parametrized weight-norm names, half its tensors BF16) and converted
    by the port's tool; returns the base file's path and its tensors."""
    from speech2text_torch.config import from_dict
    from speech2text_torch.models.wav2vec2 import Wav2Vec2Config
    from speech2text_torch.tools import convert_wav2vec2 as conv
    c = from_dict(Wav2Vec2Config, enc_cfg)
    dims = dict(hidden=c.hidden_dim, num_layers=c.num_layers, ffn=c.ffn_dim,
                pos_kernel=c.conv_pos_kernel, pos_groups=c.conv_pos_groups)
    out = {}
    for stable in (False, True):
        t0 = time.perf_counter()
        tensors = conv.synthetic_hf_tensors(
            stable=stable, seed=SEED + 65 + stable, parametrized=stable,
            prefix="wav2vec2." if stable else "", **dims)
        st = os.path.join(tmp, f"w2v2_{int(stable)}.safetensors")
        conv.write_safetensors(tensors, st, bf16=sorted(tensors)[::2]
                               if stable else ())
        path = os.path.join(tmp, f"w2v2_{int(stable)}.pt")
        state, layout = conv.convert(st, path)
        assert layout == {"num_layers": dims["num_layers"],
                          "do_stable_layer_norm": int(stable),
                          "feat_extract_norm": int(stable)}, layout
        n = sum(t.numel() for t in state.values())
        log(f"wav2vec2 {'stable' if stable else 'base'} checkpoint: "
            f"{len(tensors)} HF tensors ({os.path.getsize(st) / 2**20:.0f} "
            f"MiB) -> {len(state)} encoder tensors, {n} parameters, layout "
            f"{layout}, in {time.perf_counter() - t0:.1f} s", card)
        out[stable] = (path, state)
    return out


def held_run(label, fn):
    """`fn()` through counted_main: its kernel launches counted and every
    B2 call held to the plain version; returns (its result, its record:
    launches, calls checked, worst log-domain error)."""
    result, _, launches, _, calls = counted_main(lambda _: fn(), None)
    n, worst, _ = checked_calls(calls, label, launches["fbank"])
    return result, {"launches": launches, "calls_checked": n,
                    "max_abs_err": worst}


def phase_ctc_encoders(card, report, tmp, trained):
    """Phase 16: the last two CTC encoders and the loop options on phase
    10's corpus, f32 with TF32 off: (a) emformer_ctc.yaml through
    build_task with a bitwise resume, ctc_greedy_search.yaml on its
    checkpoints, on seeded weights the encoder output and logits card =
    CPU within ENC_TOL and the f32 tokens equal, its step at B=128 x 2-10
    s in parts, the max_memory_size override's step and streaming_step
    card = CPU; (b) wav2vec2_ctc.yaml from a converted synthetic HF
    checkpoint through build_task with a resume, its greedy decode with
    the same card = CPU checks, its step at B=64 x 10 s, 0 kernel
    launches; (c) global CMVN computed by build_task, its cmvn.json against
    the CPU's, and accumulate_grad_batches 2 over 4 micro-batches card =
    CPU. Every run of the phase on the card has its kernel launches
    counted and every B2 call held to the plain version; the returned
    records are those counts' sums."""
    from speech2text_torch import build_task
    from speech2text_torch.config import load_config
    from speech2text_torch.models.cmvn import compute_cmvn_stats
    from speech2text_torch.models.emformer import Emformer
    from speech2text_torch.models.wav2vec2 import Wav2Vec2Encoder
    from speech2text_torch.ops import fbank as fb
    from speech2text_torch.optim import MultiSteps, OptimSetup
    from speech2text_torch.tasks.ctc import CtcModel, CtcTask
    assert not torch.backends.cuda.matmul.allow_tf32 and \
        not torch.backends.cudnn.allow_tf32
    t_phase = time.perf_counter()
    out = {}
    corpus = trained["corpus"]
    # every run of the phase that may launch a kernel: its launches, the
    # B2 calls held to the plain version and their worst log error, by
    # path ("emformer", "wav2vec2", "cmvn", "accumulation") and run
    runs = {p: {} for p in ("emformer", "wav2vec2", "cmvn", "accumulation")}

    def note(path, run, launches, calls_checked, max_abs_err):
        assert calls_checked == launches["fbank"], \
            (path, run, calls_checked, launches)
        runs[path][run] = {"launches": dict(launches),
                           "calls_checked": calls_checked,
                           "max_abs_err": max_abs_err}

    def noted(path, run, rec):
        note(path, run, rec["launches"], rec["fbank_calls_checked"],
             rec["fbank_max_abs_err"])

    def argv_of(cfg, sub, steps, *extra):
        return recipe_argv(cfg, f"{tmp}/{sub}", tmp, corpus,
                           f"trainer.log_interval={CONF_LOG_EVERY}",
                           f"trainer.val_check_interval={steps}", *extra)

    # (a) Emformer: build_task, resume, greedy inference, card = CPU
    argv = argv_of(EMF_CFG, "encoders", EMF_STEPS)
    trainer, rec = conformer_train_run(card, "emformer", EMF_CFG, argv,
                                       EMF_STEPS, EMF_STEPS, CTC_KEYS)
    noted("emformer", "build_task", rec)
    task = trainer.task
    assert isinstance(task.model.encoder, Emformer) and trainer.clip == 5.0
    at_width(task.model.encoder.config, EMF_CFG)
    rec["resume_eval"], held = held_run(
        "emformer resume", lambda: fam_resume(card, "emformer", argv,
                                              EMF_STEPS))
    note("emformer", "resume", **held)
    emf_train_cfg = os.path.join(trainer.workdir, os.path.basename(EMF_CFG))
    rng = np.random.default_rng(SEED + 60)
    pcm, lens, labels, lab_lens = train_pcm(rng, B_TRAIN, 2, TRAIN_SECS,
                                            TRAIN_U, 128)
    batch = tuple(torch.from_numpy(x).cuda()
                  for x in (pcm, lens, labels, lab_lens))
    rec["step_parts"] = ctc_recipe_step_parts(
        "emformer", task, trainer.optimizer, trainer.clip, batch, card)
    noted("emformer", "step_parts", rec["step_parts"])
    # the memory-bank override at the same width: its step, then streaming
    cfg = load_config(EMF_CFG)
    cfg["encoder"]["config"]["max_memory_size"] = EMF_MEMORY
    task.model = CtcModel.from_config(cfg)
    task.model.init_weights(torch.Generator().manual_seed(SEED + 62))
    task.model.cuda()
    optimizer, _ = OptimSetup(cfg["optim_setup"],
                              task.model.named_parameters())
    rec["memory_step_parts"] = ctc_recipe_step_parts(
        f"emformer max_memory_size={EMF_MEMORY}", task, optimizer,
        trainer.clip, batch, card)
    noted("emformer", "memory_step_parts", rec["memory_step_parts"])
    rec["memory_streaming"], held = held_run(
        "emformer streaming", lambda: emformer_streaming_card_cpu(cfg, card))
    note("emformer", "memory_streaming", **held)
    out["emformer_train"] = rec
    del trainer, task, batch, optimizer
    torch.cuda.empty_cache()
    run, emf_worst = conformer_inference(
        card, "emformer_greedy", recipe_infer_argv(
            CTC_INFER["greedy"], f"{tmp}/encoders_infer/emformer",
            emf_train_cfg, corpus))
    note("emformer", "inference", run["launches"], run["launches"]["fbank"],
         emf_worst)
    task, dev = run["task"], run["device"]
    assert isinstance(task.model.encoder, Emformer)
    batches = device_batches(task, dev)
    (n_tok, n_frames, enc_err, logit_err), held = held_run(
        "emformer card/CPU", lambda: greedy_card_cpu(
            task, run, batches[:CONF_CPU_BATCHES], SEED + 66,
            "emformer greedy"))
    note("emformer", "card_cpu", **held)
    log(f"emformer ctc_greedy_search: corpus WER {run['wer']:.4f}, "
        f"{run['batches']} test batches in {run['wall_s']:.2f} s; on seeded "
        f"weights over {CONF_CPU_BATCHES} test batches, the card's f32 "
        f"encoder output and logits within {ENC_TOL} of the CPU's (worst "
        f"{enc_err:.3g}, {logit_err:.3g}), frame argmax and tokens "
        f"identical: {n_frames} frames, {n_tok} tokens compared", card)
    out["emformer_decode"] = {"wer": run["wer"], "wall_s": run["wall_s"],
                              "launches": run["launches"],
                              "batches": run["batches"],
                              "card_cpu_tokens": n_tok,
                              "card_cpu_frames": n_frames,
                              "card_cpu_encoder_max_abs_err": enc_err,
                              "card_cpu_logits_max_abs_err": logit_err}
    del run, task, batches
    torch.cuda.empty_cache()

    # (b) Wav2Vec2 from a converted synthetic HF checkpoint
    w2v_cfg = load_config(W2V_CFG)
    ckpts = w2v2_checkpoints(tmp, w2v_cfg["encoder"]["config"], card)
    base_path, base_state = ckpts[False]
    stable_path, _ = ckpts[True]
    mismatch = CtcTask(dict(w2v_cfg, encoder={
        "model": "Wav2Vec2", "config": dict(w2v_cfg["encoder"]["config"],
                                            pretrained_path=stable_path)},
        tokenizer={"type": "char", "config": {}}))
    try:
        mismatch.merge_pretrained_encoder()
        raise AssertionError("a stable checkpoint merged into the base "
                             "layout")
    except ValueError as err:
        assert "layout mismatch" in str(err), err
    stable = CtcTask(dict(w2v_cfg, encoder={
        "model": "Wav2Vec2", "config": dict(
            w2v_cfg["encoder"]["config"], pretrained_path=stable_path,
            feat_extract_norm="layer", do_stable_layer_norm=True)},
        tokenizer={"type": "char", "config": {}}))
    n_stable = stable.merge_pretrained_encoder()
    del mismatch, stable
    argv = argv_of(W2V_CFG, "encoders", W2V_STEPS,
                   f"encoder.config.pretrained_path={base_path}")
    trainer, rec = conformer_train_run(
        card, "wav2vec2", W2V_CFG, argv, W2V_STEPS, W2V_STEPS, CTC_KEYS,
        fbank_per_step=0, fbank_per_eval_batch=0)
    noted("wav2vec2", "build_task", rec)
    task = trainer.task
    assert isinstance(task.model.encoder, Wav2Vec2Encoder)
    got = dataclasses.asdict(task.model.encoder.config)
    assert all(got[k] == v for k, v in dict(
        w2v_cfg["encoder"]["config"], pretrained_path=base_path).items()), \
        got
    enc = task.model.encoder.state_dict()
    # the frozen extractor moved only by AdamW's decay (lr·wd per step)
    for k, v in base_state.items():
        if k.startswith("feature_extractor."):
            check_close(f"wav2vec2 merged {k}", enc[k].cpu(), v, 1e-4, 0.0)
    log(f"wav2vec2: the base checkpoint ({len(base_state)} tensors) merged "
        f"through pretrained_path (frozen extractor within 1e-4 of it after "
        f"{W2V_STEPS} steps); the stable one merges into a stable-layout "
        f"config ({n_stable} tensors) and raises ValueError on the base "
        f"config", card)
    rec["resume_eval"], held = held_run(
        "wav2vec2 resume", lambda: fam_resume(card, "wav2vec2", argv,
                                              W2V_STEPS))
    note("wav2vec2", "resume", **held)
    w2v_train_cfg = os.path.join(trainer.workdir, os.path.basename(W2V_CFG))
    rng = np.random.default_rng(SEED + 67)
    pcm, lens, labels, lab_lens = train_pcm(rng, W2V_B, W2V_SECS, W2V_SECS,
                                            TRAIN_U, 128)
    batch = tuple(torch.from_numpy(x).cuda()
                  for x in (pcm, lens, labels, lab_lens))
    rec["step_parts"] = ctc_recipe_step_parts(
        "wav2vec2", task, trainer.optimizer, trainer.clip, batch, card)
    noted("wav2vec2", "step_parts", rec["step_parts"])
    out["wav2vec2_train"] = rec
    del trainer, task, batch, enc
    torch.cuda.empty_cache()
    run, _ = conformer_inference(
        card, "wav2vec2_greedy", recipe_infer_argv(
            CTC_INFER["greedy"], f"{tmp}/encoders_infer/wav2vec2",
            w2v_train_cfg, corpus), fbank_per_batch=0)
    note("wav2vec2", "inference", run["launches"], 0, 0.0)
    task, dev = run["task"], run["device"]
    batches = device_batches(task, dev)
    (n_w2v, w2v_frames, enc_err, logit_err), held = held_run(
        "wav2vec2 card/CPU", lambda: greedy_card_cpu(
            task, run, batches[:W2V_CPU_BATCHES], SEED + 68,
            "wav2vec2 greedy"))
    note("wav2vec2", "card_cpu", **held)
    w2v_dims = "{hidden_dim} x {num_layers}".format(
        **dataclasses.asdict(task.model.encoder.config))
    log(f"wav2vec2 ctc_greedy_search: corpus WER {run['wer']:.4f}, "
        f"{run['batches']} test batches in {run['wall_s']:.2f} s, launches "
        f"{run['launches']}; on seeded weights over {W2V_CPU_BATCHES} test "
        f"batch, the card's f32 encoder output (extractor, {w2v_dims} "
        f"stack, head) and logits within {ENC_TOL} of the CPU's on the same "
        f"PCM "
        f"(worst {enc_err:.3g}, {logit_err:.3g}), frame argmax and tokens "
        f"identical: {w2v_frames} frames, {n_w2v} tokens compared", card)
    out["wav2vec2_decode"] = {"wer": run["wer"], "wall_s": run["wall_s"],
                              "launches": run["launches"],
                              "batches": run["batches"],
                              "card_cpu_tokens": n_w2v,
                              "card_cpu_frames": w2v_frames,
                              "card_cpu_encoder_max_abs_err": enc_err,
                              "card_cpu_logits_max_abs_err": logit_err}
    del run, task, batches
    torch.cuda.empty_cache()

    # (c) global CMVN computed by build_task: CMVN_CHIP_BATCHES B2 calls
    # first, their lengths recorded; the CPU's statistics from the plain
    # fbank on the same PCM
    build_task.CMVN_BATCHES = CMVN_CHIP_BATCHES
    lens_seen = []
    feature_batches = build_task.cmvn_feature_batches

    def recorded(task, device):
        for feats, lens in feature_batches(task, device):
            lens_seen.append(lens)
            yield feats, lens

    build_task.cmvn_feature_batches = recorded
    argv = argv_of(EMF_CFG, "cmvn", 2, "callbacks.global_cmvn.apply=true")
    try:
        trainer, run_s, launches, _, calls = counted_main(
            build_task.main, argv + ["--max_steps", "2"])
    finally:
        build_task.cmvn_feature_batches = feature_batches
    try:
        assert len(calls["fbank"]) == launches["fbank"] and \
            len(lens_seen) == CMVN_CHIP_BATCHES
        with torch.no_grad():
            cpu_feats = [fb.fbank_plain(*(x.cpu() if isinstance(
                x, torch.Tensor) else x for x in a))
                for a, _ in calls["fbank"][:CMVN_CHIP_BATCHES]]
        cpu_stats = compute_cmvn_stats(
            (f.numpy(), n) for f, n in zip(cpu_feats, lens_seen))
    except BaseException:
        calls.close()
        raise
    n_checked, cmvn_worst, _ = checked_calls(calls, "cmvn run",
                                             launches["fbank"])
    eval_batches = trainer.task.make_eval_pipeline().batches_per_epoch()
    want = CMVN_CHIP_BATCHES + 2 * 2 + eval_batches
    assert launches == {"attn_weights": 0, "fbank": want}, launches
    with open(os.path.join(trainer.workdir, "cmvn.json")) as f:
        stats = json.load(f)
    for key in ("mean", "istd"):
        got = np.asarray(stats[key], np.float32)
        ref = getattr(cpu_stats, key).numpy()
        np.testing.assert_allclose(got, ref, err_msg=f"cmvn {key}",
                                   **CMVN_TOL)
    assert torch.equal(trainer.task.cmvn.mean.cpu(),
                       torch.tensor(stats["mean"]))
    rel = {k: float(np.max(np.abs(np.asarray(stats[k]) - getattr(
        cpu_stats, k).numpy()) / np.abs(getattr(cpu_stats, k).numpy())))
        for k in ("mean", "istd")}
    log(f"cmvn: build_task computed cmvn.json over {CMVN_CHIP_BATCHES} train "
        f"batches on the card ({run_s:.1f} s with 2 steps and an evaluation;"
        f" JAX's build_task reads 200); it equals the CPU's plain-fbank "
        f"statistics of the same PCM within {CMVN_TOL} (worst relative "
        f"error mean {rel['mean']:.3g}, istd {rel['istd']:.3g}); launches "
        f"{launches} ({CMVN_CHIP_BATCHES} for the statistics, 2 per step, 1 "
        f"per eval batch), {n_checked} B2 calls within check_mel (worst log "
        f"error {cmvn_worst:.3g})", card)
    out["cmvn"] = {"batches": CMVN_CHIP_BATCHES, "run_s": run_s,
                   "launches": launches, "fbank_calls_checked": n_checked,
                   "fbank_max_abs_err": cmvn_worst, "worst_rel_err": rel}
    note("cmvn", "build_task", launches, n_checked, cmvn_worst)
    del trainer, calls
    build_task.CMVN_BATCHES = 200

    # (c) accumulation: 4 micro-batches of 2 per update on the card and on
    # the CPU (dropout and the device-drawn augmentation off)
    accum = {}
    for where in ("card", "host"):
        argv = argv_of(
            EMF_CFG, f"accum_{where}", ACCUM_MICRO,
            f"trainer.accumulate_grad_batches={ACCUM}",
            "trainer.log_interval=1",
            f"encoder.config.num_layers={ACCUM_LAYERS}",
            "dataset.bucket_sampler_config.volume_threshold="
            f"{ACCUM_VOLUME}",
            f"dataset.bucket_sampler_config.min_batch_size={ACCUM_MIN_BATCH}",
            "encoder.config.dropout=0.0", "decoder.config.dropout_p=0.0",
            "dataset.data_aug_config.use_spec_aug=false",
            "dataset.data_aug_config.use_add_noise=false",
            "dataset.data_aug_config.use_mix_feats=false")
        argv += ["--max_steps", str(ACCUM_MICRO)]
        if where == "host":
            accum[where] = (build_task.main(argv + ["--device", "cpu"]),
                            None)
        else:
            trainer, _, launches, _, calls = counted_main(build_task.main,
                                                          argv)
            n, worst, _ = checked_calls(calls, "accumulation run",
                                        launches["fbank"])
            note("accumulation", "build_task", launches, n, worst)
            accum[where] = (trainer, launches)
    (tc, launches), (tcpu, _) = accum["card"], accum["host"]
    for t in (tc, tcpu):
        assert isinstance(t.optimizer, MultiSteps) and \
            t.optimizer.gradient_step == ACCUM_MICRO // ACCUM and \
            t.optimizer.optimizer.count == ACCUM_MICRO // ACCUM
    lc, lcpu = (metrics_of(t.workdir) for t in (tc, tcpu))
    for a, b in zip(lc, lcpu):
        check_close(f"accumulation loss step {a['step']}",
                    torch.tensor(a["loss"]), torch.tensor(b["loss"]),
                    STEP_LOSS_RTOL, 0.0)
    state_c = tc.optimizer.state_dict()["inner"]
    state_cpu = tcpu.optimizer.state_dict()["inner"]
    for name in ("mu", "nu"):
        for i, (a, b) in enumerate(zip(state_c[name], state_cpu[name])):
            check_close(f"accumulation {name} {i}", a, b, 0.0,
                        STEP_GRAD_TOL * float(b.abs().max()) + 1e-30)
    cpu_params = dict(tcpu.task.model.named_parameters())
    for k, p in tc.task.model.named_parameters():
        check_close(f"accumulation param {k}", p.detach().cpu(),
                    cpu_params[k].detach(), **STEP_PARAM_TOL)
    log(f"accumulation: accumulate_grad_batches={ACCUM} over {ACCUM_MICRO} "
        f"micro-batches (emformer_ctc.yaml at {ACCUM_LAYERS} layers, "
        f"{ACCUM_VOLUME} s of audio per batch, dropout "
        f"and the device-drawn augmentation off): optimizer count "
        f"{ACCUM_MICRO // ACCUM} on both, losses "
        f"{[round(r['loss'], 4) for r in lc]} within rtol {STEP_LOSS_RTOL} "
        f"of the CPU's, AdamW moments within {STEP_GRAD_TOL} of their "
        f"largest, parameters within {STEP_PARAM_TOL}; launches {launches}",
        card)
    out["accumulation"] = {"losses": [r["loss"] for r in lc],
                           "losses_cpu": [r["loss"] for r in lcpu],
                           "launches": launches}
    del accum, tc, tcpu

    wall = time.perf_counter() - t_phase

    def total(kernel, path):
        return sum(r["launches"][kernel] for r in runs[path].values())

    b1 = {path: total("attn_weights", path) for path in runs}
    b1["launches"] = sum(b1.values())
    assert b1["launches"] == 0, f"B1 launched in phase 16: {runs}"
    b2 = {path: {"launches": total("fbank", path),
                 "calls_checked": sum(r["calls_checked"]
                                      for r in runs[path].values()),
                 "max_abs_err": max(r["max_abs_err"]
                                    for r in runs[path].values()),
                 "runs": {k: r["launches"]["fbank"]
                          for k, r in runs[path].items()}}
          for path in runs}
    assert b2["wav2vec2"]["launches"] == 0, b2["wav2vec2"]
    emf = out["emformer_train"]
    evals = len(emf["eval_s"]) * emf["eval_batches"]
    b2["emformer"].update(
        launches_per_step=(emf["launches"]["fbank"] - evals) / EMF_STEPS,
        launches_per_test_batch=runs["emformer"]["inference"]["launches"][
            "fbank"] / out["emformer_decode"]["batches"])
    b2["launches"] = sum(b2[path]["launches"] for path in runs)
    worst = max(b2[path]["max_abs_err"] for path in runs)
    log(f"ctc encoders phase: {wall:.1f} s; launches B1 {b1}; B2 "
        + "; ".join(f"{path} {b2[path]['runs']}" for path in runs)
        + f"; all {b2['launches']} B2 calls within check_mel (worst log "
        f"error {worst:.3g})", card)
    out["wall_s"] = wall
    out["runs"] = runs
    report["ctc_encoders"] = out
    return {"attn_weights": b1, "fbank": b2}


# ------------------------------------------------------------ phase 17
DEPLOY_INFER = {"greedy": CFG, "beam": BEAM_CFG}
INT8_ROWS = (1, 5, 16)           # rows at or under torch._int_mm's CUDA limit
LSTM_B, LSTM_T = 16, 120         # the LSTM int8 check's encoder output
FRAME_STEPS = 50                 # frame steps timed (int8 and f32)
EXPORT_FRAMES = 2000             # module_export_config.max_frames default
EXPORT_PASSES = 5                # frontend + encoder passes traced


def held_calls(label, fn):
    """`fn()` through counted_main: its launches counted, every B1 call
    held as check_weights holds it and every B2 call as check_mel;
    returns (its result, its record: launches, calls checked and worst
    error by kernel)."""
    result, _, launches, _, calls = counted_main(lambda _: fn(), None)
    try:
        with torch.no_grad():
            b1 = [check_weights(f"{label} B1 call {i}", w, *a)
                  for i, (a, w) in enumerate(calls["attn_weights"])]
        calls["attn_weights"].clear()
    except BaseException:
        calls.close()
        raise
    assert len(b1) == launches["attn_weights"], (label, len(b1), launches)
    n2, worst2, _ = checked_calls(calls, label, launches["fbank"])
    return result, {"launches": launches,
                    "calls_checked": {"attn_weights": len(b1),
                                      "fbank": n2},
                    "max_abs_err": {"attn_weights": max(b1, default=0.0),
                                    "fbank": worst2}}


def device_busy_ms(call, iters):
    """Device time, ms, of one `call`: the summed kernel durations of
    `iters` calls in a torch.profiler trace, over `iters`."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / iters


def frame_step_timing(join, pred_step, pred_init, enc, card, what):
    """One greedy frame step at the batch of `enc` (B, D): the joiner,
    the argmax and the predictor step; device time (profiler) and host
    time (synchronised before each call), ms."""
    from speech2text_torch.tools.timing import host_ms
    B = enc.shape[0]
    state = pred_init(B, enc.device)
    pred, state = pred_step(torch.zeros(B, dtype=torch.int64,
                                        device=enc.device), state)

    def step():
        tok = torch.argmax(join(enc, pred[:, 0]), dim=-1)
        return pred_step(tok, state)

    with torch.no_grad():
        dev = device_busy_ms(step, FRAME_STEPS)
        host = host_ms(step, iters=FRAME_STEPS)
    log(f"deploy greedy frame step ({what}, B={B}): device {dev:.4f} ms, "
        f"host {host:.4f} ms", card)
    return {"device_ms": dev, "host_ms": host}


def int8_card_cpu(metric, model, cpu_model, enc, lens, what):
    """Int8 decoding of the same f32 encoder output on the card and on
    the CPU: identical tokens and counts; returns (tokens compared, the
    card's session, the CPU's session, the card's tokens, counts)."""
    from speech2text_torch.tasks.rnnt import Int8Decoding
    card = Int8Decoding(metric, model)
    cpu = Int8Decoding(metric, cpu_model)
    with torch.no_grad():
        tg, cg = card.decode(enc, lens)
        tc, cc = cpu.decode(enc.cpu(), lens.cpu())
    assert torch.equal(cg.cpu(), cc) and torch.equal(tg.cpu(), tc), \
        f"{what}: int8 tokens differ between the card and the CPU"
    return int(cc.sum()), card.session, cpu.session, tg, cg


def int_mm_card_cpu(card_sess, cpu_sess, rows, what):
    """torch._int_mm through quant.int_mm on the card against the CPU,
    exactly, for each int8 weight of the sessions' joiner and predictor
    and each row count; returns the products compared."""
    from speech2text_torch import quant
    gen = torch.Generator().manual_seed(SEED + 75)
    pairs = [(w, cw) for (w, _), (cw, _) in zip(
        [card_sess.joiner.enc, card_sess.joiner.pre, *card_sess.joiner.out],
        [cpu_sess.joiner.enc, cpu_sess.joiner.pre, *cpu_sess.joiner.out])]
    pairs.append((card_sess.predictor.out_w, cpu_sess.predictor.out_w))
    n = 0
    for w, cw in pairs:
        assert w.is_quantized, what
        for m in rows:
            a = torch.randint(-127, 128, (m, w.q.shape[0]), generator=gen,
                              dtype=torch.int8)
            got = quant.int_mm(a.cuda(), w).cpu()
            assert got.dtype == torch.int32 and torch.equal(
                got, quant.int_mm(a, cw)), \
                f"{what}: int8 product at {m} x {tuple(w.q.shape)} differs"
            n += 1
    return n


def token_agreement(ta, ca, tb, cb):
    """Utterances with identical token sequences, of all."""
    same = sum(int(x) == int(y) and torch.equal(a[:int(x)], b[:int(y)])
               for a, x, b, y in zip(ta.cpu(), ca.cpu(), tb.cpu(), cb.cpu()))
    return same, len(ca)


def write_lexicon(tmp, corpus):
    """The synthetic corpus's transcript words as a word list and a
    unigram ARPA LM over them; returns their paths."""
    from speech2text_torch.data.manifest import iter_text, load_manifest
    words = sorted({w for t in iter_text(load_manifest(
        corpus["train_data"])) for w in t.split()})
    os.makedirs(tmp, exist_ok=True)
    word_list, arpa = os.path.join(tmp, "words.txt"), \
        os.path.join(tmp, "lm.arpa")
    with open(word_list, "w") as f:
        f.write("".join(f"{w}\n" for w in words))
    grams = [f"{-1.0 - 0.01 * i:.2f} {w} -0.1"
             for i, w in enumerate(["<s>", "</s>"] + words)]
    with open(arpa, "w") as f:
        f.write(f"\\data\\\nngram 1={len(grams)}\n\n\\1-grams:\n"
                + "\n".join(grams) + "\n\n\\end\\\n")
    return word_list, arpa, len(words)


def phase_deploy(card, report, tmp, trained):
    """Phase 17: deployment on the card. (a) int8 decoding of the
    flagship (phase 10's checkpoints, greedy and beam YAMLs with
    decoding.config.int8=true) through inference's main; on seeded
    weights the int8 tokens card = CPU on the same f32 encoder output,
    the int8 product card = CPU exactly at the decode's rows and at rows
    <= 16, agreement with f32 decoding, the greedy frame step int8 and
    f32 timed; (b) conformer_rnnt.yaml's LSTM predictor (512 x 2) int8,
    greedy and beam, card = CPU with the card's transcendental functions;
    (c) ctc_lexicon_beam_search on phase
    13's CTC checkpoint (the corpus's words, a unigram ARPA LM; the
    runtime built with g++ at first use), texts card = CPU and log-probs
    within ENC_TOL; (d) the flagship's encoder, predictor, joiner
    (module_export) and frontend (build_task's frontend_save) exported,
    reloaded and run: B1 and B2 launched inside them, outputs = eager's
    within ENC_TOL, B1 and B2 device times against eager; (e) the
    model-average CLI on phase 10's checkpoints = inference's average,
    bitwise. Every run on the card is held (held_calls)."""
    from speech2text_torch import build_task, inference
    from speech2text_torch.config import load_config
    from speech2text_torch.convert import to_flax
    from speech2text_torch.export import load_exported, quantize_params
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import fbank as fb
    from speech2text_torch.runtime_binding import CtcLexiconBeamDecoding
    from speech2text_torch.tasks.ctc import CtcModel
    from speech2text_torch.tasks.rnnt import (Int8Decoding, RnntModel,
                                              decoding_of)
    from speech2text_torch.tools import model_average
    from speech2text_torch.tools.timing import kernel_durations_ms
    from speech2text_torch.train.checkpoint import average_checkpoints
    t_phase = time.perf_counter()
    out, held = {}, {}
    dtmp = os.path.join(tmp, "deploy")
    train_cfg = os.path.join(trained["workdir"], os.path.basename(TRAIN_CFG))
    corpus = trained["corpus"]

    def argv(cfg, name, *extra):
        args = ["--inference_config", cfg,
                "--override", f"task.train_config={train_cfg}",
                "--override", f"task.export_path={dtmp}/{name}",
                "--override", f"testset.test_data={corpus['eval_data']}"]
        for ov in extra:
            args += ["--override", ov]
        return args

    # (a) int8 decoding of the flagship through inference's main
    runs = {}
    for name, cfg in DEPLOY_INFER.items():
        runs[name], held[f"int8_{name}"] = held_calls(
            f"deploy int8 {name}", lambda cfg=cfg, name=name: run_inference(
                f"int8 {name}", argv(cfg, f"int8_{name}",
                                     "decoding.config.int8=true"),
                card, RUN_LAYERS))
        assert isinstance(runs[name]["task"].decode_session, Int8Decoding)
    task, dev = runs["greedy"]["task"], runs["greedy"]["device"]
    batches = device_batches(task, dev)[:CONF_CPU_BATCHES]
    seeded = RnntModel.from_config(runs["greedy"]["train_config"])
    seeded.init_weights(torch.Generator().manual_seed(SEED + 70))
    task.model.load_state_dict(seeded.state_dict())
    cpu_model = seeded.eval()
    metrics = {name: runs[name]["train_config"]["metric"]
               for name in DEPLOY_INFER}

    def seeded_checks():
        n_tok = {k: 0 for k in metrics}
        agree = {k: [0, 0] for k in metrics}
        n_mm, sessions = 0, {}
        with torch.no_grad():
            for batch in batches:
                enc, lens = task.model.encoder(*task.featurize(batch))
                enc = enc.float()
                for name, metric in metrics.items():
                    n, card_s, cpu_s, t8, c8 = int8_card_cpu(
                        metric, task.model, cpu_model, enc, lens,
                        f"deploy int8 {name}")
                    n_tok[name] += n
                    sessions[name] = card_s
                    tf, cf = decoding_of(dict(metric, int8=False),
                                         task.model, None, 0.0).decode(
                                             enc, lens)
                    same, total = token_agreement(t8, c8, tf, cf)
                    agree[name][0] += same
                    agree[name][1] += total
                    W = int(metric.get("beam_size", 1)) \
                        if name == "beam" else 1
                    rows = sorted({enc.shape[0], enc.shape[0] * W,
                                   *INT8_ROWS})
                    n_mm += int_mm_card_cpu(card_s, cpu_s, rows, name)
        return n_tok, agree, n_mm, enc, sessions["greedy"]

    (n_tok, agree, n_mm, enc, sess), held["int8_card_cpu"] = held_calls(
        "deploy int8 card/CPU", seeded_checks)
    assert all(n > 0 for n in n_tok.values()), n_tok
    log(f"deploy int8 decoding: phase 10's checkpoints through inference "
        f"(greedy WER {runs['greedy']['wer']:.4f}, beam "
        f"{runs['beam']['wer']:.4f}); on seeded weights over "
        f"{len(batches)} test batches int8 tokens identical on the card "
        f"and the CPU from the same f32 encoder output: greedy "
        f"{n_tok['greedy']}, beam {n_tok['beam']} tokens compared; "
        f"{n_mm} int8 products card = CPU exactly (rows incl. "
        f"{INT8_ROWS}); utterances with int8 tokens = f32 tokens: greedy "
        f"{agree['greedy'][0]}/{agree['greedy'][1]}, beam "
        f"{agree['beam'][0]}/{agree['beam'][1]}", card)
    frame = enc[:, 0].contiguous()
    model = task.model
    steps = {"f32": frame_step_timing(
        model.joiner_step, model.predictor_step, model.predictor.init_state,
        frame, card, "f32"),
        "int8": frame_step_timing(
            sess.joiner.step, sess.predictor.step, sess.predictor.init_state,
            frame, card, "int8")}
    out["int8"] = {"wer": {k: r["wer"] for k, r in runs.items()},
                   "launches": {k: r["launches"] for k, r in runs.items()},
                   "card_cpu_tokens": n_tok, "int_mm_compared": n_mm,
                   "int8_f32_same_utts": agree, "frame_step": steps}
    del runs, task, seeded, cpu_model, batches, sess
    torch.cuda.empty_cache()

    # (b) the LSTM predictor (conformer_rnnt.yaml, 512 x 2), int8
    cfg = load_config(RNNT_CFG)
    lstm = RnntModel.from_config(cfg)
    lstm.init_weights(torch.Generator().manual_seed(SEED + 71))
    pc = lstm.predictor.config
    assert (pc.num_lstm_layers, pc.lstm_hidden_dim) == (2, 512)
    rng = np.random.default_rng(SEED + 71)
    enc = torch.from_numpy(rng.standard_normal(
        (LSTM_B, LSTM_T, lstm.joiner.config.input_dim)).astype(
            np.float32)).cuda()
    lens = torch.from_numpy(rng.integers(LSTM_T // 3, LSTM_T + 1,
                                         LSTM_B)).cuda()
    card_model = copy.deepcopy(lstm).cuda().eval()

    def on_card(fn):
        return lambda x, *a, **kw: fn(x.cuda(), *a, **kw).cpu()

    def lstm_checks():
        """Per method: the card's int8 tokens against the CPU's (the
        utterances with equal tokens, printed), and against the CPU's
        decode with the LSTM's and the joiner's transcendental functions
        evaluated on the card, which must be identical."""
        got = {}
        for method in ("rnnt_greedy_search", "rnnt_beam_search"):
            metric = {"decode_method": method, "int8": True}
            card = Int8Decoding(metric, card_model)
            cpu = Int8Decoding(metric, lstm.eval())
            with torch.no_grad():
                tg, cg = card.decode(enc, lens)
                tc, cc = cpu.decode(enc.cpu(), lens.cpu())
                pure = token_agreement(tg, cg, tc, cc)
                pred, join = cpu.session.predictor, cpu.session.joiner
                pred.sigmoid, pred.tanh = on_card(torch.sigmoid), \
                    on_card(torch.tanh)
                join.log_softmax = on_card(torch.log_softmax)
                th, ch = cpu.decode(enc.cpu(), lens.cpu())
            assert torch.equal(cg.cpu(), ch) and torch.equal(tg.cpu(), th), \
                f"deploy lstm {method}: int8 tokens differ between the card " \
                f"and the CPU with the card's transcendental functions"
            got[method] = {"tokens": int(ch.sum()), "cpu_same_utts": pure}
        return got

    n_lstm, held["lstm"] = held_calls("deploy lstm int8", lstm_checks)
    assert all(r["tokens"] > 0 for r in n_lstm.values()), n_lstm
    g, b = n_lstm["rnnt_greedy_search"], n_lstm["rnnt_beam_search"]
    log(f"deploy int8 LSTM predictor (conformer_rnnt.yaml, "
        f"{pc.num_lstm_layers} x {pc.lstm_hidden_dim}, seeded) at "
        f"B={LSTM_B} x T={LSTM_T}: tokens identical on the card and on the "
        f"CPU with the card's sigmoid, tanh and log-softmax: greedy "
        f"{g['tokens']}, beam {b['tokens']} compared; with the CPU's own, "
        f"utterances identical: greedy {g['cpu_same_utts'][0]}/"
        f"{g['cpu_same_utts'][1]}, beam {b['cpu_same_utts'][0]}/"
        f"{b['cpu_same_utts'][1]}", card)
    out["lstm_card_cpu_tokens"] = n_lstm
    del lstm, card_model, enc
    torch.cuda.empty_cache()

    # (c) the lexicon CTC beam on phase 13's CTC checkpoint
    word_list, arpa, n_words = write_lexicon(f"{dtmp}/lexicon", corpus)
    t0 = time.perf_counter()
    run, lex_worst = conformer_inference(card, "ctc_lexicon", recipe_infer_argv(
        CTC_INFER["prefix_beam"], f"{dtmp}/lexicon_infer",
        report["conformer"]["ctc_train_config"], corpus) + [
            "--override", "decoding.type=ctc_lexicon_beam_search",
            "--override", f"decoding.config.word_list={word_list}",
            "--override", f"decoding.config.arpa_lm={arpa}"])
    lex_wall = time.perf_counter() - t0
    held["lexicon_inference"] = {
        "launches": run["launches"],
        "calls_checked": {"attn_weights": 0,
                          "fbank": run["launches"]["fbank"]},
        "max_abs_err": {"attn_weights": 0.0, "fbank": lex_worst}}
    task, dev = run["task"], run["device"]
    assert isinstance(task.decode_session, CtcLexiconBeamDecoding)
    batches = device_batches(task, dev)[:CONF_CPU_BATCHES]
    seeded = CtcModel.from_config(run["train_config"])
    seeded.init_weights(torch.Generator().manual_seed(SEED + 72))
    task.model.load_state_dict(seeded.state_dict())
    cpu_model = seeded.eval()

    def lexicon_checks():
        n, worst = 0, 0.0
        with torch.no_grad():
            for batch in batches:
                feats, lens = task.featurize(batch)
                logits, out_lens = task.model(feats, lens)
                lp = torch.log_softmax(logits, -1)
                c_logits, c_lens = cpu_model(feats.cpu(), lens.cpu())
                c_lp = torch.log_softmax(c_logits, -1)
                assert torch.equal(out_lens.cpu(), c_lens)
                worst = max(worst, check_close(
                    "deploy lexicon log-probs", lp.cpu(), c_lp, **ENC_TOL))
                got = task.decode_session.decode(lp, out_lens)
                want = task.decode_session.decode(c_lp, c_lens)
                assert got == want, "deploy lexicon: texts differ between " \
                    "the card's and the CPU's log-probs"
                n += sum(len(t.split()) for t in want)
        return n, worst

    (n_words_cmp, lp_err), held["lexicon_card_cpu"] = held_calls(
        "deploy lexicon card/CPU", lexicon_checks)
    assert n_words_cmp > 0, "deploy lexicon: no word compared"
    log(f"deploy ctc_lexicon_beam_search ({n_words} words, unigram ARPA LM,"
        f" beam 8) on phase 13's checkpoint: inference {lex_wall:.2f} s "
        f"(the g++ build of the runtime at first use included), corpus WER "
        f"{run['wer']:.4f}; on seeded weights texts identical from the "
        f"card's and the CPU's log-probs over {len(batches)} test batches: "
        f"{n_words_cmp} words compared, log-probs within {ENC_TOL} (worst "
        f"{lp_err:.3g})", card)
    out["lexicon"] = {"wer": run["wer"], "wall_s": lex_wall,
                      "words_compared": n_words_cmp,
                      "log_prob_max_abs_err": lp_err}
    del run, task, seeded, cpu_model, batches
    torch.cuda.empty_cache()

    # (d) module export and the frontend callback, reloaded on the card
    export_run, held["export_inference"] = held_calls(
        "deploy module_export", lambda: run_inference(
            "module_export", argv(CFG, "export", "task.module_export=true"),
            card, RUN_LAYERS))
    edir = f"{dtmp}/export"
    for name in ("encoder.pt2", "predictor.pt2", "joiner.pt2", "units.txt",
                 "weights.int8.npz"):
        assert os.path.getsize(os.path.join(edir, name)) > 0, name
    task = export_run["task"]
    flat = dict(np.load(os.path.join(edir, "weights.int8.npz")))
    want = quantize_params(to_flax(task.model))
    assert sorted(flat) == sorted(want) and all(
        np.array_equal(flat[k], want[k]) for k in want), \
        "weights.int8.npz is not quantize_params of the model"
    fe_args = ["--training_config", train_cfg,
               "--override", f"task.export_path={dtmp}/frontend",
               "--override", "tokenizer.apply_train=false",
               "--override", "callbacks.frontend_save=true"]
    trainer, _ = build_task.prepare(fe_args)
    trainer.close()
    fe_path = os.path.join(trainer.workdir, "frontend.pt2")
    del trainer
    programs = {k: load_exported(os.path.join(edir, f"{k}.pt2"))
                for k in ("encoder", "predictor", "joiner")}
    programs["frontend"] = load_exported(fe_path)
    eval_rows = [json.loads(x) for x in open(corpus["eval_data"])]
    from speech2text_torch.data.audio import read_wav
    wav, sr = read_wav(max(eval_rows, key=lambda r: r["duration"])[
        "audio_filepath"])
    n_max = 30 * sr
    pcm = torch.zeros((1, n_max), device="cuda")
    pcm[0, :len(wav)] = torch.from_numpy(wav).cuda()
    pcm_len = torch.tensor([len(wav)], dtype=torch.int32, device="cuda")

    def exported_pass(fe, encoder):
        feats, lens = fe(pcm, pcm_len)
        feats = feats[:, :EXPORT_FRAMES].contiguous()
        lens = torch.clamp(lens, max=EXPORT_FRAMES)
        return feats, lens, *encoder(feats, lens)

    with torch.no_grad():
        eager = exported_pass(task.frontend, task.model.encoder)
    def exported_run():
        with torch.no_grad():
            return exported_pass(programs["frontend"], programs["encoder"])

    (feats, f_lens, e_out, e_lens), held["exported"] = held_calls(
        "deploy exported frontend + encoder", exported_run)
    rec = held["exported"]["launches"]
    assert rec == {"attn_weights": RUN_LAYERS, "fbank": 1}, rec
    errs = {"frontend": check_close("deploy exported frontend", feats,
                                    eager[0], **ENC_TOL),
            "encoder": check_close("deploy exported encoder", e_out.float(),
                                   eager[2].float(), **ENC_TOL)}
    assert torch.equal(f_lens, eager[1]) and torch.equal(e_lens, eager[3])
    with torch.no_grad():
        tok = torch.tensor([7], device="cuda")
        state = task.model.predictor.init_state(1, "cuda")
        p_want = task.model.predictor_step(tok, state)
        p_got = programs["predictor"](tok, state)
        errs["predictor"] = max(check_close(
            "deploy exported predictor", g.float(), w.float(), **ENC_TOL)
            for g, w in zip((p_got[0], p_got[1]), (p_want[0], p_want[1])))
        frame = e_out[:, 3].float()
        j_want = task.model.joiner_step(frame, p_want[0][:, 0])
        errs["joiner"] = check_close(
            "deploy exported joiner", programs["joiner"](
                frame, p_want[0][:, 0]), j_want, **ENC_TOL)
    from torch.profiler import ProfilerActivity, profile
    kernel_ms, records = {}, {}
    for which, (fe, encoder) in (
            ("eager", (task.frontend, task.model.encoder)),
            ("exported", (programs["frontend"], programs["encoder"]))):
        with torch.no_grad():
            exported_pass(fe, encoder)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(EXPORT_PASSES):
                    exported_pass(fe, encoder)
                torch.cuda.synchronize()
        durs = {k.name: kernel_durations_ms(prof, k.name)
                for k in (aw.KERNEL, fb.KERNEL)}
        kernel_ms[which] = {k: sum(v) / EXPORT_PASSES
                            for k, v in durs.items()}
        records[which] = {k: len(v) for k, v in durs.items()}
    log(f"deploy export: module_export wrote encoder.pt2 (1 x "
        f"{EXPORT_FRAMES} frames), predictor.pt2, joiner.pt2, units.txt, "
        f"weights.int8.npz (= quantize_params of the model) in "
        f"{export_run['wall_s']:.1f} s with the test loop; frontend_save "
        f"wrote frontend.pt2 (B=1 x 30 s); reloaded, the frontend and "
        f"encoder launched {rec['fbank']} B2 and {rec['attn_weights']} B1, "
        f"all held; outputs against eager (worst): " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items())
        + f"; kernel device ms per pass (a trace of {EXPORT_PASSES}) eager "
        f"/ exported: B1 {kernel_ms['eager']['attn_weights']:.4f} / "
        f"{kernel_ms['exported']['attn_weights']:.4f}, B2 "
        f"{kernel_ms['eager']['fbank']:.4f} / "
        f"{kernel_ms['exported']['fbank']:.4f} (kernel records "
        f"{records})", card)
    out["export"] = {"wall_s": export_run["wall_s"], "max_abs_err": errs,
                     "kernel_ms": kernel_ms, "kernel_records": records}
    del export_run, task, programs
    torch.cuda.empty_cache()

    # (e) the model-average CLI on phase 10's checkpoints
    ckpt_dir = os.path.join(trained["workdir"], "checkpoints")
    k = int(load_config(CFG)["task"]["aver_best_k"])
    path = model_average.main(["--checkpoints_dir", ckpt_dir, "--best_k",
                               str(k), "--output", f"{dtmp}/averaged"])
    got = torch.load(path, map_location="cpu", weights_only=True)["model"]
    want = average_checkpoints(ckpt_dir, best_k=k)
    assert got.keys() == want.keys() and all(
        torch.equal(got[n], want[n]) for n in want), \
        "the averaged checkpoint differs from inference's average"
    log(f"deploy model_average: best {k} of phase 10's checkpoints -> "
        f"{path}, {len(want)} tensors bitwise equal to inference's "
        f"chkpt_aver average", card)

    wall = time.perf_counter() - t_phase
    totals = {kern: {
        "launches": sum(h["launches"][kern] for h in held.values()),
        "calls_checked": sum(h["calls_checked"][kern]
                             for h in held.values()),
        "max_abs_err": max(h["max_abs_err"][kern] for h in held.values())}
        for kern in ("attn_weights", "fbank")}
    for kern, t in totals.items():
        assert t["calls_checked"] == t["launches"], (kern, t)
    log(f"deploy phase: {wall:.1f} s; launches B1 "
        f"{totals['attn_weights']['launches']}, B2 "
        f"{totals['fbank']['launches']}, every call held (worst B1 "
        f"{totals['attn_weights']['max_abs_err']:.3g}, B2 log "
        f"{totals['fbank']['max_abs_err']:.3g}); by run: " + ", ".join(
            f"{name} {h['launches']['attn_weights']}/"
            f"{h['launches']['fbank']}" for name, h in held.items()), card)
    out.update(wall_s=wall, held_runs=held)
    report["deploy"] = out
    return {kern: dict(t, exported_launches=held["exported"]["launches"][
        kern]) for kern, t in totals.items()}


# ------------------------------------------------------------ phase 18
ONNX_FRAMES = 1000               # 10 s; JAX's max_frames default is 2000
ONNX_STREAM_CHUNKS = 3           # streaming-encoder graph calls checked
ONNX_INT8_BOUND = 0.05           # tests/test_onnx.py's int8 bound
RUNNER_OPS = frozenset((
    "Add", "Sub", "Mul", "Div", "Max", "Min", "And", "Or", "Xor", "Not",
    "Neg", "Abs", "Exp", "Log", "Sqrt", "Reciprocal", "Tanh", "Sigmoid",
    "Sign", "Sin", "Cos", "Floor", "Ceil", "Erf", "Pow", "Mod", "Greater",
    "GreaterOrEqual", "Less", "LessOrEqual", "Equal", "Where", "Clip",
    "Cast", "Identity", "Reshape", "Transpose", "Expand", "Concat", "Slice",
    "Pad", "Split", "ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd",
    "ReduceMean", "ArgMax", "ArgMin", "MatMul", "Einsum", "Gather", "Conv",
    "Softmax", "DynamicQuantizeLinear", "MatMulInteger"))
ONNX_FILES = ("encoder", "predictor", "joiner", "encoder_stream")


def tree_close(label, got, want):
    """Two state trees (dicts, lists, tensors, None): integer tensors
    equal, float ones within ENC_TOL; returns the worst float error."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (label, sorted(got))
        return max([tree_close(f"{label}.{k}", got[k], want[k])
                    for k in want], default=0.0)
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), label
        return max([tree_close(f"{label}[{i}]", g, w)
                    for i, (g, w) in enumerate(zip(got, want))],
                   default=0.0)
    if want is None:
        assert got is None, label
        return 0.0
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (label, got.dtype, want.dtype, got.shape, want.shape)
    if not want.is_floating_point():
        assert torch.equal(got, want), f"{label}: integers differ"
        return 0.0
    return check_close(label, got.float(), want.float(), **ENC_TOL)


def program_chunks(sess, prime, step, pcm, timed=False):
    """The reloaded programs over (B, prime + k·step) PCM from the
    session's program state → (each chunk's state, per-chunk wall ms when
    `timed`: each chunk ends with a synchronise)."""
    pcm = torch.from_numpy(pcm).cuda()
    state = sess.program_state(batch_size=pcm.shape[0])
    states, lat = [], []
    offs = [0] + list(range(sess.prime_samples, pcm.shape[1],
                            sess.step_samples))
    with torch.no_grad():
        for i, off in enumerate(offs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                state = prime(pcm[:, :sess.prime_samples], state)
            else:
                state = step(pcm[:, off:off + sess.step_samples], state)
            if timed:
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            states.append(state)
    return states, lat


def eager_chunks(sess, pcm, timed=False):
    """The eager session over the same chunks → (each chunk's state in the
    programs' layout, per-chunk wall ms when `timed`)."""
    states, lat = [], []
    state = sess.init_state(pcm.shape[0])
    offs = [0] + list(range(sess.prime_samples, pcm.shape[1],
                            sess.step_samples))
    for i, off in enumerate(offs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            state = sess.prime(pcm[:, :sess.prime_samples], state)
        else:
            state = sess.step(pcm[:, off:off + sess.step_samples], state)
        if timed:
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        states.append(sess.program_state(state))
    return states, lat


def programs_vs_eager(label, sess, programs, pcm):
    """The reloaded programs held (held_calls: 0 B1 and 1 B2 launch per
    chunk, every B2 call against the plain version) and compared with the
    eager session chunk by chunk: tokens and counts equal, every state
    tensor within ENC_TOL. Returns (tokens compared, chunks, worst state
    error, the held record)."""
    (states, _), rec = held_calls(label, lambda: program_chunks(
        sess, programs["prime"], programs["step"], pcm))
    n = len(states)
    assert rec["launches"] == {"attn_weights": 0, "fbank": n}, \
        f"{label}: launches {rec['launches']} for {n} chunks"
    want, _ = eager_chunks(sess, pcm)
    worst = max(tree_close(f"{label} chunk {i}", g, w)
                for i, (g, w) in enumerate(zip(states, want)))
    return int(states[-1]["counts"].sum()), n, worst, rec


def int8_keeping(data, keep_rows):
    """quantize_dynamic(data, ("MatMul",)) with the MatMuls whose 2-D
    weight has `keep_rows` rows left f32 (their weight reaches them
    through a Reshape, which the rewrite does not follow)."""
    from speech2text_torch.onnx import proto, quantize_dynamic
    g = proto.parse_model(data).graph
    inits, nodes, kept = dict(g.initializers), [], 0
    for n in g.nodes:
        w = inits.get(n.inputs[1]) if n.op_type == "MatMul" else None
        if w is not None and w.ndim == 2 and w.shape[0] == keep_rows:
            name = n.inputs[1]
            inits[name + "_3d"] = w[None]
            inits[name + "_shape"] = np.asarray(w.shape, np.int64)
            nodes.append(proto.node_proto(
                "Reshape", [name + "_3d", name + "_shape"], [name + "_2d"]))
            nodes.append(proto.node_proto("MatMul", [n.inputs[0],
                                                     name + "_2d"],
                                          n.outputs))
            kept += 1
        else:
            nodes.append(proto.node_proto(n.op_type, n.inputs, n.outputs,
                                          name=n.name,
                                          attrs=n.attrs or None))
    assert kept, f"no MatMul weight with {keep_rows} rows"

    def info(entries):
        return [proto.value_info_proto(*e) for e in entries]
    graph = proto.graph_proto(g.name, nodes, [
        proto.tensor_proto(k, v) for k, v in inits.items()],
        info(g.inputs), info(g.outputs))
    return quantize_dynamic(proto.model_proto(graph), ("MatMul",)), kept


def onnx_runner_checks(task, edir, card):
    """Each graph of `edir` in the port's numpy runner on the host against
    the card's eager f32 model (export.f32_model, TF32 off) on the same
    inputs, within ENC_TOL (the streaming encoder over
    ONNX_STREAM_CHUNKS chunks, its states fed back); each *_int8 graph
    within ONNX_INT8_BOUND of its f32 graph's output magnitude, the
    streaming graph on each chunk from the f32 graph's carried state but
    its first call from the zero state, whose error is recorded; no graph
    holds a node outside the runners' op set (no custom-op node)."""
    from speech2text_torch.export import f32_model
    from speech2text_torch.onnx import OnnxRunner, proto
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = f32_model(task).cuda()
    graphs = {}
    for name in ONNX_FILES:
        for key in (name, f"{name}_int8"):
            with open(os.path.join(edir, f"{key}.onnx"), "rb") as f:
                graphs[key] = f.read()
            ops = {n.op_type for n in proto.parse_model(
                graphs[key]).graph.nodes}
            assert ops <= RUNNER_OPS, f"{key}: nodes {ops - RUNNER_OPS}"
    # real features: the first test batch's first row, padded or cut to
    # ONNX_FRAMES frames
    batch = device_batches(task, "cuda")[0]
    with torch.no_grad():
        feats, lens = task.featurize(batch)
    T = min(int(lens[0]), ONNX_FRAMES)
    x = torch.zeros((1, ONNX_FRAMES, feats.shape[-1]), device="cuda")
    x[0, :T] = feats[0, :T].float()
    x_len = torch.tensor([T], dtype=torch.int32, device="cuda")
    d = model.joiner.config.input_dim
    runner_s, err, int8_err = {}, {}, {}

    def run(key, *args):
        t0 = time.perf_counter()
        got = OnnxRunner(graphs[key])(*[a.cpu().numpy() for a in args])
        runner_s[key] = runner_s.get(key, 0.0) + time.perf_counter() - t0
        return [torch.from_numpy(np.asarray(g)) for g in got]

    with torch.no_grad():
        cases = {}
        enc, enc_lens = model.encoder(x, x_len)
        cases["encoder"] = ((x, x_len), (enc, enc_lens))
        tok = torch.tensor([7], dtype=torch.int32, device="cuda")
        state = model.predictor.init_state(1, "cuda").to(torch.int32)
        pred, new_state = model.predictor.streaming_step(tok, state)
        cases["predictor"] = ((tok, state), (pred, new_state))
        frame, p_frame = enc[:, T // 8], pred[:, 0]
        cases["joiner"] = ((frame, p_frame),
                           (model.joiner.streaming_step(frame, p_frame),))
        for name, (args, want) in cases.items():
            got = run(name, *args)
            assert len(got) == len(want), name
            err[name] = max(tree_close(f"onnx {name}", g, w.cpu())
                            for g, w in zip(got, want))
        with open(os.path.join(edir, "encoder_stream_spec.json")) as f:
            spec = json.load(f)
        chunk, left = spec["chunk_size"], spec["left_context_chunks"]
        st = model.encoder.init_streaming_state(1, chunk, left, "cuda")
        leaves = [torch.zeros(s["shape"], dtype=getattr(torch, s["dtype"]))
                  for s in spec["state"]]
        step = spec["feats_per_step"]
        stream_err = 0.0
        chunk_args = []
        for i in range(ONNX_STREAM_CHUNKS):
            fc = x[:, i * step:(i + 1) * step]
            want, st = model.encoder.streaming_step(fc, st)
            chunk_args.append((fc, *leaves))
            got = run("encoder_stream", fc, *leaves)
            leaves = got[1:]
            stream_err = max(stream_err, tree_close(
                f"onnx encoder_stream chunk {i}", got[0], want.cpu()))
        err["encoder_stream"] = stream_err
        bounds = {}
        for name, args in [(k, a) for k, (a, _) in cases.items()] + [
                (f"encoder_stream chunk {i}", a)
                for i, a in enumerate(chunk_args)]:
            graph = name.split()[0]
            fp = run(graph, *args)[0]
            q = run(f"{graph}_int8", *args)[0]
            bounds[name] = ONNX_INT8_BOUND * max(float(fp.abs().max()), 1e-3)
            int8_err[name] = float((q - fp).abs().max())
        # the streaming graph's first call, from the zero state, is held
        # apart: its error is the frontend projection's (PERF.md),
        # so with that one MatMul (F2·C → D) left f32 it is in the bound
        first = "encoder_stream chunk 0"
        for name, e in int8_err.items():
            assert name == first or e < bounds[name], \
                f"onnx {name} int8: {e:.4g} >= {bounds[name]:.4g}"
        embed = model.encoder.embed
        rows = embed.freq_dim(embed.feature_dim) * embed.mid_channels
        graphs["encoder_stream_int8_keep"], kept = int8_keeping(
            graphs["encoder_stream"], rows)
        fp = run("encoder_stream", *chunk_args[0])[0]
        q = run("encoder_stream_int8_keep", *chunk_args[0])[0]
        keep = f"{first}, {kept} MatMul of {rows} rows f32"
        int8_err[keep] = float((q - fp).abs().max())
        bounds[keep] = bounds[first]
        assert int8_err[keep] < bounds[keep], \
            f"onnx {keep}: {int8_err[keep]:.4g} >= {bounds[keep]:.4g}"
    log("export onnx runner (numpy, host) against the card's f32 eager "
        f"model (TF32 off), within {ENC_TOL}, worst: " + ", ".join(
            f"{k} {v:.3g}" for k, v in err.items()) + f" (the streaming "
        f"encoder over {ONNX_STREAM_CHUNKS} chunks of {step} frames, its "
        f"states fed back); int8 graphs against the f32 graphs, max abs "
        f"err / bound ({ONNX_INT8_BOUND} x magnitude): " + ", ".join(
            f"{k} {v:.3g} / {bounds[k]:.3g}" for k, v in int8_err.items())
        + f" ({first} held apart); runner s: " + ", ".join(
            f"{k} {v:.2f}" for k, v in runner_s.items()), card)
    del model
    return {"max_abs_err": err, "int8_max_abs_err": int8_err,
            "int8_bound": bounds, "runner_s": runner_s,
            "bytes": {k: len(v) for k, v in graphs.items()}}


def phase_export(card, report, tmp, trained):
    """Phase 18: the streaming-session export and the ONNX export on the
    card. (a) stream_demo --export_dir on phase 10's checkpoints (the
    flagship YAML, bf16, chunk 32, STREAM_LEFT left chunks, B=1): the
    reloaded stream_prime.pt2 / stream_step.pt2 over phase 12's eval PCM
    (a prime and STREAM_TIMED_CHUNKS steps) held to the eager session on
    the card chunk by chunk (tokens equal, state tensors within ENC_TOL),
    0 B1 and 1 B2 launch per chunk with every B2 call held to the plain
    version; the same with phase 12's seeded weights loaded into the
    programs and the session, where the tokens compared must be > 0; the
    reloaded step timed against the eager step (steady p50 at B=1, in
    turns: eager, programs, programs, eager). (b) inference.main on phase 10's checkpoints with the
    flagship greedy YAML and task.onnx_export: JAX's nine artifacts and
    encoder_stream_spec.json written, the report as before; every graph
    run in the port's numpy runner on the host against the card's eager
    f32 model (onnx_runner_checks); export and runner seconds recorded.
    Every run on the card is held (held_calls)."""
    from speech2text_torch import inference
    from speech2text_torch.data.manifest import load_manifest
    from speech2text_torch.export import load_exported
    from speech2text_torch.tools import stream_demo
    t_phase = time.perf_counter()
    out, held = {}, {}
    xdir = os.path.join(tmp, "export18")
    train_cfg = os.path.join(trained["workdir"], os.path.basename(TRAIN_CFG))
    corpus = trained["corpus"]

    # (a) the demo exports, then streams, on phase 10's checkpoints
    wav = max(load_manifest(corpus["eval_data"]),
              key=lambda e: e["duration"])["audio_filepath"]
    t0 = time.perf_counter()
    demo, held["demo_export"] = held_calls("export stream demo", lambda: (
        stream_demo.main([
            "--train_config", train_cfg, "--wav", wav,
            "--checkpoints_dir", os.path.join(trained["workdir"],
                                              "checkpoints"),
            "--chunk_size", "32", "--left_chunks", str(STREAM_LEFT),
            "--export_dir", f"{xdir}/stream"])))
    demo_s = time.perf_counter() - t0
    (res,) = demo["results"]
    n_demo = len(res["latency_ms"])
    # one B2 launch more than the demo's chunks: the export runs the prime
    # once eagerly for the step program's example state
    assert held["demo_export"]["launches"] == {
        "attn_weights": 0, "fbank": n_demo + 1}, held["demo_export"]
    sess = demo["session"]
    assert sess.task.model.encoder.config.dtype == "bfloat16"
    programs = {k: load_exported(demo["exported"][k])
                for k in ("prime", "step")}
    pcm = stream_audio(corpus, 1, sess.prime_samples
                       + STREAM_TIMED_CHUNKS * sess.step_samples)
    n_tok, n_chunks, worst, held["programs_trained"] = programs_vs_eager(
        "export programs (trained, bf16)", sess, programs, pcm)
    turns = []
    for which in ("eager", "programs", "programs", "eager"):
        if which == "eager":
            _, lat = eager_chunks(sess, pcm, timed=True)
        else:
            with torch.no_grad():
                _, lat = program_chunks(sess, programs["prime"],
                                        programs["step"], pcm, timed=True)
        turns.append((which, float(np.percentile(lat[1:], 50))))
    log(f"export stream demo --export_dir (phase 10's checkpoints, bf16, "
        f"chunk 32, {STREAM_LEFT} left chunks, B=1) on "
        f"{os.path.basename(wav)}: {demo_s:.1f} s with {n_demo} chunks "
        f"streamed, stream_prime.pt2 "
        f"{os.path.getsize(demo['exported']['prime']) / 2**20:.1f} MiB, "
        f"stream_step.pt2 "
        f"{os.path.getsize(demo['exported']['step']) / 2**20:.1f} MiB; "
        f"reloaded over {n_chunks} chunks: launches "
        f"{held['programs_trained']['launches']}, every B2 call held "
        f"(worst log {held['programs_trained']['max_abs_err']['fbank']:.3g})"
        f", {n_tok} tokens equal to the eager session's, states within "
        f"{ENC_TOL} (worst {worst:.3g}); steady step p50 ms in turns: "
        + ", ".join(f"{w} {v:.3f}" for w, v in turns), card)
    out["stream_trained"] = {
        "demo_s": demo_s, "demo_chunks": n_demo, "chunks": n_chunks,
        "tokens": n_tok, "state_max_abs_err": worst,
        "step_p50_ms_turns": turns,
        "bytes": {k: os.path.getsize(v)
                  for k, v in demo["exported"].items()}}

    # the token check on phase 12's seeded weights (20 training steps
    # emit almost nothing), loaded into the demo's programs and session
    task16, _, _ = stream_tasks(trained)
    seeded = task16.model.state_dict()
    sess.task.model.load_state_dict(seeded)
    for prog in programs.values():
        state = {f"task.model.{k}": v for k, v in seeded.items()}
        missing = sorted(set(prog.state_dict()) - set(state))
        assert not missing, f"program weights not reloaded: {missing[:3]}"
        prog.load_state_dict(state, strict=False)
    del task16, seeded, state
    n_tok, n_chunks, worst, held["programs_seeded"] = programs_vs_eager(
        "export programs (seeded, bf16)", sess, programs, pcm)
    assert n_tok > 0, "the programs emitted no token on seeded weights"
    log(f"export programs with phase 12's seeded weights loaded (bf16, "
        f"chunk 32, B=1): over {n_chunks} chunks launches "
        f"{held['programs_seeded']['launches']}, {n_tok} tokens equal to "
        f"the eager session's, states within {ENC_TOL} (worst "
        f"{worst:.3g})", card)
    out["stream_seeded"] = {"chunks": n_chunks, "tokens": n_tok,
                            "state_max_abs_err": worst}
    del demo, sess, programs
    torch.cuda.empty_cache()

    # (b) the ONNX export through inference's main
    timer = {}
    export_onnx = inference.export_onnx_modules

    def timed_export(*args, **kwargs):
        t0 = time.perf_counter()
        result = export_onnx(*args, **kwargs)
        timer["export_s"] = time.perf_counter() - t0
        return result

    inference.export_onnx_modules = timed_export
    try:
        run, held["onnx_inference"] = held_calls(
            "export onnx inference", lambda: run_inference(
                "onnx_export", [
                    "--inference_config", CFG,
                    "--override", f"task.train_config={train_cfg}",
                    "--override", f"task.export_path={xdir}/onnx",
                    "--override", f"testset.test_data={corpus['eval_data']}",
                    "--override", "task.onnx_export=true",
                    "--override", "onnx_export_config.onnx_encoder_config."
                    f"max_frames={ONNX_FRAMES}"], card, RUN_LAYERS))
    finally:
        inference.export_onnx_modules = export_onnx
    edir = f"{xdir}/onnx"
    written = sorted(os.listdir(edir))
    for name in ("units.txt", "encoder_stream_spec.json") + tuple(
            f"{g}{s}.onnx" for g in ONNX_FILES for s in ("", "_int8")):
        assert name in written and \
            os.path.getsize(os.path.join(edir, name)) > 0, name
    checks = onnx_runner_checks(run["task"], edir, card)
    log(f"export onnx: inference.main with task.onnx_export "
        f"{run['wall_s']:.1f} s ({timer['export_s']:.1f} s of it the export "
        f"of the 8 graphs at max_frames {ONNX_FRAMES}), corpus WER "
        f"{run['wer']:.4f}; sizes MiB: " + ", ".join(
            f"{k} {v / 2**20:.1f}" for k, v in checks["bytes"].items()),
        card)
    out["onnx"] = dict(checks, export_s=timer["export_s"],
                       inference_s=run["wall_s"], max_frames=ONNX_FRAMES,
                       custom_op_nodes=0)
    del run
    torch.cuda.empty_cache()

    wall = time.perf_counter() - t_phase
    totals = {kern: {
        "launches": sum(h["launches"][kern] for h in held.values()),
        "calls_checked": sum(h["calls_checked"][kern]
                             for h in held.values()),
        "max_abs_err": max(h["max_abs_err"][kern] for h in held.values())}
        for kern in ("attn_weights", "fbank")}
    for kern, t in totals.items():
        assert t["calls_checked"] == t["launches"], (kern, t)
    progs = ("programs_trained", "programs_seeded")
    chunks = out["stream_trained"]["chunks"] + out["stream_seeded"]["chunks"]
    log(f"export phase: {wall:.1f} s; launches B1 "
        f"{totals['attn_weights']['launches']}, B2 "
        f"{totals['fbank']['launches']}, every call held (worst B1 "
        f"{totals['attn_weights']['max_abs_err']:.3g}, B2 log "
        f"{totals['fbank']['max_abs_err']:.3g}); by run: " + ", ".join(
            f"{name} {h['launches']['attn_weights']}/"
            f"{h['launches']['fbank']}" for name, h in held.items()), card)
    out.update(wall_s=wall, held_runs=held)
    report["export"] = out
    return {kern: dict(t, program_launches=sum(
        held[p]["launches"][kern] for p in progs),
        program_launches_per_chunk=sum(
            held[p]["launches"][kern] for p in progs) / chunks,
        onnx_custom_op_nodes=0)
        for kern, t in totals.items()}


def metrics_of(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# ------------------------------------------------------------ compare
def load_earlier(pkg_dir):
    """The kernel wrapper modules (ops.attn_weights, ops.fbank) of the
    speech2text_torch package at `pkg_dir`, imported as the package
    `earlier_speech2text_torch` (registered in sys.modules, as its modules'
    relative imports require)."""
    name = "earlier_speech2text_torch"
    pkg_dir = os.path.abspath(pkg_dir)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(name + ".ops.attn_weights"),
            importlib.import_module(name + ".ops.fbank"))


def in_turns(earlier, this, name):
    """Device times of two calls in turns: earlier, this, this, earlier."""
    from speech2text_torch.tools.timing import device_ms
    t = [device_ms(f, name) for f in (earlier, this, this, earlier)]
    return {"prev_ms": [t[0], t[3]], "this_ms": [t[1], t[2]]}


# ------------------------------------------------------------ phase 19
PAR_STEPS = 6               # steps of each phase-19 training run
PAR_TIMED_STEPS = 3         # steps timed per rank after a run (no holding)
# bucket volume: every bucket's batch at min_batch_size (16), so a world
# of 1 and of 2 (batches rounded up to even) see the same global batches
PAR_VOLUME = 32.0
PAR_BUCKETS = 2             # 3 eval batches of 16 for phase 10's 32
PAR_JOB_TIMEOUT = 600
# 2 gloo ranks against one process, bf16 on other per-rank batch shapes
# (B=8 for 16): each step's loss and grad_norm. The first H100 run that
# compared them read 1.69e-4 and 2.53e-3 over 6 steps
PAR_LOSS_RTOL = 2e-3
PAR_GRAD_RTOL = 1e-2
# world 1 against one process: the same arithmetic, bitwise under
# deterministic algorithms but for FSDP's grad_norm, which sums the squares
# of its sharded and its whole gradients apart (1.09e-7 on an H100)
PAR_SAME_RTOL = 1e-6
COMM_MARKS = ("nccl", "gloo", "all_reduce", "allreduce", "all_gather",
              "allgather", "reduce_scatter", "broadcast")


class HeldCalls:
    """While open, every B1 and B2 launch is held against its plain
    version as it returns: B1 as check_weights holds it, B2 as check_mel;
    `held` counts them and `worst` keeps the largest errors (B1 absolute,
    B2 log-domain). `close` puts the wrappers back."""

    def __init__(self, label):
        from speech2text_torch.ops import attn_weights as aw
        from speech2text_torch.ops import fbank as fb
        self.label = label
        self.held = {"attn_weights": 0, "fbank": 0}
        self.worst = {"attn_weights": 0.0, "fbank": 0.0}
        self._wrapped = ((aw, "attn_weights_cuda", aw.attn_weights_cuda),
                         (fb, "fbank_cuda", fb.fbank_cuda))
        aw.attn_weights_cuda = self._hold_b1(aw.attn_weights_cuda)
        fb.fbank_cuda = self._hold_b2(fb.fbank_cuda, fb.fbank_plain)

    def _hold_b1(self, fn):
        def wrapped(*args):
            out = fn(*args)
            n = self.held["attn_weights"]
            with torch.no_grad():
                err = check_weights(f"{self.label} B1 call {n}",
                                    out.detach(), *args)
            self.held["attn_weights"] = n + 1
            self.worst["attn_weights"] = max(self.worst["attn_weights"], err)
            return out
        return wrapped

    def _hold_b2(self, fn, plain):
        def wrapped(*args):
            out = fn(*args)
            n = self.held["fbank"]
            with torch.no_grad():
                want = plain(*args)
                check_mel(f"{self.label} B2 call {n}", out, want)
                err = float((out - want).abs().max())
            self.held["fbank"] = n + 1
            self.worst["fbank"] = max(self.worst["fbank"], err)
            return out
        return wrapped

    def close(self):
        for mod, attr, fn in self._wrapped:
            setattr(mod, attr, fn)


def held_main(label, fn, argv):
    """`fn(argv)` (build_task's or inference's main) with the kernel
    counts set to 0 just before it and read just after, every launch held
    (HeldCalls); returns (its result, its record)."""
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import fbank as fb
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = HeldCalls(label)
    aw.KERNEL.launches = fb.KERNEL.launches = 0
    t0 = time.perf_counter()
    try:
        result = fn(argv)
        torch.cuda.synchronize()
    finally:
        held.close()
    launches = {"attn_weights": aw.KERNEL.launches,
                "fbank": fb.KERNEL.launches}
    assert held.held == launches, \
        f"{label}: {held.held} calls held of {launches} launched"
    return result, {"launches": launches, "calls_held": held.held,
                    "max_abs_err": held.worst,
                    "wall_s": time.perf_counter() - t0,
                    "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def par_train_argv(tmp, corpus, name, *overrides):
    """build_task's argv for phase 19: the flagship YAML on phase 10's
    corpus, augmentation and dropout off, PAR_BUCKETS buckets of 16
    utterances, a metrics line every step, PAR_STEPS steps (one
    evaluation and checkpoint, at the last)."""
    argv = ["--training_config", TRAIN_CFG, "--max_steps", str(PAR_STEPS)]
    for ov in (f"task.export_path={tmp}/tasks", f"task.name={name}",
               f"dataset.base_dir={tmp}/corpus",
               f"dataset.bucket_sampler_config.volume_threshold={PAR_VOLUME}",
               f"dataset.bucket_sampler_config.num_bucket={PAR_BUCKETS}",
               "dataset.data_aug_config.use_speed_perturb=false",
               "dataset.data_aug_config.use_spec_aug=false",
               "dataset.data_aug_config.use_add_noise=false",
               "dataset.data_aug_config.use_mix_feats=false",
               "encoder.config.dropout=0.0",
               "encoder.config.feature_mask_dropout_prob=0.0",
               "trainer.log_interval=1") + overrides:
        argv += ["--override", ov]
    for key, path in corpus.items():
        argv += ["--override", f"dataset.{key}={path}"]
    return argv


def par_timed_steps(trainer, gate):
    """Once the file `gate` exists (the card free of the phase's other
    work), PAR_TIMED_STEPS steps of `trainer` on its rank's slice of the
    first global batch after a warm-up step, each synchronised (ms per
    step and peak memory), then one step under torch.profiler (host
    activity: the gloo collectives run on the host): its wall ms and the
    host time of each collective op (c10d's and the backend's)."""
    from torch.profiler import ProfilerActivity, profile
    from speech2text_torch import parallel
    t0 = time.perf_counter()
    while not os.path.exists(gate):
        assert time.perf_counter() - t0 < PAR_JOB_TIMEOUT, f"no {gate}"
        time.sleep(0.2)
    pipe = trainer.task.make_train_pipeline(
        parallel.rank(), parallel.world_size(), seed=trainer.seed,
        pin_memory=True)
    it = iter(pipe)
    batch = trainer.to_device(next(it))
    it.close()
    trainer.train_step(batch, 1000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(PAR_TIMED_STEPS):
        t0 = time.perf_counter()
        trainer.train_step(batch, 1001 + i)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch, 1100)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    comm = {}
    for name, _, dur in raw_events(prof):
        if any(m in name.lower() for m in COMM_MARKS):
            rec = comm.setdefault(name, {"count": 0, "host_ms": 0.0})
            rec["count"] += 1
            rec["host_ms"] += dur
    return {"B": int(batch["pcm"].shape[0]), "N": int(batch["pcm"].shape[1]),
            "ms_per_step": ms, "peak_memory_bytes": peak,
            "profiled_wall_ms": wall, "comm": comm}


def par_runs(runs):
    """The runs in turn in this process (build_task's or inference's
    main, each held by held_main; a training run with a `timing_gate`
    timed after it), under deterministic algorithms; returns their
    records and the first lines of the warnings of ops that have no
    deterministic version."""
    import warnings
    from speech2text_torch import build_task, inference, parallel
    records = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for run in runs:
            label = f"{run['name']} rank {parallel.rank()}"
            fn = build_task.main if run["kind"] == "train" \
                else inference.main
            result, rec = held_main(label, fn, run["argv"])
            rec.update(rank=parallel.rank(), world=parallel.world_size())
            if run["kind"] == "train":
                rec["fsdp"] = sum(parallel.is_sharded(p)
                                  for p in result.model.parameters())
                rec["last_eval"] = result.last_eval
                # host clock between step ends past the first (held)
                hist = result.history
                rec["held_ms_per_step"] = [
                    1e3 * (b["end"] - a["end"])
                    for a, b in zip(hist, hist[1:]) if a["eval_s"] == 0.0]
                if "timing_gate" in run:
                    rec["timed"] = par_timed_steps(result, run["timing_gate"])
            else:
                rec.update(wer=result["wer"], num_utts=result["num_utts"],
                           batches=result["batches"],
                           report=result["report"])
            records[run["name"]] = rec
            del result
            torch.cuda.empty_cache()
    records["nondeterministic"] = sorted({
        str(w.message).split("\n")[0] for w in caught
        if "deterministic" in str(w.message)})
    return records


def deterministic(on):
    """Deterministic algorithms on (warning where an op has none) or
    back off; returns nothing."""
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(on, warn_only=True)


def par_rank_main(spec_path):
    """Phase 19's side in one torchrun rank: TF32 off, deterministic
    algorithms, the spec's runs (par_runs); the records go to
    <out>/rank<r>.json."""
    from speech2text_torch import parallel
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    deterministic(True)
    records = par_runs(spec["runs"])
    with open(os.path.join(spec["out"], f"rank{parallel.rank()}.json"),
              "w") as f:
        json.dump(records, f, default=str)
    parallel.shutdown()
    return 0


def start_ranks(label, nproc, backend, runs, out):
    """The runs in `nproc` torchrun ranks of this script over `backend`,
    started; finish_ranks waits for them."""
    os.makedirs(out, exist_ok=True)
    spec = os.path.join(out, "spec.json")
    with open(spec, "w") as f:
        json.dump({"runs": runs, "out": out}, f)
    env = dict(os.environ, S2T_DIST_BACKEND=backend)
    os.makedirs("chiprun_out", exist_ok=True)
    logfile = open(os.path.join("chiprun_out", f"parallel_{label}.log"),
                   "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), os.path.abspath(__file__),
         "--parallel-rank", spec],
        env=env, stdout=logfile, stderr=subprocess.STDOUT, text=True)
    return {"label": label, "nproc": nproc, "backend": backend,
            "runs": runs, "out": out, "proc": proc, "log": logfile,
            "t0": time.perf_counter()}


def finish_ranks(job, card):
    """Wait for a job of start_ranks; returns each rank's records and
    the job's wall seconds (its output: chiprun_out/parallel_<label>
    .log)."""
    proc = job["proc"]
    try:
        rc = proc.wait(timeout=max(PAR_JOB_TIMEOUT - (time.perf_counter()
                                                     - job["t0"]), 1))
    finally:
        job["log"].close()
    wall = time.perf_counter() - job["t0"]
    if rc != 0:
        with open(job["log"].name) as f:
            print(f.read()[-12000:], file=sys.stderr)
        raise AssertionError(f"parallel {job['label']}: exit {rc}")
    ranks = []
    for r in range(job["nproc"]):
        with open(os.path.join(job["out"], f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    walls = [(run["name"], round(ranks[0][run["name"]]["wall_s"], 1))
             for run in job["runs"]]
    log(f"parallel {job['label']}: {job['nproc']} rank(s) over "
        f"{job['backend']}, {wall:.1f} s (start-up included), runs (name, "
        f"s) {walls}; ops with no deterministic version: "
        f"{ranks[0]['nondeterministic'] or 'none'}", card)
    return ranks, wall


def par_state(workdir):
    from speech2text_torch.train.checkpoint import CheckpointManager
    return CheckpointManager(os.path.join(workdir, "checkpoints")).restore(
        PAR_STEPS)


def par_param_diff(got, want):
    """(bitwise equal, the largest difference relative to each tensor's
    largest entry, over tensors above 1e-6, and its tensor)."""
    same = all(torch.equal(got[k], v) for k, v in want.items())
    worst = max((float((got[k].float() - v.float()).abs().max()
                       / v.float().abs().max()), k)
                for k, v in want.items() if float(v.float().abs().max())
                > 1e-6)
    return same, worst[0], worst[1]


def phase_parallel(card, report, tmp, trained):
    """Phase 19: data parallelism and FSDP through torchrun ranks of
    build_task and inference on phase 10's corpus and flagship YAML: (a)
    world 1 over NCCL with DDP and (b) with FSDP against the same steps in
    one process; (c) 2 ranks on the card over gloo against it, step by
    step; (d) inference of seeded f32 weights over 2 gloo ranks, its
    report against one process's. Every B1 and B2 launch of every rank is
    counted and held to its plain version. Every process of the phase
    runs deterministic algorithms (par_rank_main): the one-process
    reference is a process of its own, as each rank is."""
    from speech2text_torch.config import dumps, load_config
    from speech2text_torch.tasks.rnnt import RnntModel
    from speech2text_torch.train.checkpoint import CheckpointManager
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()          # the card is shared with the ranks
    corpus = trained["corpus"]
    root = os.path.join(tmp, "par")
    os.makedirs(root, exist_ok=True)
    # an f32 copy of phase 10's resolved config and seeded f32 weights
    cfg = load_config(os.path.join(trained["workdir"],
                                   os.path.basename(TRAIN_CFG)))
    for section in ("encoder", "predictor", "joiner"):
        sec = cfg[section].get("config", cfg[section])
        sec["dtype"] = "float32"
    f32_yaml = os.path.join(root, "train_f32.yaml")
    with open(f32_yaml, "w") as f:
        f.write(dumps(cfg))
    model = RnntModel.from_config(cfg)
    model.init_weights(torch.Generator().manual_seed(SEED + 19))
    CheckpointManager(os.path.join(root, "ckpt_f32")).save(
        1, {"model": model.state_dict()}, {"wer": 0.5})
    del model

    def infer_argv(name):
        return ["--inference_config", CFG,
                "--override", f"task.train_config={f32_yaml}",
                "--override", f"task.export_path={root}/infer/{name}",
                "--override", f"task.checkpoints_dir={root}/ckpt_f32",
                "--override", "task.chkpt_aver=false",
                "--override", f"testset.test_data={corpus['eval_data']}"]

    # both jobs run beside the one-process reference; the 2-rank job's
    # timed steps wait for `gate`, written when the rest is done
    gate = os.path.join(root, "timing_gate")
    jobs = [start_ranks("world2", 2, "gloo", [
        {"name": "ddp2", "kind": "train", "timing_gate": gate,
         "argv": par_train_argv(root, corpus, "ddp2")},
        {"name": "infer2", "kind": "infer", "argv": infer_argv("ranks")}],
        os.path.join(root, "w2"))]
    jobs.append(start_ranks("world1", 1, "nccl", [
        {"name": "ddp1", "kind": "train",
         "argv": par_train_argv(root, corpus, "ddp1")},
        {"name": "fsdp1", "kind": "train",
         "argv": par_train_argv(root, corpus, "fsdp1", "trainer.fsdp=true")}],
        os.path.join(root, "w1")))
    try:
        t0 = time.perf_counter()
        deterministic(True)         # as the ranks run (TF32 is off here)
        try:
            one = [par_runs([
                {"name": "one", "kind": "train",
                 "argv": par_train_argv(root, corpus, "one")},
                {"name": "infer1", "kind": "infer",
                 "argv": infer_argv("one")}])]
        finally:
            deterministic(False)
        one_s = time.perf_counter() - t0
        log(f"parallel one process: {one_s:.1f} s; ops with no "
            f"deterministic version: {one[0]['nondeterministic'] or 'none'}",
            card)
        w1, w1_s = finish_ranks(jobs[1], card)
        with open(gate, "w"):
            pass
        w2, w2_s = finish_ranks(jobs[0], card)
    finally:
        for job in jobs:
            if job["proc"].poll() is None:
                job["proc"].kill()
                job["proc"].wait()
    ref_dir = os.path.join(root, "tasks", "one")
    ref_lines = metrics_of(ref_dir)
    with open(one[0]["infer1"]["report"], "rb") as f:
        ref_report = f.read()
    ref_utts = one[0]["infer1"]["num_utts"]

    out = {"one_s": one_s, "world1_s": w1_s, "world2_s": w2_s,
           "nondeterministic": sorted({op for ranks in (one, w1, w2)
                                       for r in ranks
                                       for op in r["nondeterministic"]})}
    ref_state = par_state(ref_dir)["model"]
    n_layers = RUN_LAYERS
    for name, ranks in (("one", one), ("ddp1", w1), ("fsdp1", w1),
                        ("ddp2", w2)):
        recs = [r[name] for r in ranks]
        world = len(recs)
        assert all(r["world"] == world for r in recs), recs
        assert (recs[0]["fsdp"] > 0) == name.startswith("fsdp"), recs[0]
        # PAR_STEPS steps and the evaluation's batches, 1 B2 per step (no
        # noise batch) and per eval batch
        for r in recs:
            n_eval = r["launches"]["fbank"] - PAR_STEPS
            assert n_eval > 0 and r["launches"]["attn_weights"] == \
                n_layers * (PAR_STEPS + n_eval), (name, r["launches"])
        workdir = os.path.join(root, "tasks", name)
        lines = metrics_of(workdir)
        assert [x["step"] for x in lines] == list(range(1, PAR_STEPS + 1))
        loss_err = max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                       for g, w in zip(lines, ref_lines))
        grad_err = max(abs(g["grad_norm"] - w["grad_norm"])
                       / abs(w["grad_norm"])
                       for g, w in zip(lines, ref_lines))
        same, worst, at = par_param_diff(par_state(workdir)["model"],
                                         ref_state)
        evals = [r["last_eval"] for r in recs]
        assert all(e == evals[0] for e in evals), evals
        rec = {"world": world, "loss_rel_err": loss_err,
               "grad_norm_rel_err": grad_err, "params_bitwise": same,
               "params_worst_rel": worst, "params_worst_at": at,
               "last_eval": evals[0],
               "ranks": [{k: r[k] for k in (
                   "launches", "calls_held", "max_abs_err", "wall_s",
                   "peak_memory_bytes", "held_ms_per_step", "timed")
                   if k in r} for r in recs]}
        if name == "one":
            pass                # the reference itself
        elif world == 1:
            assert loss_err <= PAR_SAME_RTOL and grad_err <= PAR_SAME_RTOL \
                and worst <= PAR_SAME_RTOL, (name, rec)
        else:
            assert loss_err <= PAR_LOSS_RTOL and \
                grad_err <= PAR_GRAD_RTOL, (name, rec)
        out[name] = rec
        timed = [r["timed"] for r in recs if "timed" in r]
        if timed:
            timing = (
                f"; alone on the card, ms/step per rank at B={timed[0]['B']}"
                f" {[[round(x, 2) for x in t['ms_per_step']] for t in timed]}"
                f", peak memory per rank "
                f"{[round(t['peak_memory_bytes'] / 2**30, 3) for t in timed]}"
                f" GiB, a profiled step "
                f"{[round(t['profiled_wall_ms'], 2) for t in timed]} ms with"
                f" collectives (host) {[t['comm'] for t in timed]}")
        else:
            timing = ""
        log(f"parallel {name} ({world} rank(s)): {PAR_STEPS} steps against "
            f"one process: loss rel err {loss_err:.3g}, grad_norm "
            f"{grad_err:.3g}, parameters "
            f"{'bitwise equal' if same else 'differ'} (worst rel "
            f"{worst:.3g} at {at}); eval {evals[0]}; launches per rank "
            f"{[r['launches'] for r in recs]}, all held; peak memory of the "
            f"held run per rank "
            f"{[round(r['peak_memory_bytes'] / 2**30, 3) for r in recs]} "
            f"GiB, held step ms (median) per rank "
            f"{[round(statistics.median(r['held_ms_per_step']), 2) for r in recs]}"
            f"{timing}", card)
    # (d) the sharded report: rank 0 wrote one process's bytes
    infer = [r["infer2"] for r in w2]
    with open(infer[0]["report"], "rb") as f:
        got = f.read()
    assert got == ref_report, "2-rank report differs from one process's"
    for r in infer + [one[0]["infer1"]]:
        assert r["num_utts"] == ref_utts, (r["num_utts"], ref_utts)
        assert r["launches"] == {"attn_weights": n_layers * r["batches"],
                                 "fbank": r["batches"]}, r["launches"]
    out["infer2"] = {"report_bytes": len(got), "ranks": [
        {k: r[k] for k in ("launches", "calls_held", "max_abs_err",
                           "wall_s", "wer", "num_utts", "batches")}
        for r in infer]}
    log(f"parallel infer2: the report of 2 gloo ranks ({len(got)} bytes, "
        f"{infer[0]['num_utts']} utts, WER {infer[0]['wer']:.4f}) equals "
        f"one process's byte for byte; launches per rank "
        f"{[r['launches'] for r in infer]}", card)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"parallel phase {out['phase_s']:.1f} s", card)
    report["parallel"] = out
    runs = {name: [r[name] for r in ranks]
            for ranks, names in ((one, ("one", "infer1")),
                                 (w1, ("ddp1", "fsdp1")),
                                 (w2, ("ddp2", "infer2")))
            for name in names}
    records = [r for recs in runs.values() for r in recs]
    return {k: {"launches": sum(r["launches"][k] for r in records),
                "runs": {name: [r["launches"][k] for r in recs]
                         for name, recs in runs.items()},
                "calls_held": sum(r["calls_held"][k] for r in records),
                "max_abs_err": max(r["max_abs_err"][k] for r in records)}
            for k in ("attn_weights", "fbank")}


def phase_compare(prev_dir, enc_cfg, card, report):
    """The earlier package's public entry points against this tree's, on
    the same inputs: device time in turns and wrapper host time."""
    from speech2text_torch.data.frontend import Fbank
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import fbank as fb
    from speech2text_torch.tools.timing import (attn_inputs, host_ms,
                                                pad_mask_of, stack_shapes)
    paw, pfb = load_earlier(prev_dir)
    qd, pd = enc_cfg["query_head_dim"], enc_cfg["pos_head_dim"]
    shapes = stack_shapes(enc_cfg, 10 * SR)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    dt = torch.bfloat16
    rows = {}
    t0 = time.perf_counter()
    for T, H in sorted(set(shapes)):
        mask = pad_mask_of(rng, B_SERVE, T)
        q, k, qp, p = attn_inputs(gen, B_SERVE, T, H, qd, pd, dt)
        args = (q, k, qp, p, mask, dt)
        r = in_turns(lambda: paw.zip_weights(*args),
                     lambda: aw.zip_weights(*args), aw.KERNEL.name)
        r["prev_host_ms"] = host_ms(lambda: paw.zip_weights(*args))
        r["this_host_ms"] = host_ms(lambda: aw.zip_weights(*args))
        rows[f"attn_weights T={T} H={H}"] = r
    per_req = [rows[f"attn_weights T={T} H={H}"] for (T, H), n in
               zip(shapes, enc_cfg["num_encoder_layers"]) for _ in range(n)]

    fbank = Fbank().cuda()
    cfg = fbank.cfg
    N = 10 * SR + 77
    x = torch.from_numpy((0.2 * rng.standard_normal((B_SERVE, N)))
                         .astype(np.float32)).cuda()
    args = (x, fbank.window, fbank.dft_cos, fbank.dft_sin, fbank.banks,
            cfg.num_frames(N), cfg.frame_length, cfg.frame_shift,
            cfg.preemphasis, cfg.remove_dc_offset)
    r = in_turns(lambda: pfb.fbank(*args), lambda: fb.fbank(*args),
                 fb.KERNEL.name)
    r["prev_host_ms"] = host_ms(lambda: pfb.fbank(*args))
    r["this_host_ms"] = host_ms(lambda: fb.fbank(*args))
    rows[f"fbank B={B_SERVE} frames={cfg.num_frames(N)}"] = r
    log(f"compare with {prev_dir}: {time.perf_counter() - t0:.1f} s, the "
        f"earlier kernels' build included")
    for name, r in rows.items():
        log(f"compare {name}: earlier kernel {r['prev_ms'][0]:.4f} / "
            f"{r['prev_ms'][1]:.4f} ms, this {r['this_ms'][0]:.4f} / "
            f"{r['this_ms'][1]:.4f} ms (device, in turns); wrapper host "
            f"earlier {r['prev_host_ms']:.4f} ms, this "
            f"{r['this_host_ms']:.4f} ms", card)
    req = {key: sum(statistics.mean(r[key]) if isinstance(r[key], list)
                    else r[key] for r in per_req)
           for key in ("prev_ms", "this_ms", "prev_host_ms", "this_host_ms")}
    log(f"compare attn_weights per request ({len(per_req)} launches): "
        f"earlier {req['prev_ms']:.4f} ms, this {req['this_ms']:.4f} ms "
        f"device; wrapper host earlier {req['prev_host_ms']:.4f} ms, this "
        f"{req['this_host_ms']:.4f} ms", card)
    report["compare"] = {"prev_dir": prev_dir, "rows": rows,
                         "attn_weights_per_request": req}


# ------------------------------------------------------------ phase 20
GRID_RATES = (8000, 16000, 32000, 48000)  # 25 ms frames: n_fft 256 .. 2048
DITHER_STEP = 1.0 / 32768     # one int16 step on the [-1, 1] PCM
GRID_B, GRID_SECS = 16, 10   # each variant: B=16 ragged clips of 2-10 s
TEL_STEPS = 6                 # steps of the 8 kHz recipe (one evaluation)
TEL_UTTS = (64, 16, 4)        # its corpus: train, eval, noise clips
REMAT_STEPS = 2               # timed steps per recompute setting
REMAT_HELDOUT_B = 32


def fbank_args(fbank, T, noise=None):
    """The wrapper's positional arguments after the PCM for `fbank`'s
    config, T frames and the dither noise (scaled by the config's dither)
    when given."""
    cfg = fbank.cfg
    return (fbank.window, fbank.dft_cos, fbank.dft_sin, fbank.banks, T,
            cfg.frame_length, cfg.frame_shift, cfg.preemphasis,
            cfg.remove_dc_offset, cfg.snip_edges, noise,
            cfg.dither if noise is not None else 0.0)


def fbank_variant(rate, snip, dither, rng, gen, card):
    """One B2 variant against the plain version on the same inputs: B=16
    ragged 2-10 s clips, N % shift != 0, white noise held at FBANK_TOL
    and band-limited audio with silence by check_mel, each with its own
    dither noise when `dither` > 0; and, for centred framing, a clip
    shorter than half a frame (reflected more than once)."""
    from speech2text_torch.data.frontend import Fbank, FbankConfig
    from speech2text_torch.ops import fbank as fb
    fbank = Fbank(FbankConfig(sample_rate=rate, snip_edges=snip,
                              dither=dither)).cuda()
    cfg = fbank.cfg
    N = GRID_SECS * rate + 77
    assert N % cfg.frame_shift != 0
    lens = rng.integers(N // 5, N + 1, GRID_B)
    lens[0] = N
    beyond = np.arange(N)[None] >= lens[:, None]
    T = cfg.num_frames(N)
    errs = {}
    for signal in ("white", "band_limited"):
        pcm = (0.2 * rng.standard_normal((GRID_B, N))).astype(np.float32) \
            if signal == "white" else band_limited_pcm(rng, GRID_B, N, rate)
        pcm[beyond] = 0.0
        x = torch.from_numpy(pcm).cuda()
        noise = fb.dither_noise(GRID_B, T, cfg.frame_length, gen, "cuda") \
            if dither else None
        a = (x,) + fbank_args(fbank, T, noise)
        got, want = fb.fbank_cuda(*a), fb.fbank_plain(*a)
        assert got.shape == (GRID_B, T, cfg.num_mel_bins)
        label = f"fbank n_fft={cfg.padded_window_size} snip={snip} " \
                f"dither={dither} {signal}"
        if signal == "white":
            errs[signal] = check_close(label, got, want, **FBANK_TOL)
        else:
            errs["band_limited_of_energy"] = check_mel(label, got, want)
            errs[signal] = float((got - want).abs().max())
    calls = 2
    if not snip:
        Ns = cfg.frame_length // 2 - 7
        Ts = cfg.num_frames(Ns)
        x = torch.from_numpy((0.2 * rng.standard_normal((2, Ns))).astype(
            np.float32)).cuda()
        noise = fb.dither_noise(2, Ts, cfg.frame_length, gen, "cuda") \
            if dither else None
        a = (x,) + fbank_args(fbank, Ts, noise)
        errs["short_clip"] = check_close(
            f"fbank n_fft={cfg.padded_window_size} centred {Ns}-sample clip",
            fb.fbank_cuda(*a), fb.fbank_plain(*a), **FBANK_TOL)
        calls += 1
    return {"rate": rate, "n_fft": cfg.padded_window_size,
            "snip_edges": snip, "dither": dither, "frames": T,
            "calls_held": calls, "max_abs_err": errs}


def phase_fbank_grid(card, out):
    """Phase 20 (a): every B2 variant held to its plain version, then two
    of them timed at B=128 x 10 s."""
    from speech2text_torch.data.frontend import Fbank, FbankConfig
    from speech2text_torch.ops import fbank as fb
    rng = np.random.default_rng(SEED + 20)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    cases = [fbank_variant(rate, snip, dither, rng, gen, card)
             for rate in GRID_RATES for snip in (True, False)
             for dither in (0.0, DITHER_STEP)]
    for c in cases:
        log(f"fbank variant {c['rate']} Hz n_fft={c['n_fft']} "
            f"{'snip_edges' if c['snip_edges'] else 'centred'} dither "
            f"{c['dither']:.3g}: {c['calls_held']} calls held, max abs err "
            f"{ {k: float(f'{v:.3g}') for k, v in c['max_abs_err'].items()} }",
            card)
    timed = {}
    for name, rate, dither in (("8k_centred", 8000, 0.0),
                               ("16k_centred_dither", 16000, DITHER_STEP)):
        fbank = Fbank(FbankConfig(sample_rate=rate, snip_edges=False,
                                  dither=dither)).cuda()
        cfg = fbank.cfg
        x = torch.from_numpy((0.1 * rng.standard_normal(
            (B_TRAIN, TRAIN_SECS * rate))).astype(np.float32)).cuda()
        T = cfg.num_frames(x.shape[1])
        noise = fb.dither_noise(B_TRAIN, T, cfg.frame_length, gen, "cuda") \
            if dither else None
        a = (x,) + fbank_args(fbank, T, noise)
        err = check_close(f"fbank B={B_TRAIN} {name}", fb.fbank_cuda(*a),
                          fb.fbank_plain(*a), **FBANK_TOL)
        timed[name] = fbank_timing(fbank, x, card, err, noise)
        del x, noise
    torch.cuda.empty_cache()
    out["fbank_grid"] = cases
    out["fbank_timed"] = timed
    return cases, timed


def telephony_argv(tmp, corpus, trained):
    """build_task's argv for the 8 kHz recipe: the flagship YAML with
    fbank at 8 kHz, centred framing and one int16 step of dither, phase
    10's subword model, on the 8 kHz corpus."""
    spm = os.path.join(trained["workdir"], "spm")
    argv = ["--training_config", TRAIN_CFG, "--max_steps", str(TEL_STEPS)]
    for ov in (f"task.export_path={tmp}/tasks", "task.name=telephony_8k",
               f"dataset.base_dir={tmp}/corpus8k",
               "dataset.sample_rate=8000", "dataset.feat_type=fbank",
               "dataset.feat_config.samplerate=8000",
               "dataset.feat_config.snip_edges=false",
               f"dataset.feat_config.dither={DITHER_STEP!r}",
               f"dataset.bucket_sampler_config.volume_threshold={PAR_VOLUME}",
               f"dataset.bucket_sampler_config.num_bucket={PAR_BUCKETS}",
               "tokenizer.apply_train=false",
               f"tokenizer.config.spm_model={spm}/tokenizer.model",
               f"tokenizer.config.spm_vocab={spm}/tokenizer.vocab",
               f"trainer.val_check_interval={TEL_STEPS}",
               "trainer.log_interval=1"):
        argv += ["--override", ov]
    for key, path in corpus.items():
        argv += ["--override", f"dataset.{key}={path}"]
    return argv


def dither_spy():
    """Wrap fbank_cuda to count its calls with dither noise and with
    centred framing; returns (counts, undo)."""
    from speech2text_torch.ops import fbank as fb
    inner = fb.fbank_cuda
    seen = {"calls": 0, "dither": 0, "centred": 0}

    def spy(*a):
        seen["calls"] += 1
        seen["dither"] += a[11] is not None
        seen["centred"] += not a[10]
        return inner(*a)

    fb.fbank_cuda = spy

    def undo():
        fb.fbank_cuda = inner
    return seen, undo


def phase_telephony(card, out, tmp, trained):
    """Phase 20 (b): the 8 kHz telephony recipe through build_task's main
    (TEL_STEPS steps, one evaluation), then pruned_rnnt_greedy_search on
    its checkpoint through inference's main; every B1 and B2 call held."""
    from speech2text_torch import build_task, inference
    from speech2text_torch.tools.synth_corpus import write_corpus
    t0 = time.perf_counter()
    n_train, n_eval, n_noise = TEL_UTTS
    corpus = write_corpus(os.path.join(tmp, "corpus8k"), seed=SEED + 8,
                          n_train=n_train, n_eval=n_eval, n_noise=n_noise,
                          sample_rate=8000)
    seen, undo = dither_spy()
    try:
        trainer, train = held_main("telephony train", build_task.main,
                                   telephony_argv(tmp, corpus, trained))
        train_seen = dict(seen)
        task = trainer.task
        fcfg = task.frontend.cfg
        assert (fcfg.sample_rate, fcfg.padded_window_size, fcfg.snip_edges,
                fcfg.dither) == (8000, 256, False, DITHER_STEP), fcfg
        n_layers = sum(task.model.encoder.config.num_encoder_layers)
        eval_batches = task.make_eval_pipeline().batches_per_epoch()
        want = {"attn_weights": n_layers * (TEL_STEPS + eval_batches),
                "fbank": 2 * TEL_STEPS + eval_batches}
        assert train["launches"] == want, (train["launches"], want)
        assert train_seen["dither"] == TEL_STEPS and \
            train_seen["centred"] == train_seen["calls"], train_seen
        with open(os.path.join(trainer.workdir, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        assert [r["step"] for r in lines] == list(range(1, TEL_STEPS + 1))
        assert all(_finite_record(r, ("loss", "grad_norm")) for r in lines)
        assert _finite_record(trainer.last_eval, ("val_loss", "wer")), \
            trainer.last_eval
        train_cfg = os.path.join(trainer.workdir, os.path.basename(TRAIN_CFG))
        export = os.path.join(tmp, "infer8k")
        seen.update(calls=0, dither=0, centred=0)
        run, infer = held_main("telephony decode", inference.main, [
            *recipe_infer_argv(CFG, export, train_cfg, corpus),
            "--override", "testset.config.feat_type=fbank"])
        infer_seen = dict(seen)
    finally:
        undo()
    test_batches = infer["launches"]["fbank"]
    assert test_batches > 0 and infer["launches"]["attn_weights"] == \
        n_layers * test_batches, infer["launches"]
    assert infer_seen["dither"] == 0 and \
        infer_seen["centred"] == infer_seen["calls"], infer_seen
    with open(os.path.join(export, "test_report.txt")) as f:
        hyps = f.read().count("\nhyp: ")
    assert hyps == run["num_utts"] > 0, (hyps, run)
    wall = time.perf_counter() - t0
    log(f"telephony 8 kHz recipe (fbank n_fft=256, centred, dither "
        f"{DITHER_STEP:.6g}): {TEL_STEPS} steps + 1 evaluation in "
        f"{train['wall_s']:.1f} s, losses "
        f"{[round(r['loss'], 3) for r in lines]}, eval "
        f"{ {k: round(v, 4) for k, v in trainer.last_eval.items()} }; "
        f"launches {train['launches']} (dither on {train_seen['dither']} "
        f"speech batches), all held, worst {train['max_abs_err']}; greedy "
        f"decode of {run['num_utts']} utterances in {infer['wall_s']:.1f} s, "
        f"WER {run['wer']:.4f}, launches {infer['launches']}, all held; "
        f"phase (b) {wall:.1f} s", card)
    out["telephony"] = {"train": train, "infer": infer, "metrics": lines,
                        "eval": trainer.last_eval, "wer": run["wer"],
                        "dither_calls": train_seen["dither"], "wall_s": wall}
    del trainer, task
    torch.cuda.empty_cache()
    return train, infer


def layer_draws_for(model, B, seed):
    """Seeded dynamics draws for every Zipformer2 layer of `model`."""
    from speech2text_torch.models import zipformer as tz
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [tz.sample_layer_draws(B, 0.25, gen, "cuda")
            for m in model.modules()
            if isinstance(m, tz.Zipformer2EncoderLayer)]


def remat_settings(cfg_path, batch_of, card, label, draws_seed=None,
                   timed=REMAT_STEPS):
    """One TrainStep of `cfg_path` from the seed per recompute setting
    (off, "full", "dots"), deterministic algorithms on: the first step's
    losses and gradients against the run without recompute bit for bit,
    its peak memory, B1 launches per step, then `timed` steps' ms. With
    `draws_seed` each layer is handed the same seeded dynamics draws."""
    from speech2text_torch.config import load_config
    from speech2text_torch.models import zipformer as tz
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.train.step import TrainStep
    base = load_config(cfg_path)
    rec, want = {}, None
    for policy in (None, "full", "dots"):
        cfg = copy.deepcopy(base)
        cfg["encoder"]["config"].update(remat=policy is not None,
                                        remat_policy=policy or "full")
        ts = TrainStep(cfg, device="cuda", seed=SEED)
        batch = batch_of(ts)
        layers = [m for m in ts.model.modules()
                  if isinstance(m, tz.Zipformer2EncoderLayer)]
        if draws_seed is not None:
            for layer, d in zip(layers, layer_draws_for(
                    ts.model, batch[0].shape[0], draws_seed)):
                layer.given_draws = d
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a0 = aw.KERNEL.launches
        t0 = time.perf_counter()
        out = ts.step(*batch)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        b1 = aw.KERNEL.launches - a0
        peak = torch.cuda.max_memory_allocated()
        losses = {k: v.detach().clone() for k, v in out.items()}
        # on the host: the next settings' peak memory holds no copy
        grads = {k: p.grad.detach().cpu()
                 for k, p in ts.model.named_parameters() if p.grad is not None}
        assert all(bool(torch.isfinite(v).all()) for v in losses.values())
        name = policy or "off"
        if want is None:
            want = (losses, grads)
            diffs = []
        else:
            diffs = [(k, float((v.float() - want[0][k].float()).abs().max()))
                     for k, v in losses.items()
                     if not torch.equal(v, want[0][k])]
            diffs += [(k, float((g.float() - want[1][k].float()).abs().max()))
                      for k, g in grads.items() if not torch.equal(g, want[1][k])]
            assert grads.keys() == want[1].keys()
        del grads
        times = []
        for _ in range(timed):
            t0 = time.perf_counter()
            ts.step(*batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        rec[name] = {"loss": float(losses["loss"]), "first_step_ms": first_ms,
                     "ms_per_step": times, "peak_memory_bytes": peak,
                     "attn_weights_per_step": b1, "differs": diffs,
                     "layers": len(layers)}
        then = (f"then {', '.join(f'{t:.1f}' for t in times)} ms/step"
                if times else "no step timed after it")
        log(f"{label} remat {name}: loss {float(losses['loss']):.6f}, "
            f"{'bitwise equal to off' if not diffs else f'differs: {diffs[:5]}'}"
            f", first step {first_ms:.1f} ms, {then}, peak memory "
            f"{peak / 2**30:.3f} GiB, B1 launches per step {b1}", card)
        del ts, out, losses
        torch.cuda.empty_cache()
    return rec


def phase_remat(card, out):
    """Phase 20 (c): recompute on the flagship step at bench.py's shape
    (bf16, B=128 x 10 s) and once on the heldout step with dynamics,
    dropout and given draws (B=32 x 10 s)."""
    deterministic(True)
    try:
        flag = remat_settings(
            TRAIN_CFG, lambda ts: bench_batch(ts.model.joiner.config.output_dim),
            card, f"flagship step B={B_TRAIN}")

        def heldout_batch(ts):
            return tuple(t[:REMAT_HELDOUT_B] for t in
                         bench_batch(ts.model.joiner.config.output_dim))
        held = remat_settings(HELDOUT_CFG, heldout_batch, card,
                              f"heldout step B={REMAT_HELDOUT_B}",
                              draws_seed=SEED + 14, timed=0)
    finally:
        deterministic(False)
    for label, rec in (("flagship", flag), ("heldout", held)):
        n = rec["off"]["layers"]
        for name, r in rec.items():
            assert not r["differs"], f"{label} remat {name} differs from " \
                f"off: {r['differs'][:10]}"
        assert rec["off"]["attn_weights_per_step"] == n and \
            rec["full"]["attn_weights_per_step"] == 2 * n and \
            rec["dots"]["attn_weights_per_step"] == n, rec
        assert rec["full"]["peak_memory_bytes"] < \
            rec["off"]["peak_memory_bytes"], f"{label}: full's peak memory"
        assert rec["dots"]["peak_memory_bytes"] <= \
            rec["off"]["peak_memory_bytes"], f"{label}: dots' peak memory"
    out["remat"] = {"flagship": flag, "heldout": held}
    return flag, held


def phase_options(card, report, tmp, trained):
    """Phase 20: B2 at every FFT size, framing and dither; the 8 kHz
    telephony recipe; Zipformer2 recompute."""
    t0 = time.perf_counter()
    out = {}
    cases, timed = phase_fbank_grid(card, out)
    grid_s = time.perf_counter() - t0
    train, infer = phase_telephony(card, out, tmp, trained)
    tel_s = time.perf_counter() - t0 - grid_s
    flag, held = phase_remat(card, out)
    out["seconds"] = {"grid": grid_s, "telephony": tel_s,
                      "remat": time.perf_counter() - t0 - grid_s - tel_s,
                      "phase": time.perf_counter() - t0}
    log(f"phase 20: {out['seconds']['phase']:.1f} s (grid {grid_s:.1f}, "
        f"telephony {tel_s:.1f}, recompute {out['seconds']['remat']:.1f})",
        card)
    report["options"] = out
    runs = {"train": train, "infer": infer}
    fbank = {
        "launches": sum(r["launches"]["fbank"] for r in runs.values()),
        "calls_held": sum(r["calls_held"]["fbank"] for r in runs.values()),
        "max_abs_err": max(r["max_abs_err"]["fbank"] for r in runs.values()),
        "launches_per_step": 2, "runs": {k: r["launches"]["fbank"]
                                         for k, r in runs.items()},
        "variants": [{k: c[k] for k in ("n_fft", "snip_edges", "dither",
                                        "calls_held", "max_abs_err")}
                     for c in cases],
        "timed": timed}
    attn = {
        "launches": sum(r["launches"]["attn_weights"] for r in runs.values()),
        "calls_held": sum(r["calls_held"]["attn_weights"]
                          for r in runs.values()),
        "max_abs_err": max(r["max_abs_err"]["attn_weights"]
                           for r in runs.values()),
        "remat": {label: {name: {k: r[k] for k in (
            "attn_weights_per_step", "peak_memory_bytes", "ms_per_step")}
            for name, r in rec.items()}
            for label, rec in (("flagship", flag), ("heldout", held))}}
    return {"fbank": fbank, "attn_weights": attn}



# ------------------------------------------------------------ phase 21: B3
# (B, T, U) of the benchmark cell's eight buckets (s2t_bench's aishell1_train
# traffic under the flagship YAML: batch, encoder frames of the padded PCM,
# label columns), with their shares of an epoch's steps
LATTICE_SHAPES = ((512, 98, 24), (512, 148, 32), (388, 173, 40),
                  (306, 223, 48), (252, 273, 56), (215, 323, 72),
                  (187, 373, 80), (165, 423, 88))
LATTICE_SHARES = (34, 103, 86, 40, 14, 5, 2, 1)
LATTICE_WIDE = (2, 40, 1500)      # U+1 > 1024: two cells a thread
LATTICE_V = 4336                  # arcs near -log V, as a fresh model's
LATTICE_BAND_V = 64               # the pruned band's joiner width
LATTICE_PRUNE = 5                 # the flagship's prune range
LATTICE_TOTAL_RTOL = 1e-5
LATTICE_TOL = dict(rtol=1e-4, atol=1e-6)


class PlainLatticeTrips:
    """While entered: the anti-diagonals the plain lattice loops walk
    (ops/rnnt.py's lattice_forward_plain, lattice_backward_plain)."""

    def __enter__(self):
        from speech2text_torch.ops import rnnt as rn
        self.rn = rn
        self.orig = (rn.lattice_forward_plain, rn.lattice_backward_plain)
        self.trips = 0

        def counted(fn, extra):
            def wrapped(px, *args):
                self.trips += px.shape[1] + px.shape[2] + extra
                return fn(px, *args)
            return wrapped

        rn.lattice_forward_plain = counted(self.orig[0], -1)
        rn.lattice_backward_plain = counted(self.orig[1], 0)
        return self

    def __exit__(self, *exc):
        self.rn.lattice_forward_plain, self.rn.lattice_backward_plain = \
            self.orig


def lattice_lens(rng, B, T, U):
    """Lengths with the edges first, (T, U), (1, 0), (T, 0), (1, U), then
    t in [T/2, T] and u in [0, U] at random."""
    t = rng.integers(max(1, T // 2), T + 1, B)
    u = rng.integers(0, U + 1, B)
    for i, (ti, ui) in enumerate(((T, U), (1, 0), (T, 0), (1, U))[:B]):
        t[i], u[i] = ti, ui
    return (torch.from_numpy(t.astype(np.int32)).cuda(),
            torch.from_numpy(u.astype(np.int32)).cuda())


def lattice_arcs(rng, B, T, U):
    """Emit and blank log-probs at a fresh model's scale: -log V plus
    noise of 0.5 (totals near -8.4 (T+U))."""
    base = -math.log(LATTICE_V)
    return tuple(torch.from_numpy(
        (base + 0.5 * rng.standard_normal(shape)).astype(np.float32)).cuda()
        for shape in ((B, T, U), (B, T, U + 1)))


def lattice_check(label, px, py, tl, ul, g):
    """Kernel B3's totals and arc gradients for the incoming gradient g,
    against autograd through the plain loop on the card (totals within
    LATTICE_TOTAL_RTOL, gradients within LATTICE_TOL where a path exists)
    and against the plain walk back (LATTICE_TOL everywhere); exact 0
    where there is no path or g = 0; no NaN. Returns the record, the
    kernel's gradients and autograd's."""
    from speech2text_torch.ops import rnnt as rn
    total, alpha = rn.lattice_forward_cuda(px, py, tl, ul)
    gpx, gpy = rn.lattice_backward_cuda(px, py, tl, ul, alpha, total, g)
    a, b = px.clone().requires_grad_(), py.clone().requires_grad_()
    want, plain_alpha = rn.lattice_forward_plain(a, b, tl, ul)
    (want * g).sum().backward()
    want = want.detach()
    walk = rn.lattice_backward_plain(px, py, tl, ul, plain_alpha.detach(),
                                     want, g)
    torch.cuda.synchronize()
    nan = sum(int(x.isnan().sum()) for x in (total, gpx, gpy))
    assert nan == 0, f"{label}: {nan} NaN from kernel B3"
    path = want > rn.NEG_INF / 2
    assert bool((total[~path] <= rn.NEG_INF / 2).all()), \
        f"{label}: a total without a path above NEG_INF / 2"
    rec = {"label": label, "shape": list(px.shape),
           "no_path": int((~path).sum()), "g_zero": int((g == 0).sum()),
           "nan": nan,
           "total_err": check_close(f"{label} total", total[path],
                                    want[path], LATTICE_TOTAL_RTOL, 0.0)}
    live = path & (g != 0)
    for name, got, oracle, plain in (("px", gpx, a.grad, walk[0]),
                                     ("py", gpy, b.grad, walk[1])):
        rec[f"grad_{name}_err"] = check_close(
            f"{label} grad_{name}", got[path], oracle[path], **LATTICE_TOL)
        rec[f"grad_{name}_walk_err"] = check_close(
            f"{label} grad_{name} against the walk", got, plain,
            **LATTICE_TOL)
        assert bool((got[~live] == 0).all()), \
            f"{label}: grad_{name} not 0 without a path or g"
    return rec, (gpx, gpy), (a.grad, b.grad)


def lattice_ranges(occ, plain_occ, tl, ul):
    """Prune ranges from kernel B3's occupancies against those from
    autograd's: the equal share and every difference (b, t, kernel,
    plain)."""
    from speech2text_torch.ops import pruned_rnnt as tp
    rk = tp.get_rnnt_prune_ranges(*occ, tl, ul, LATTICE_PRUNE)
    rp = tp.get_rnnt_prune_ranges(*plain_occ, tl, ul, LATTICE_PRUNE)
    diff = [[b, t, int(rk[b, t]), int(rp[b, t])]
            for b, t in (rk != rp).nonzero().tolist()]
    return {"equal_share": float((rk == rp).float().mean()),
            "differences": diff}


def lattice_pruned(rng, occ, tl, ul, g):
    """rnnt_loss_pruned on the card through kernel B3 against the same
    loss through autograd over the plain loop, with utterance 5 made
    infeasible (4 frames, U labels: more than the band's R-1 emits a
    frame): the per-utterance losses and the logits' gradient, that
    utterance's loss and gradient 0, no NaN; and the band's arcs
    (NEG_INF off the windows) held by lattice_check."""
    from unittest import mock

    from speech2text_torch.ops import pruned_rnnt as tp
    from speech2text_torch.ops import rnnt as rn
    B, T, U = occ[0].shape
    R, V = LATTICE_PRUNE, LATTICE_BAND_V
    tl, ul = tl.clone(), ul.clone()
    tl[5], ul[5] = 4, U
    ranges = tp.get_rnnt_prune_ranges(*occ, tl, ul, R)
    logits = torch.from_numpy(rng.standard_normal((B, T, R, V))
                              .astype(np.float32)).cuda()
    sym = torch.from_numpy(rng.integers(1, V, (B, U))
                           .astype(np.int32)).cuda()
    seen = []

    def spy(px, py, t_lens, u_lens):
        seen.append((px.detach(), py.detach()))
        return rn.lattice_forward(px, py, t_lens, u_lens)

    def plain(px, py, t_lens, u_lens):
        return rn.lattice_forward_plain(px, py, t_lens, u_lens)[0]

    out = []
    for fn in (spy, plain):
        x = logits.clone().requires_grad_()
        with mock.patch.object(tp, "lattice_forward", fn):
            nll = tp.rnnt_loss_pruned(x, sym, ranges, tl, ul,
                                      reduction="none")
        nll.sum().backward()
        out.append((nll.detach(), x.grad))
    (nll, grad), (want, want_grad) = out
    torch.cuda.synchronize()
    assert not bool(nll.isnan().any() or grad.isnan().any()), \
        "NaN in the pruned loss through kernel B3"
    assert float(nll[5]) == 0.0 and bool((grad[5] == 0).all()), \
        "the infeasible pruned utterance has a loss or a gradient"
    rec = {"nll_err": check_close("pruned nll", nll, want,
                                  LATTICE_TOTAL_RTOL, 0.0),
           "logits_grad_err": check_close("pruned logits grad", grad,
                                          want_grad, **LATTICE_TOL),
           "infeasible_nll": float(nll[5])}
    band, _, _ = lattice_check("pruned band", *seen[0], tl, ul, g)
    return rec, band


def lattice_timing(px, py, tl, ul):
    """Device ms of each B3 kernel at one shape (median of 30 launches),
    with the bytes bound of the pair and its chain of diagonals."""
    from speech2text_torch.ops import rnnt as rn
    from speech2text_torch.tools.timing import device_ms
    B, T, U = px.shape
    total, alpha = rn.lattice_forward_cuda(px, py, tl, ul)
    g = torch.ones_like(total)
    fwd = device_ms(lambda: rn.lattice_forward_cuda(px, py, tl, ul),
                    "lattice_alpha_kernel")
    bwd = device_ms(lambda: rn.lattice_backward_cuda(px, py, tl, ul, alpha,
                                                     total, g),
                    "lattice_grad_kernel")
    cells, cells1 = B * T * U, B * T * (U + 1)
    # forward: px, py in, alpha and the totals out; backward: px, py,
    # alpha in, both gradients out
    nbytes = 4 * ((cells + 2 * cells1 + 3 * B) + (2 * cells + 3 * cells1
                                                  + 4 * B))
    last = int((tl.long() - 1 + ul.long().clamp(0, U)).max())
    return {"forward_ms": fwd, "backward_ms": bwd,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "diagonals": T + U - 1, "last_diagonal": last,
            "us_per_diagonal": (fwd + bwd) * 1e3 / (2 * max(last, 1))}


def phase_lattice(card, report):
    """Phase 21: kernel B3 against autograd through the plain loop at the
    benchmark cell's bucket shapes and the edges, the prune ranges from
    its occupancies, its times against the plain loop's."""
    from speech2text_torch.ops import rnnt as rn
    from speech2text_torch.tools.timing import events_ms
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 21)
    cases, ranges, timed = [], {}, {}
    pruned = plain_ms = None
    for B, T, U in LATTICE_SHAPES:
        key = f"{B}x{T}x{U}"
        px, py = lattice_arcs(rng, B, T, U)
        tl, ul = lattice_lens(rng, B, T, U)
        rec, occ, plain_occ = lattice_check(
            f"occupancies {key}", px, py, tl, ul,
            torch.ones(B, device="cuda"))
        cases.append(rec)
        ranges[key] = lattice_ranges(occ, plain_occ, tl, ul)
        g = torch.from_numpy(rng.uniform(-2, 2, B).astype(np.float32)).cuda()
        g[4] = 0.0
        cases.append(lattice_check(f"gradients {key}", px, py, tl, ul,
                                   g)[0])
        timed[key] = lattice_timing(px, py, tl, ul)
        if (B, T, U) != LATTICE_SHAPES[2]:
            continue
        pruned, band = lattice_pruned(rng, occ, tl, ul, g)
        cases.append(band)
        t0l, u0l = tl.clone(), ul.clone()
        t0l[4:6] = 0
        u0l[4], u0l[5] = 0, 3
        cases.append(lattice_check(f"t_len 0 {key}", px, py, t0l, u0l,
                                   g)[0])
        cases.append(lattice_check(f"B=1 {key}", px[:1], py[:1], tl[:1],
                                   ul[:1], g[:1])[0])

        def plain_pair(px=px, py=py, tl=tl, ul=ul):
            a, b = px.clone().requires_grad_(), py.clone().requires_grad_()
            rn.lattice_forward_plain(a, b, tl, ul)[0].sum().backward()

        plain_ms = {"shape": key,
                    "forward_backward_ms": events_ms(plain_pair, iters=3,
                                                     warmup=1)}
    B, T, U = LATTICE_WIDE
    px, py = lattice_arcs(rng, B, T, U)
    tl = torch.full((B,), T, dtype=torch.int32, device="cuda")
    ul = torch.tensor([U, U // 2], dtype=torch.int32, device="cuda")
    cases.append(lattice_check(f"wide {B}x{T}x{U}", px, py, tl, ul,
                               torch.ones(B, device="cuda"))[0])
    worst = {k: max(c[k] for c in cases) for k in (
        "total_err", "grad_px_err", "grad_py_err", "grad_px_walk_err",
        "grad_py_walk_err")}
    share = sum(LATTICE_SHARES)
    per_step = 2 * sum(w * (r["forward_ms"] + r["backward_ms"])
                       for w, r in zip(LATTICE_SHARES, timed.values())) / share
    bound = 2 * sum(w * r["bound_ms"]
                    for w, r in zip(LATTICE_SHARES, timed.values())) / share
    out = {"cases": cases, "worst": worst, "ranges": ranges,
           "pruned": pruned, "timed": timed, "plain": plain_ms,
           "device_ms_per_step": per_step, "bound_ms_per_step": bound,
           "nan": sum(c["nan"] for c in cases),
           "seconds": time.perf_counter() - t0}
    log(f"phase 21 (B3): {len(cases)} cases held, worst {worst}, no NaN; "
        f"pruned loss {pruned}", card)
    for key, r in ranges.items():
        log(f"  ranges {key}: equal share {r['equal_share']:.6f}, "
            f"differences {r['differences'][:20]}"
            + (f" (+{len(r['differences']) - 20})"
               if len(r["differences"]) > 20 else ""), card)
    for key, r in timed.items():
        log(f"  B3 {key}: forward {r['forward_ms']:.4f} ms, backward "
            f"{r['backward_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, "
            f"{r['last_diagonal']} of {r['diagonals']} diagonals, "
            f"{r['us_per_diagonal']:.3f} us a diagonal", card)
    log(f"  B3 per flagship step (2 pairs, epoch shares): {per_step:.4f} ms "
        f"device, bound {bound:.4f} ms; plain loop {plain_ms}; phase "
        f"{out['seconds']:.1f} s", card)
    report["lattice"] = out
    return out


def main(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare-with", metavar="DIR", default=None,
                    help="an earlier speech2text_torch package to time "
                         "against this tree's kernels")
    ap.add_argument("--parallel-rank", metavar="SPEC", default=None,
                    help=argparse.SUPPRESS)   # phase 19's torchrun ranks

    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.parallel_rank:
        return par_rank_main(args.parallel_rank)
    from speech2text_torch.config import load_config
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import build
    from speech2text_torch.ops import fbank as fb
    from speech2text_torch.ops import rnnt as rn
    from speech2text_torch.serve import serving_train_config
    from speech2text_torch.tools.timing import stack_shapes

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.build([aw.KERNEL, fb.KERNEL, rn.KERNEL])
    for k in (aw.KERNEL, fb.KERNEL, rn.KERNEL):
        k.lib()
    log(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for k in (aw.KERNEL, fb.KERNEL, rn.KERNEL):
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {k.name}: {line.strip()}")

    report = {"card": card}
    enc_cfg = serving_train_config(load_config(CFG))["encoder"]["config"]
    attn, _ = phase_attn(enc_cfg, card, report)
    fbank = phase_fbank(card, report)
    layer_shapes = [
        shape for shape, n in zip(stack_shapes(enc_cfg, 10 * SR),
                                  enc_cfg["num_encoder_layers"])
        for _ in range(n)]
    attn_train, fbank_train = phase_attn_grad(enc_cfg, card, report)
    serve_launches = phase_serve(layer_shapes, card, report)
    phase_train_f32(card, report)
    launches = phase_train_bf16(card, report)
    lattice = phase_lattice(card, report)
    with tempfile.TemporaryDirectory(prefix="s2t_train_run_") as tmp:
        run_launches, run_per_step, run_err, run = phase_train_run(
            card, report, tmp)
        infer_launches, infer_per_batch, infer_err = phase_infer(
            card, report, tmp, run)
        stream = phase_stream(card, report, run)
        conformer = phase_conformer(card, report, tmp, run)
        family = phase_rnnt_family(card, report, tmp, run)
        families = phase_task_families(card, report, tmp, run)
        encoders = phase_ctc_encoders(card, report, tmp, run)
        deploy = phase_deploy(card, report, tmp, run)
        export = phase_export(card, report, tmp, run)
        par = phase_parallel(card, report, tmp, run)
        options = phase_options(card, report, tmp, run)
    if args.compare_with:
        phase_compare(args.compare_with, enc_cfg, card, report)

    keys = ("max_abs_err", "ms", "host_ms", "plain_ms", "bound_ms",
            "bound_by")
    kernels = [
        dict(name="attn_weights", route="cuda",
             source="speech2text_torch/csrc/attn_weights.cu",
             replaces="speech2text_tpu/ops/pallas/flash_attn.py:79",
             launches=launches["attn_weights"], library_ms=None,
             **{k: attn_train[k] for k in keys},
             backward_route="torch",
             backward_source="speech2text_torch/ops/attn_weights.py:"
                             "attn_weights_backward",
             backward_ms=attn_train["backward_ms"],
             serve=dict(launches=serve_launches["attn_weights"],
                        **{k: attn[k] for k in keys}),
             train_run=dict(launches=run_launches["attn_weights"],
                            launches_per_step=run_per_step["attn_weights"],
                            max_abs_err=run_err["attn_weights"]),
             infer=dict(launches=infer_launches["attn_weights"],
                        launches_per_batch=infer_per_batch["attn_weights"],
                        max_abs_err=infer_err["attn_weights"]),
             stream=stream["attn_weights"],
             conformer=conformer["attn_weights"],
             rnnt_family=family["attn_weights"],
             task_families=families["attn_weights"],
             ctc_encoders=encoders["attn_weights"],
             deploy=deploy["attn_weights"], export=export["attn_weights"],
             parallel=par["attn_weights"],
             options=options["attn_weights"]),
        dict(name="fbank", route="cuda",
             source="speech2text_torch/csrc/fbank.cu",
             replaces="speech2text_tpu/ops/pallas/fbank_kernel.py:86",
             launches=launches["fbank"], library_ms=None,
             **{k: fbank_train[k] for k in keys},
             serve=dict(launches=serve_launches["fbank"],
                        **{k: fbank[k] for k in keys}),
             train_run=dict(launches=run_launches["fbank"],
                            launches_per_step=run_per_step["fbank"],
                            max_abs_err=run_err["fbank"]),
             infer=dict(launches=infer_launches["fbank"],
                        launches_per_batch=infer_per_batch["fbank"],
                        max_abs_err=infer_err["fbank"]),
             stream=stream["fbank"], conformer=conformer["fbank"],
             rnnt_family=family["fbank"],
             task_families=families["fbank"],
             ctc_encoders=encoders["fbank"], deploy=deploy["fbank"],
             export=export["fbank"], parallel=par["fbank"],
             options=options["fbank"]),
    ]
    for k in kernels:
        paths = ("train_run", "infer", "rnnt_family", "deploy") + (
            ("stream", "conformer") if k["name"] == "fbank" else ())
        assert k["deploy"]["exported_launches"] > 0, \
            f"{k['name']} never launched inside the exported programs"
        assert (k["export"]["program_launches"] > 0) == (
            k["name"] == "fbank"), k["export"]
        for path in paths:
            assert k[path]["launches"] > 0, \
                f"{k['name']} never launched on the {path} path"
        for run, per_rank in k["parallel"]["runs"].items():
            assert per_rank and all(n > 0 for n in per_rank), \
                f"{k['name']} not launched in every rank of {run}"
        assert k["parallel"]["calls_held"] == k["parallel"]["launches"]
        assert k["options"]["launches"] > 0 and \
            k["options"]["calls_held"] == k["options"]["launches"], \
            k["options"]
        fams = k["task_families"]
        if k["name"] == "fbank":
            assert fams["cif"]["launches"] > 0 and \
                fams["ssl"]["launches"] > 0, fams
        assert k["name"] == "fbank" or not any(
            r["launches"] for r in fams.values()), fams
        enc = k["ctc_encoders"]
        if k["name"] == "fbank":
            assert enc["emformer"]["launches"] > 0 and \
                enc["cmvn"]["launches"] > 0 and \
                enc["wav2vec2"]["launches"] == 0, enc
        else:
            assert enc["launches"] == 0, enc
        for path in (k, k["serve"]):
            assert path["launches"] > 0, \
                f"{k['name']} never launched on a path"
            assert math.isfinite(path["ms"]) and path["ms"] > 0
    assert launches["lattice"] == 4 * TRAIN_STEPS and \
        launches["plain_lattice_trips"] == 0 and lattice["nan"] == 0, \
        launches
    kernels.append(dict(
        name="lattice", route="cuda",
        source="speech2text_torch/csrc/lattice.cu",
        replaces="none: speech2text_tpu/ops/rnnt.py:lattice_forward's "
                 "lax.scan",
        launches=launches["lattice"], launches_per_step=4,
        plain_lattice_trips=launches["plain_lattice_trips"],
        library_ms=None, ms=lattice["device_ms_per_step"],
        bound_ms=lattice["bound_ms_per_step"],
        bound_by="the chain of T+U-1 diagonals",
        plain_ms=lattice["plain"], worst=lattice["worst"],
        ranges_equal_share=min(r["equal_share"]
                               for r in lattice["ranges"].values()),
        backward_route="cuda",
        backward_source="speech2text_torch/csrc/lattice.cu"))
    report["kernels"] = kernels
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
