#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (speech2text_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     no CUDA device → exit 1 with no result;
  2. build both CUDA kernels from speech2text_torch/csrc (nvcc, sm_90a);
  3. attention-weights kernel vs its plain version at every flagship stack
     shape for B=16 and 10 s, bf16 and f32, mask None / ragged pad / chunk;
  4. fbank kernel vs its plain version at B=16, ragged 2-10 s, N % 160 != 0;
  5. serve the flagship (configs/inference/pruned_rnnt_greedy_search.yaml,
     seeded random weights, bf16): 3 requests of B=16 int16 PCM, with one
     attention-weights launch per layer (12) and 1 fbank launch per
     request; then one f32 request (B=2, 3 s) on the card against the
     same module on the CPU;
  6. timings (CUDA events, medians) beside each kernel's bound.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

import json
import math
import os
import statistics
import subprocess
import sys
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
ENC_TOL = dict(rtol=1e-3, atol=1e-3)
CFG = "configs/inference/pruned_rnnt_greedy_search.yaml"


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def log(msg, card=None):
    print(msg + (f"  [{card}]" if card else ""), flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Median of per-call times on CUDA events, ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_close(name, got, want, rtol, atol):
    diff = (got.float() - want.float()).abs()
    bad = diff > atol + rtol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of "
                             f"tolerance, max abs err {float(diff.max())}")
    return float(diff.max())


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


def stack_shapes(cfg, n_samples):
    from speech2text_torch.data.frontend import FbankConfig
    frames = FbankConfig().num_frames(n_samples)
    T0 = ((frames - 2 - 3) // 2 + 1) - 2
    return [(-(-T0 // ds), H) for ds, H in zip(cfg["downsampling_factor"],
                                               cfg["num_heads"])]


def phase_attn(enc_cfg, card, report):
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops.masking import chunk_causal_mask
    qd, pd = enc_cfg["query_head_dim"], enc_cfg["pos_head_dim"]
    shapes = stack_shapes(enc_cfg, 10 * SR)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    errs = {}
    timing = {}
    for T, H in sorted(set(shapes)):
        B = B_SERVE
        lens = torch.as_tensor(rng.integers(T // 5, T + 1, B))
        lens[0] = T
        pad = torch.arange(T)[None] < lens[:, None]
        pad_mask = (pad[:, None, :] & pad[:, :, None]).cuda()
        chunk_mask = (pad_mask & chunk_causal_mask(T, 16, 4,
                                                   device="cuda")[None])
        for dt in (torch.bfloat16, torch.float32):
            q, k = (torch.randn((B, T, H, qd), generator=gen, device="cuda")
                    .to(dt) for _ in range(2))
            qp = torch.randn((B, T, H, pd), generator=gen,
                             device="cuda").to(dt)
            p = torch.randn((2 * T - 1, H, pd), generator=gen,
                            device="cuda").to(dt)
            for mname, mask in (("none", None), ("pad", pad_mask),
                                ("chunk16/4", chunk_mask)):
                got = aw.attn_weights_cuda(q, k, qp, p, mask, dt)
                e = check_weights(f"attn_weights T={T} H={H} {dt} {mname}",
                                  got, q, k, qp, p, mask, dt)
                errs[(T, H, str(dt), mname)] = e
                if mname == "pad":
                    k_ms = time_ms(lambda: aw.attn_weights_cuda(
                        q, k, qp, p, mask, dt))
                    p_ms = time_ms(lambda: aw.attn_weights_plain(
                        q, k, qp, p, mask, dt), iters=10)
                    bound, by = attn_bound_ms(B, T, H, qd, pd, dt, dt, True)
                    timing[(T, H, dt)] = (k_ms, p_ms, bound, by)
                    log(f"attn_weights B={B} T={T} H={H} {str(dt)[6:]} pad "
                        f"mask: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                        f"bound {bound:.4f} ms ({by}), max abs err {e:.3g}",
                        card)
    # a 30 s utterance: stack 0's T no longer fits 32 score rows in shared
    # memory, so the kernel takes smaller query tiles
    T, H = stack_shapes(enc_cfg, 30 * SR)[0]
    q, k = (torch.randn((2, T, H, qd), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    qp = torch.randn((2, T, H, pd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    p = torch.randn((2 * T - 1, H, pd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    pad = torch.arange(T, device="cuda")[None] < torch.tensor(
        [[T], [T // 3]], device="cuda")
    mask = pad[:, None, :] & pad[:, :, None]
    errs[(T, H, "torch.bfloat16", "pad, 30 s")] = check_weights(
        f"attn_weights T={T} H={H} bf16 pad (30 s)",
        aw.attn_weights_cuda(q, k, qp, p, mask, torch.bfloat16),
        q, k, qp, p, mask, torch.bfloat16)
    report["attn_weights_checks"] = {"/".join(map(str, k)): v
                                     for k, v in errs.items()}
    # the main path: one launch per layer, bf16, pad mask
    per_req = [timing[(T, H, torch.bfloat16)]
               for (T, H), n in zip(shapes, enc_cfg["num_encoder_layers"])
               for _ in range(n)]
    summary = {
        "ms": sum(t[0] for t in per_req),
        "plain_ms": sum(t[1] for t in per_req),
        "bound_ms": sum(t[2] for t in per_req),
        "bound_by": ("bytes" if sum(t[2] for t in per_req if t[3] == "bytes")
                     >= sum(t[2] for t in per_req) / 2 else "operations"),
        "max_abs_err": max(errs.values()),
    }
    log(f"attn_weights per request ({len(per_req)} launches, B=16, 10 s, "
        f"bf16): kernel "
        f"{summary['ms']:.4f} ms, plain {summary['plain_ms']:.4f} ms, bound "
        f"{summary['bound_ms']:.4f} ms ({summary['bound_by']})", card)
    return summary


# ------------------------------------------------------------ phase 4: B2
def phase_fbank(card, report):
    from speech2text_torch.data.frontend import Fbank
    from speech2text_torch.ops import fbank as fb
    rng = np.random.default_rng(SEED + 1)
    N = 10 * SR + 77                        # N % 160 != 0
    lens = ragged_lengths(rng, B_SERVE, 2, 10, N)
    pcm = (0.2 * rng.standard_normal((B_SERVE, N))).astype(np.float32)
    pcm[np.arange(N)[None] >= lens[:, None]] = 0.0
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
    k_ms = time_ms(lambda: fb.fbank_cuda(x, *ops, T, **kw))
    p_ms = time_ms(lambda: fb.fbank_plain(x, *ops, T, **kw))
    flen, n_bins, n_mels = cfg.frame_length, ops[1].shape[1], \
        cfg.num_mel_bins
    nbytes = 4 * (B_SERVE * N + B_SERVE * T * n_mels + flen
                  + 2 * flen * n_bins + n_mels * n_bins)
    flops = B_SERVE * T * (4 * flen * n_bins + 2 * n_bins * n_mels)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    summary = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "max_abs_err": err}
    log(f"fbank B={B_SERVE} N={N} frames={T}: kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, bound {summary['bound_ms']:.4f} ms "
        f"({summary['bound_by']}, {flops / 1e9:.3f} GFLOP f32), max abs err "
        f"{err:.3g}", card)
    report["fbank"] = summary
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


def phase_breakdown(server, reqs, card, report):
    """Where a request's time goes: featurize / encode / decode on the
    host clock (synchronised), and one profiled request's device time."""
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
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    if busy > 0:
        log(f"profiled request: wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms ({100 * busy / wall:.1f}%), "
            f"{sum(r[2] for r in rows)} device ops", card)
        for key, ms, n in rows[:8]:
            log(f"  {ms:8.3f} ms  x{n:<5d} {key[:90]}", card)
    else:
        log("profiled request: device time not measured (no CUDA events "
            "in the trace)", card)
    report["breakdown"] = {"median_ms": med, "profiled_wall_ms": wall,
                           "device_busy_ms": busy,
                           "top_device_ops": rows[:20]}


def phase_serve(card, report):
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
    phase_breakdown(server, reqs, card, report)
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from speech2text_torch.config import load_config
    from speech2text_torch.ops import attn_weights as aw
    from speech2text_torch.ops import build
    from speech2text_torch.ops import fbank as fb
    from speech2text_torch.serve import serving_train_config

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.build([aw.KERNEL, fb.KERNEL])
    aw.KERNEL.lib()
    fb.KERNEL.lib()
    log(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for k in (aw.KERNEL, fb.KERNEL):
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {k.name}: {line.strip()}")

    report = {"card": card}
    enc_cfg = serving_train_config(load_config(CFG))["encoder"]["config"]
    attn = phase_attn(enc_cfg, card, report)
    fbank = phase_fbank(card, report)
    launches = phase_serve(card, report)

    kernels = [
        dict(name="attn_weights", route="cuda",
             source="speech2text_torch/csrc/attn_weights.cu",
             replaces="speech2text_tpu/ops/pallas/flash_attn.py:79",
             launches=launches["attn_weights"], library_ms=None,
             **{k: attn[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by")}),
        dict(name="fbank", route="cuda",
             source="speech2text_torch/csrc/fbank.cu",
             replaces="speech2text_tpu/ops/pallas/fbank_kernel.py:86",
             launches=launches["fbank"], library_ms=None,
             **{k: fbank[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by")}),
    ]
    for k in kernels:
        assert k["launches"] > 0, f"{k['name']} never launched on the path"
        assert math.isfinite(k["ms"]) and k["ms"] > 0
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
    sys.exit(main())
