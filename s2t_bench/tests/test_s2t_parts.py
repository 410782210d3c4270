"""A configuration file names its reference and counts modules, and the
run finds them, and the cell's check limits, before any work: a second
configuration that names the flagship's modules runs to `correct`; a
cell of another model, added as new files and entries alone, passes
every check of BENCHMARK.json and is read through its own modules; one
that names a piece that is not there, or that its reference refuses,
fails before the program is built, with a message that names the piece;
the counts reached through the configuration's name are the flagship's
own, at the flagship's sizes."""

import importlib
import json
import shutil
import sys
import textwrap
import time

import pytest
import torch

import s2t_bench.bench as bench
import s2t_bench.cell as cell_mod
import s2t_bench.check as check_mod
import s2t_bench.counts as counts_pkg
import s2t_bench.reference as reference_pkg
import s2t_bench.tests.test_s2t_benchmark_json as benchmark_json
from s2t_bench import run as run_mod
from s2t_bench.bench import reader
from s2t_bench.cell import Missing, load_cell
from s2t_bench.counts import kernels, zipformer
from s2t_bench.counts.kernels import b2_least_s
from s2t_bench.counts.peaks import matmul_peak
from s2t_bench.reference import step
from s2t_bench.tests.test_s2t_metrics import trace_of, window
from s2t_bench.tests.tiny import ZIP, benchmark, tiny
from s2t_bench.weights import write_weights
from s2t_bench.workload import Traffic

CPU = torch.device("cpu")
TWIN = "zipformer_twin"
TWIN_CELL = "zipformer_twin.train_aishell1"


@pytest.fixture
def twin(tmp_path, monkeypatch):
    """Writes configs/zipformer_twin.json (the flagship's file under
    another name, with `changes` made) and the cell zipformer_twin's
    BENCHMARK.json entry and check limits, all in a temporary directory
    that the harness reads, and returns the cell's BENCHMARK.json."""
    configs, checks = tmp_path / "configs", tmp_path / "checks"
    configs.mkdir()
    checks.mkdir()
    monkeypatch.setattr(cell_mod, "CONFIGS", configs)
    monkeypatch.setattr(check_mod, "CHECKS_DIR", checks)
    b = benchmark()
    zip_cell = next(w for w in b["workloads"] if w["name"] == ZIP)
    b["workloads"].append(dict(zip_cell, name=TWIN_CELL, config=TWIN))
    bench_file = tmp_path / "BENCHMARK.json"
    bench_file.write_text(json.dumps(b))

    def write(changes=None, limits=True):
        meta = json.loads((cell_mod.PACKAGE / "configs"
                           / "zipformer_prnnt.json").read_text())
        meta["name"] = TWIN
        for key, value in (changes or {}).items():
            if value is None:
                meta.pop(key)
            else:
                meta[key] = value
        (configs / f"{TWIN}.json").write_text(json.dumps(meta))
        if limits:
            shutil.copy(cell_mod.PACKAGE / "checks" / f"{ZIP}.json",
                        checks / f"{TWIN_CELL}.json")
        return bench_file
    return write


def never_built(monkeypatch):
    built = []

    class Spy:
        def __init__(self, *args, **kw):
            built.append(args)
            raise AssertionError("the program was built")
    monkeypatch.setattr(bench, "Program", Spy)
    return built


def run(cell):
    return bench.run_cell(cell, 2 ** 31 + 77, 0.2, False, CPU,
                          time.perf_counter())


def test_second_configuration_runs_correct(twin):
    cell = tiny(load_cell(TWIN_CELL, twin()))
    assert cell.config_name == TWIN
    assert cell.reference() is step
    assert cell.part("counts") is zipformer
    r = run(cell)
    assert r["correct"] is True
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("changes,limits,named", [
    ({"reference": "nope"}, True, "s2t_bench/reference/nope.py"),
    ({"counts": "nope"}, True, "s2t_bench/counts/nope.py"),
    ({"reference": None}, True, f"configs/{TWIN}.json names no reference"),
    ({"counts": "frames"}, True, "s2t_bench/counts/frames.py defines no "
                                 "step_flops, b2_calls"),
    ({}, False, f"checks/{TWIN_CELL}.json"),
])
def test_missing_piece_fails_before_the_program(twin, monkeypatch, changes,
                                                limits, named):
    built = never_built(monkeypatch)
    cell = tiny(load_cell(TWIN_CELL, twin(changes, limits)))
    with pytest.raises(Missing, match=named.replace(".", r"\.")) as e:
        run(cell)
    assert built == []
    assert "\n" not in str(e.value)


REFUSED = [("task", {"type": "Ssl"}),
           ("encoder", {"model": "Conformer", "config": {}}),
           ("loss", {"enable_ctc": True}),
           ("optim_setup", {"optimizer": {"type": "AdamW"}})]


def refused(cfg, key, change):
    cfg = json.loads(json.dumps(cfg))
    cfg[key].update(change)
    return cfg


@pytest.mark.parametrize("key,change", REFUSED)
def test_refused_configuration_fails_before_the_program(twin, monkeypatch,
                                                        key, change):
    built = never_built(monkeypatch)
    cell = tiny(load_cell(TWIN_CELL, twin()))
    cell.meta["train_config"] = refused(cell.train_config, key, change)
    with pytest.raises(Missing, match="s2t_bench/reference/step.py "
                                      "refuses") as e:
        run(cell)
    assert built == []
    assert "\n" not in str(e.value)


@pytest.mark.parametrize("key,change", REFUSED + [
    ("dataset", {"feat_config": {"dither": 0.1}}),
    ("predictor", {"model": "Lstm"})])
def test_check_config_raises_where_the_trainer_does(key, change):
    cfg = refused(tiny(load_cell(ZIP)).train_config, key, change)
    with pytest.raises(ValueError) as want:
        step.ReferenceTrainer(cfg, 1, CPU, lambda m: write_weights(m, 1))
    with pytest.raises(ValueError) as got:
        step.check_config(cfg)
    assert str(got.value) == str(want.value)


def test_flagship_config_is_taken():
    step.check_config(load_cell(ZIP).train_config)
    step.check_config(tiny(load_cell(ZIP)).train_config)


def test_command_names_the_missing_piece(twin, monkeypatch, capsys):
    monkeypatch.setattr(cell_mod, "BENCHMARK", twin({"reference": "nope"}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "USE_FLAX"):
        monkeypatch.setenv(var, "")
    built = never_built(monkeypatch)
    rc = run_mod.main(["--workload", TWIN_CELL, "--seed", "1", "--seconds",
                       "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 4 and out.out == "" and built == []
    assert out.err.count("\n") == 1
    assert "s2t_bench/reference/nope.py" in out.err


def test_dispatch_gives_the_flagship_counts():
    cell = load_cell(ZIP)
    counts = cell.part("counts")
    cfg = cell.train_config
    traffic = Traffic(cell.traffic, cell.traffic_spec,
                      cfg["dataset"]["bucket_sampler_config"])
    noise_len = int(traffic.noise_samples.max())
    assert len(traffic.buckets) == 8
    for s in traffic.buckets:
        B, P, L = s.batch_size, s.pcm_len, s.label_len
        assert counts.step_flops(cfg, B, P, L) == \
            3.0 * zipformer.rnnt_forward_flops(cfg, B, P, L)
        assert counts.b2_calls(cfg, B, P, noise_len) == \
            kernels.b2_calls(cfg, B, P, noise_len)


@pytest.mark.parametrize("key,value,named", [
    ("vocab", [1, 4336], r"\[1, 4335\]"),
    ("vocab", [0, 100], r"\[0, 100\]"),
    ("num_symbols", 4000, "4000 symbols"),
])
def test_mix_outside_the_vocabulary_fails_before_the_program(
        twin, monkeypatch, key, value, named):
    built = never_built(monkeypatch)
    cell = load_cell(TWIN_CELL, twin())
    if key == "vocab":
        cell.traffic_spec = dict(cell.traffic_spec, vocab=value)
    else:
        cell.meta["train_config"]["predictor"]["config"][key] = value
    with pytest.raises(Missing, match="s2t_bench/reference/step.py refuses "
                                      "s2t_bench/traffic/aishell1_train"
                                      r"\.json: ValueError: .*" + named):
        run(cell)
    assert built == []


# A model unlike the flagship, with no predictor and no joiner, as a
# later PR would add it: its configuration file, reference and counts
# modules, check limits, and entries in BENCHMARK.json.
OTHER = "stub_ssl"
OTHER_CELL = "stub_ssl.pretrain_libri960"
OTHER_REFERENCE = """
    def check_config(config):
        if config["task"]["type"] != "Ssl":
            raise ValueError("the stub trains SSL only")

    def check_traffic(config, traffic):
        pass                       # pretraining reads no labels

    class ReferenceTrainer:
        def __init__(self, config, seed, device, write_weights):
            raise AssertionError("not run here")
"""
OTHER_COUNTS = """
    def step_flops(config, batch, pcm_len, label_len):
        return 3.0 * 2 * batch * pcm_len * config["encoder"]["config"]["d"]

    def b2_calls(config, batch, pcm_len, noise_len):
        return [(batch, pcm_len), (batch, pcm_len), (batch, noise_len)]
"""
OTHER_METRICS = ("train_mfu_pct", "device_idle_pct", "peak_mem_gib",
                 "backward_device_ms", "optimizer_device_ms",
                 "featurize_device_ms", "b2_roofline_pct")


@pytest.fixture
def other_model(tmp_path, monkeypatch):
    """A copy of the benchmark's data (BENCHMARK.json, configs, traffic,
    checks, metrics) in a temporary tree, with the cell OTHER_CELL added
    as new files and entries alone; the harness and the checks of
    BENCHMARK.json read that tree. Returns the cell."""
    pkg = tmp_path / "s2t_bench"
    for sub in ("configs", "traffic", "checks", "metrics"):
        shutil.copytree(cell_mod.PACKAGE / sub, pkg / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for sub, text in (("reference", OTHER_REFERENCE),
                      ("counts", OTHER_COUNTS)):
        (pkg / sub).mkdir()
        (pkg / sub / f"{OTHER}.py").write_text(textwrap.dedent(text))
    source = "https://arxiv.org/abs/2202.01855"
    (pkg / "configs" / f"{OTHER}.json").write_text(json.dumps({
        "name": OTHER, "source": source, "reduced": {},
        "reference": OTHER, "counts": OTHER, "peak_dtype": "bfloat16",
        "float32_matmul_precision": "highest",
        "train_config": {"task": {"type": "Ssl"},
                         "encoder": {"model": "Conformer",
                                     "config": {"d": 1024}},
                         "dataset": {"bucket_sampler_config": {}}}}))
    shutil.copy(cell_mod.PACKAGE / "checks" / f"{ZIP}.json",
                pkg / "checks" / f"{OTHER_CELL}.json")
    b = benchmark()
    b["configs"].append({"name": OTHER, "source": source,
                         "file": f"s2t_bench/configs/{OTHER}.json",
                         "reduced": [], "why": "a model with no joiner"})
    b["workloads"].append({"name": OTHER_CELL, "config": OTHER,
                           "traffic": "libri960_train", "chips": 1,
                           "why": "pretraining, no labels"})
    for m in b["per_layer"]:
        if m["name"] in OTHER_METRICS:
            m["workloads"].append(OTHER_CELL)
    b["end_to_end"] = [dict(m, workloads=m["workloads"] + [OTHER_CELL])
                       if "workloads" in m else m for m in b["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    for name, value in (("BENCHMARK", tmp_path / "BENCHMARK.json"),
                        ("CONFIGS", pkg / "configs"),
                        ("TRAFFIC", pkg / "traffic")):
        monkeypatch.setattr(cell_mod, name, value)
    monkeypatch.setattr(check_mod, "CHECKS_DIR", pkg / "checks")
    for name, value in (("PACKAGE", pkg), ("ROOT", tmp_path),
                        ("benchmark", lambda: json.loads(
                            (tmp_path / "BENCHMARK.json").read_text()))):
        monkeypatch.setattr(benchmark_json, name, value)
    for package, sub in ((reference_pkg, "reference"),
                         (counts_pkg, "counts")):
        monkeypatch.setattr(package, "__path__",
                            list(package.__path__) + [str(pkg / sub)])
    importlib.invalidate_caches()
    yield load_cell(OTHER_CELL)
    for package in (reference_pkg, counts_pkg):
        sys.modules.pop(f"{package.__name__}.{OTHER}", None)
        if hasattr(package, OTHER):
            delattr(package, OTHER)


def test_cell_of_another_model_needs_no_edit(other_model):
    """Every check of BENCHMARK.json passes with the other model's cell in
    it, and the harness reads that cell through its own modules."""
    checks = [f for n, f in vars(benchmark_json).items()
              if n.startswith("test_")]
    assert len(checks) >= 7
    for check in checks:
        check()
    cell = other_model
    assert cell.reference().__name__ == f"s2t_bench.reference.{OTHER}"
    counts = cell.part("counts")
    assert counts.__name__ == f"s2t_bench.counts.{OTHER}"
    w = window(cell, trace_of([("fbank_fft_kernel", 0, 2_000_000, None)],
                              {}))
    flops = 2 * counts.step_flops(cell.train_config, 4, 48000, 16)
    peak = matmul_peak("bfloat16", "highest")
    assert reader("train_mfu_pct")(w) == 100.0 * flops / 0.1 / peak
    least = [b2_least_s(B, N) for _ in range(2)
             for B, N in counts.b2_calls(None, 4, 48000, 16000)]
    assert reader("b2_roofline_pct")(w) == \
        100.0 * (sum(least) / len(least)) / 2e-3
    assert {m["name"] for m in cell.metrics(True)} == set(OTHER_METRICS)
