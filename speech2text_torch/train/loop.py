"""The training loop (port of speech2text_tpu/train/loop.py:Trainer).

`Trainer(task, config, workdir, seed, device)` trains a task (a
transducer task of tasks/rnnt.py, `CtcTask`, `CifTask`, `SslTask` or
`NnLmTask`) on one device: `cuda` unless the caller passes
`device="cpu"` or the YAML sets `trainer.platform: cpu`; with no CUDA
device and no such request it raises. `fit` takes steps until
`max_steps` (or `max_epochs` epochs of the bucketed pipeline), evaluates
and checkpoints every `val_check_interval` (a fraction of an epoch, or
steps when > 1) and at the last step, and resumes from the latest
checkpoint of `workdir/checkpoints` (or of `resume`) with the pipeline
fast-forwarded to the restored step. Checkpoints are ranked by the
YAML's `monitor` and `mode` (`wer`, `min` for the ASR tasks; `acc`,
`max` for SSL and NNLM). The task owns its step:
`task.step_losses(batch, step, generators)` featurizes (once, twice for
SSL, not at all for NNLM) and returns the losses closure that
train/step.py:take_step runs. The global step (0-based, the restored one
after a resume) goes into the task's training losses, where the
Zipformer2's training dynamics read their schedules. A converted
pretrained encoder (`encoder.config.pretrained_path`) is loaded over the
seeded init by the task's `init_weights` (tasks/base.py).

Gradient accumulation (`trainer.accumulate_grad_batches` k > 1), as the
JAX loop's optax.MultiSteps: the optimizer (with the clipping) is
wrapped in optim/setup.py:MultiSteps, which averages the gradients of k
micro-batches and updates once, so the optimizer's count and schedule
advance once per k; the global step the task reads and the logged lr are
step // k, while `max_steps`, `val_check_interval` and the logged `step`
count micro-batches (an epoch-based `max_steps` or fractional interval is
k times the batches).

The host-RSS watchdog (`trainer.max_rss_gb` > 0, the JAX loop's): every
`log_interval` steps, when the process's current resident set exceeds
`max_rss_gb` GB, the loop checkpoints the step (with the last
evaluation's metrics), flushes its logs and then, with `rss_restart`
(the default), replaces the process by a fresh one with the same command
line (`os.execv` of `restart_argv()`), which resumes from that
checkpoint; without it `fit` returns.

Per-step randomness comes from generators seeded from (seed, step,
stream), as the JAX loop folds the step into its key: augmentation and
dropout on the device, the chunk choice on the host; so a resumed run
takes the same steps as one that was never stopped.

No step reads a value back from the card: losses and `grad_norm` stay on
the device and are read every `log_interval` steps, when a line with the
JAX loop's keys (step, loss, lr, utts_per_sec, frames_per_sec, the
task's losses and metrics (train_loss; simple_loss, pruned_loss and
ctc_loss for the pruned task; acc and mask_rate for SSL), grad_norm: the
norm before clipping) and the mean data wait of the interval
(data_wait_ms) goes to `metrics.jsonl` and TensorBoard.
Batches arrive in pinned host memory (on `cuda`) and are copied without
blocking. `next(train_iter)` is the span "data" (utils/tracing.py),
and `history` keeps per step the host clock at its end, its data wait
and the seconds of an evaluation after it.

Multi-GPU (parallel/mesh.py): launched by torchrun, one process per
GPU, the Trainer trains data-parallel over the ranks, as the JAX loop
trains over its mesh's `data` axis. `trainer.mesh.data` is the number of
ranks (-1, the default, or the world size; another number raises, and
`model` > 1 raises NotImplementedError). The model is replicated under
DistributedDataParallel, or with `trainer.fsdp` sharded by FSDP2 (the
parameters and the optimizer state). Every rank takes its slice of each
global batch (batch sizes rounded up to a multiple of the world size,
`batch_multiple`), so a step sees the global batch of a single process;
the loss terms that divide by a count divide by the global one, and the
training dynamics' regularizers take their statistics over the global
batch. Augmentation and dropout are drawn per rank (the rank folded into
their seeds; with one process, the seeds of before), the chunk choice
on every rank alike, as JAX makes one choice per global step. Rank 0
alone writes `metrics.jsonl`, TensorBoard and the checkpoints (whole
tensors, the same file at any world size, after the other ranks have
given it their shards), and every rank waits for the write; a resume
restores on every rank. The logged losses and metrics are the means over
the ranks and the counters count the global batch. Evaluation is sharded
over the ranks and combined: the mean losses over the ranks, the WER of
everyone's edits. The watchdog decides on the largest resident set of
the ranks, so all of them checkpoint and exit or exec-restart together
(the restarted ranks make a new group from the same environment).
"""

from __future__ import annotations

import json
import os
import resource
import sys
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import parallel
from ..decoding import reference_decoder
from ..metrics import AsrMetric
from ..optim import MultiSteps, OptimSetup
from ..utils.logging import get_logger
from ..utils.tracing import span
from .checkpoint import CheckpointManager
from .step import clip_value, take_step
from .tb_writer import TensorBoardWriter

log = get_logger(__name__)

STREAM_AUGMENT, STREAM_DROPOUT, STREAM_CHUNK = 0, 1, 2


def step_seed(seed: int, step: int, stream: int,
              rank: Optional[int] = None) -> int:
    """A 63-bit seed that is a function of (seed, step, stream) and, when
    given, the rank."""
    key = (seed, step, stream) + (() if rank is None else (rank,))
    state = np.random.SeedSequence(key).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def resolve_device(device: Union[str, torch.device, None],
                   trainer_config: Dict[str, Any]) -> torch.device:
    """The explicit `device`, else the YAML's `trainer.platform`, else
    `cuda`; raises for `cuda` without a CUDA device."""
    dev = torch.device(device or trainer_config.get("platform") or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu "
                           "or trainer.platform: cpu) to train on the CPU")
    return dev


def rss_gb() -> float:
    """The process's current resident set in GB (/proc/self/statm), or,
    where /proc is absent, its peak (ru_maxrss)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * resource.getpagesize() / 1e9
    except (OSError, ValueError, IndexError):
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def restart_argv() -> List[str]:
    """This process's command line: `python -m <module> args` when it runs
    a module (the argv[0] of `-m` is the module's file, which does not
    run as a script), else `python argv`."""
    spec = getattr(sys.modules.get("__main__"), "__spec__", None)
    if spec is not None and spec.name:
        return [sys.executable, "-m", spec.name] + sys.argv[1:]
    return [sys.executable] + sys.argv


def _merge_state(model: torch.nn.Module,
                 loaded: Dict[str, torch.Tensor]) -> int:
    """Non-strict finetune load: copy the entries of `loaded` whose name
    and shape match, keep the fresh weights elsewhere; returns how many
    were copied."""
    n = 0
    with torch.no_grad():
        for name, t in model.state_dict().items():
            cand = loaded.get(name)
            if cand is not None and tuple(cand.shape) == tuple(t.shape):
                t.copy_(cand)
                n += 1
    return n


class Trainer:

    def __init__(self, task, config: Dict[str, Any], workdir: str,
                 seed: int = 17,
                 device: Union[str, torch.device, None] = None):
        tcfg = config.get("trainer") or {}
        self.device = parallel.setup(resolve_device(device, tcfg))
        mcfg = tcfg.get("mesh") or {}
        self.mesh = parallel.make_mesh(parallel.MeshConfig(
            data=int(mcfg.get("data", -1)), model=int(mcfg.get("model", 1))))
        self.fsdp = bool(tcfg.get("fsdp", False))
        self.task = task
        self.config = config
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.seed = seed
        self.clip = clip_value(config)
        self.accum = int(tcfg.get("accumulate_grad_batches", 1) or 1)
        if task.init_weights(torch.Generator().manual_seed(seed)):
            log.info("pretrained encoder loaded from %s",
                     config["encoder"]["config"]["pretrained_path"])
        task.to(self.device)
        # the bare model (state dicts, the optimizer's parameters); the
        # task's `model` becomes the data-parallel one in init_state
        self.model = task.model
        self._wrapped = False
        self.optimizer = None
        self.schedule = None
        self.max_epochs = tcfg.get("max_epochs")
        self.max_steps = tcfg.get("max_steps")
        self.val_check_interval = tcfg.get("val_check_interval", 1.0)
        self.log_interval = int(tcfg.get("log_interval", 50))
        self.max_rss_gb = float(tcfg.get("max_rss_gb", 0) or 0)
        self.rss_restart = bool(tcfg.get("rss_restart", True))
        ck = (config.get("callbacks") or {}).get("model_chkpt_config") or {}
        self.ckpt = CheckpointManager(
            os.path.join(workdir, "checkpoints"),
            save_top_k=int(ck.get("save_top_k", 10)),
            monitor=ck.get("monitor", "wer"), mode=ck.get("mode", "min"))
        self._saved_step = self.ckpt.latest_step()
        self._metrics_file = self._tb = None
        if parallel.is_main():
            self._metrics_file = open(os.path.join(workdir, "metrics.jsonl"),
                                      "a")
            self._tb = TensorBoardWriter(os.path.join(workdir, "tb"))
        self._gens = (torch.Generator(self.device),
                      torch.Generator(self.device), torch.Generator())
        self._pin = self.device.type == "cuda"
        self.history: List[Dict[str, float]] = []
        self.last_eval: Dict[str, float] = {}
        self.finetune_copied = 0

    def close(self) -> None:
        if self._metrics_file is not None:
            self._metrics_file.close()
            self._tb.close()

    # ------------------------------------------------------------- state
    def init_state(self, resume: Optional[str] = None,
                   finetune_state: Optional[Dict[str, torch.Tensor]] = None
                   ) -> int:
        """Finetune weights merged over the seeded init, the model
        wrapped for the ranks (parallel.wrap_model), the optimizer built
        on it, then the latest checkpoint of `resume` (a checkpoint
        directory) or of this run restored over both; returns the step to
        start from."""
        model = self.model
        if finetune_state is not None:
            self.finetune_copied = _merge_state(model, finetune_state)
            log.info("loaded finetune base weights: %d of the base's %d "
                     "tensors copied", self.finetune_copied,
                     len(finetune_state))
        if not self._wrapped:
            self.task.model = parallel.wrap_model(model, self.mesh,
                                                  self.fsdp)
            self._wrapped = True
        self.optimizer, self.schedule = OptimSetup(
            self.config["optim_setup"], model.named_parameters())
        self.step_clip = self.clip
        if self.accum > 1:
            # the clipping moves into MultiSteps: it clips the mean of the
            # k micro-batches' gradients
            self.optimizer = MultiSteps(self.optimizer, self.accum,
                                        model.parameters(), self.clip)
            self.step_clip = None
        restored = None
        if resume:
            mgr = self.ckpt if os.path.abspath(resume) == \
                self.ckpt.directory else CheckpointManager(resume)
            restored = mgr.restore_latest()
        elif self.ckpt.latest_step() is not None:
            restored = self.ckpt.restore_latest()
        if restored is None:
            return 0
        step, state = restored
        if int(state.get("seed", self.seed)) != self.seed:
            log.warning("checkpoint of seed %s resumed with seed %d: the "
                        "steps after it differ from the original run's",
                        state.get("seed"), self.seed)
        parallel.load_full_state(model, state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        return int(step)

    def save(self, step: int, metrics: Dict[str, float]) -> None:
        """Checkpoint `step`: copied to the host (whole tensors: under
        FSDP every rank gives its shards), written by rank 0; every rank
        returns once it is written."""
        if parallel.is_main() or self.fsdp:
            state = {"model": parallel.full_state(self.model),
                     "optimizer": self.optimizer.state_dict(),
                     "step": step, "seed": self.seed}
            if parallel.is_main():
                self.ckpt.save(step, state, metrics=dict(metrics))
        parallel.barrier()
        self._saved_step = step

    # -------------------------------------------------------------- step
    def to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The batch's arrays as tensors on the device (copied without
        blocking from pinned memory); lists of strings stay."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(v)
            if isinstance(v, torch.Tensor):
                v = v.to(self.device, non_blocking=True)
            out[k] = v
        return out

    def generators(self, step: int
                   ) -> Tuple[torch.Generator, torch.Generator,
                              torch.Generator]:
        """The step's augmentation, dropout (device) and chunk (host)
        generators; with several ranks the first two are the rank's own
        and the chunk generator is every rank's."""
        rank = self.mesh.rank if self.mesh.data > 1 else None
        for g, stream in zip(self._gens, (STREAM_AUGMENT, STREAM_DROPOUT,
                                          STREAM_CHUNK)):
            g.manual_seed(step_seed(self.seed, step, stream,
                                    None if stream == STREAM_CHUNK else rank))
        return self._gens

    def train_step(self, batch: Dict[str, Any], step: int
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a device batch: the task's
        `step_losses` (featurize and the losses closure, drawing from the
        step's generators), then train/step.py:take_step with the
        config's clipping. Returns the step's metrics (train_loss, the
        task's other losses and metrics, grad_norm, frames) as 0-d
        tensors on the device. `step` is the micro-batch (0-based); the
        training dynamics read the global step, step // accumulation."""
        task = self.task
        metrics = take_step(
            task.model, task.step_losses(batch, step // self.accum,
                                         self.generators(step)),
            self.optimizer, self.step_clip)
        metrics["train_loss"] = metrics.pop("loss")
        return metrics

    # --------------------------------------------------------------- fit
    def fit(self, resume: Optional[str] = None,
            finetune_state: Optional[Dict[str, torch.Tensor]] = None,
            max_steps: Optional[int] = None) -> Dict[str, float]:
        task = self.task
        # every rank's slice of one global batch (JAX's loop.py:125)
        task.data_config.batch_multiple = self.mesh.data
        train_pipe = task.make_train_pipeline(self.mesh.rank, self.mesh.data,
                                              seed=self.seed,
                                              pin_memory=self._pin)
        steps_per_epoch = max(train_pipe.batches_per_epoch(), 1)
        if max_steps is None:
            max_steps = self.max_steps
        if max_steps is None:
            max_steps = steps_per_epoch * (self.max_epochs or 1) * self.accum
        if self.val_check_interval and self.val_check_interval <= 1.0:
            val_every = max(int(steps_per_epoch * self.accum
                                * self.val_check_interval), 1)
        else:
            val_every = int(self.val_check_interval)

        step = self.init_state(resume, finetune_state)
        if step:
            train_pipe.skip_batches(step)
            log.info("data pipeline fast-forwarded to batch %d", step)
        log.info("training: %d steps (%d/epoch, accum %d) on %s, rank %d "
                 "of %d%s", max_steps, steps_per_epoch, self.accum,
                 self.device, self.mesh.rank, self.mesh.data,
                 ", fsdp" if self.fsdp and parallel.active() else "")
        t_last = time.time()
        utts, units, waits = 0, [], []
        metrics: Dict[str, torch.Tensor] = {}
        train_iter = iter(train_pipe)
        try:
            while step < max_steps:
                t0 = time.perf_counter()
                with span("data"):
                    batch = next(train_iter)
                wait = time.perf_counter() - t0
                waits.append(wait)
                n_utts, n_units = self._counts(batch)
                utts += n_utts
                units.append(n_units)
                metrics = self.train_step(self.to_device(batch), step)
                step += 1
                rec = {"step": step, "end": time.perf_counter(),
                       "data_wait_s": wait, "eval_s": 0.0}
                if step % self.log_interval == 0:
                    self._log(step, metrics, utts, units, waits,
                              time.time() - t_last)
                    t_last, utts, units, waits = time.time(), 0, [], []
                if step % val_every == 0 or step == max_steps:
                    t0 = time.perf_counter()
                    self.last_eval = self.evaluate()
                    self.save(step, self.last_eval)
                    rec["eval_s"] = time.perf_counter() - t0
                self.history.append(rec)
                if self.max_rss_gb and step % self.log_interval == 0:
                    rss = parallel.all_reduce_max(rss_gb())
                    if rss > self.max_rss_gb:
                        self._rss_exit(step, rss)
                        return self.last_eval
        finally:
            train_iter.close()
        return self.last_eval

    def _counts(self, batch: Dict[str, Any]) -> Tuple[int, int]:
        """The loop's counters of a host batch: (utterances, PCM samples),
        or for a text batch (rows, tokens)."""
        lens = batch["pcm_length"] if "pcm_length" in batch \
            else batch["text_length"]
        return len(lens), int(np.asarray(lens, np.int64).sum())

    def _frames(self, units: List[int]) -> int:
        """The frames of steps of `units` (global batches), as JAX's loop
        counts them: each step's samples over the frontend's hop (160 for
        the PCM frontend), rounded down; a text batch's tokens."""
        frontend = getattr(self.task, "frontend", None)
        if frontend is None:
            return sum(units)
        hop = getattr(getattr(frontend, "cfg", None), "frame_shift", 160)
        return sum(u // hop for u in units)

    def _rss_exit(self, step: int, rss: float) -> None:
        """The watchdog's way out at `step` (every rank together, `rss`
        the largest resident set of the ranks): checkpoint, flush, then
        exec the same command line (`rss_restart`) or return."""
        log.warning("host RSS %.1f GB > max_rss_gb %.1f at step %d: "
                    "checkpointing and %s", rss, self.max_rss_gb, step,
                    "exec-restarting" if self.rss_restart else "exiting")
        if self._saved_step != step:
            self.save(step, self.last_eval)
        if self._metrics_file is not None:
            self._metrics_file.flush()
            self._tb.flush()
        if self.rss_restart:
            parallel.prepare_restart()
            sys.stdout.flush()
            sys.stderr.flush()
            argv = restart_argv()
            os.execv(argv[0], argv)

    def _log(self, step: int, metrics: Dict[str, torch.Tensor], utts: int,
             units: List[int], waits: List[float], dt: float) -> None:
        host = {k: float(v) for k, v in metrics.items() if k != "frames"}
        if self.mesh.data > 1:
            # the means over the ranks (global-batch values); the counters
            # summed over the ranks step by step
            keys = sorted(host)
            dev = metrics[keys[0]].device
            vals = parallel.all_reduce_sum(torch.cat([
                torch.stack([metrics[k].detach().double() for k in keys]),
                torch.tensor([utts] + units, dtype=torch.float64,
                             device=dev)])).tolist()
            host = {k: v / self.mesh.data for k, v in zip(keys, vals)}
            utts = int(vals[len(keys)])
            units = [int(u) for u in vals[len(keys) + 1:]]
        if not parallel.is_main():
            return
        frames = self._frames(units)
        rec = {"step": step, "loss": host.get("train_loss", 0.0),
               "lr": float(self.schedule(step // self.accum)),
               "utts_per_sec": utts / dt, "frames_per_sec": frames / dt,
               **host,
               "data_wait_ms": 1e3 * sum(waits) / max(len(waits), 1)}
        log.info(" ".join(f"{k}={v:.5g}" if isinstance(v, float)
                          else f"{k}={v}" for k, v in rec.items()))
        self._metrics_file.write(json.dumps(rec) + "\n")
        self._metrics_file.flush()
        for k, v in rec.items():
            if k != "step":
                self._tb.add_scalar(f"train/{k}", v, step)
        self._tb.flush()

    # ---------------------------------------------------------- evaluate
    def evaluate(self) -> Dict[str, float]:
        """Validation losses and metrics (the mean over eval batches) and,
        for a task that decodes, the WER of its decoder, over one epoch
        of the eval pipeline; with several ranks, each takes its slice of
        every batch, the means are averaged over the ranks and the WER is
        of all their edits (a global-batch evaluation, as JAX's)."""
        task = self.task
        pipe = task.make_eval_pipeline(self.mesh.rank, self.mesh.data,
                                       pin_memory=self._pin)
        metric = AsrMetric()
        scalars: Dict[str, list] = {}
        with parallel.gathered(self.model):
            for batch in pipe:
                arrays = {k: v for k, v in batch.items()
                          if not isinstance(v, list)}
                out = task.eval_forward(self.to_device(arrays))
                for k, v in out.items():
                    if v.ndim == 0:
                        scalars.setdefault(k, []).append(float(v))
                hyps = task.eval_hyps(out)
                if hyps:
                    refs = reference_decoder(
                        np.asarray(batch["label"]),
                        np.asarray(batch["label_length"]), task.tokenizer)
                    metric.update(hyps, refs)
        result = {k: float(np.mean(v)) for k, v in scalars.items()}
        if self.mesh.data > 1:
            keys = sorted(result)
            vals = parallel.all_reduce_sum(torch.tensor(
                [result[k] for k in keys], dtype=torch.float64)).tolist()
            result = {k: v / self.mesh.data for k, v in zip(keys, vals)}
            metric.all_reduce()
        if metric.num_utts:
            result["wer"] = metric.compute()
        log.info("eval: %s (%d utts)",
                 " ".join(f"{k}={v:.4f}" for k, v in result.items()),
                 metric.num_utts)
        return result
