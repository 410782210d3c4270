"""The ranks of tests/test_torch_parallel.py: every multi-rank case of the
port in one torchrun job of 2 gloo processes on the CPU.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_parallel_ranks.py <spec.json>

`spec.json` (written by the test) names the configs and directories.
Each rank trains, in turn, the DDP run, the FSDP run, the FSDP run with
the encoder's activation recompute (`remat: full`) and the NNLM run
(Trainer.fit; rank 0 writes metrics.jsonl and checkpoints), computes the
balancer's and whitening's gradients on its half of a seeded batch,
decodes its slice of the test set (inference.main; rank 0 writes the
report), and writes what the test compares into `<out>/rank<r>.json`
and `<out>/rank<r>.npz`. Imports no JAX.
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from speech2text_torch import inference, parallel  # noqa: E402
from speech2text_torch.ops.regularizers import balancer, whiten  # noqa: E402
from speech2text_torch.tasks.factory import TaskFactory  # noqa: E402
from speech2text_torch.train.loop import Trainer  # noqa: E402

# the balancer's limits and whitening's: every channel outside a limit,
# the metric above its limit
BALANCER = dict(min_positive=0.45, max_positive=0.55, min_abs=5.0,
                max_abs=10.0, grad_scale=0.04, prob=1.0)
WHITEN = dict(whitening_limit=1.0, grad_scale=0.01)
REG_SHAPE = (4, 6, 8)       # (B, T, C) of the global batch


def regularizer_batch(seed: int = 5):
    """The global batch (x, g) of the regularizer case."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(REG_SHAPE).astype(np.float32)
    x[..., :3] += 1.5       # means off zero: the mean limit binds too
    g = rng.standard_normal(REG_SHAPE).astype(np.float32)
    return x, g


def regularizer_grads(x: np.ndarray, g: np.ndarray):
    """This rank's half of the batch through both regularizers: the
    gradients their backwards give its rows."""
    half = x.shape[0] // parallel.world_size()
    rows = slice(parallel.rank() * half, (parallel.rank() + 1) * half)
    out = {}
    for name, fn in (("balancer", lambda t: balancer(t, **BALANCER)),
                     ("whiten", lambda t: whiten(t, **WHITEN))):
        xt = torch.from_numpy(x[rows]).requires_grad_(True)
        fn(xt).backward(torch.from_numpy(g[rows]))
        out[name] = xt.grad.numpy()
    return out


def train(cfg, workdir, seed, steps):
    task = TaskFactory(cfg["task"]["type"])(cfg)
    trainer = Trainer(task, cfg, workdir, seed=seed, device="cpu")
    trainer.fit(max_steps=steps)
    trainer.close()
    return trainer


def draws(trainer, steps=(0, 1)):
    """The first values of the step's three generators."""
    out = {}
    for step in steps:
        gens = trainer.generators(step)
        out[str(step)] = [torch.rand(4, generator=g).tolist() for g in gens]
    return out


def main(spec_path: str) -> None:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    parallel.setup(torch.device("cpu"))
    r = parallel.rank()
    result = {}
    ddp = train(spec["ddp"], spec["ddp_dir"], spec["seed"], spec["steps"])
    result["draws"] = draws(ddp)
    result["ddp_eval"] = ddp.last_eval
    fsdp = train(spec["fsdp"], spec["fsdp_dir"], spec["seed"], spec["steps"])
    result["fsdp_sharded"] = sum(parallel.is_sharded(p)
                                 for p in fsdp.model.parameters())
    result["fsdp_eval"] = fsdp.last_eval
    remat = train(spec["fsdp_remat"], spec["fsdp_remat_dir"], spec["seed"],
                  spec["steps"])
    result["fsdp_remat_eval"] = remat.last_eval
    lm = train(spec["nnlm"], spec["nnlm_dir"], spec["seed"], spec["steps"])
    pipe = lm.task.make_train_pipeline(r, parallel.world_size(),
                                       seed=spec["seed"])
    it = iter(pipe)
    result["nnlm_tokens"] = [int(np.sum(next(it)["text_length"] - 1))
                             for _ in range(spec["steps"])]
    grads = regularizer_grads(*regularizer_batch())
    run = inference.main(["--inference_config", spec["infer"],
                          "--device", "cpu"])
    result["infer"] = {"wer": run["wer"], "num_utts": run["num_utts"]}
    with open(os.path.join(spec["out"], f"rank{r}.json"), "w") as f:
        json.dump(result, f)
    np.savez(os.path.join(spec["out"], f"rank{r}.npz"), **grads)
    parallel.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
