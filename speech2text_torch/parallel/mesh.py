"""Data parallelism over processes (port of speech2text_tpu/parallel/
mesh.py, with torch.distributed in place of a device mesh).

One process per GPU, launched by torchrun (`python -m
torch.distributed.run --nproc_per_node N -m speech2text_torch.build_task
...`), which sets RANK, WORLD_SIZE and LOCAL_RANK. `setup(device)` makes
the process group from them (NCCL for `cuda`, gloo for `cpu`; the
environment variable S2T_DIST_BACKEND names another, such as gloo for
ranks that share one card) and returns the rank's device, `cuda:
LOCAL_RANK`. Without torchrun's variables no group is made and the world
is one process, as before.

The JAX package's mesh has the axes ("data", "model"). Here:

- `make_mesh(MeshConfig(data, model))`: `data` is the number of ranks
  (-1: all of them; another number than the world size raises);
  `model` > 1 raises NotImplementedError: the JAX Trainer never shards
  on `model` (it passes no tensor-parallel rules), and the port has no
  tensor parallelism.
- `wrap_model(model, mesh, fsdp)`: replicated parameters with the
  gradients averaged over the ranks (DistributedDataParallel), or with
  `fsdp` the parameters and so the optimizer state sharded over the
  ranks and gathered on use (FSDP2's `fully_shard`, on each encoder
  layer and at the root; dim 0 is split as torch.chunk splits it), as
  `shard_params(fsdp=True)` shards the JAX tree. A 0-d parameter, which
  fully_shard cannot split, stays whole on every rank and has its
  gradient averaged by a hook.
- Collectives for the layers above: `all_reduce_sum`, `global_count`
  (a rank's count → the denominator that gives a global-batch mean),
  `all_gather_object`, `barrier`, `is_main`; and for the optimizers,
  `local` / `gather_rows` / `shard_rows` / `grad_norm` over sharded
  tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

BACKEND_ENV = "S2T_DIST_BACKEND"
GENERATION_ENV = "S2T_RESTART_GENERATION"

# the encoder layers that get an FSDP unit of their own: a Zipformer2's
# and an Emformer's `layers.{i}`, a Conformer's `ConformerBlock_{i}`
_LAYER_NAME = re.compile(r"(^|\.)(layers\.\d+|ConformerBlock_\d+)$")


def launched() -> bool:
    """Whether torchrun (or a launcher that sets the same variables)
    started this process."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    return rank() == 0


def setup(device: torch.device) -> torch.device:
    """The process group from torchrun's environment (once), and this
    rank's device: `cuda` becomes `cuda:LOCAL_RANK` (modulo the cards
    there are). Without torchrun's variables, `device` as it is."""
    if not launched():
        return device
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
    if active():
        return device
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = os.environ.get(BACKEND_ENV) or (
        "nccl" if device.type == "cuda" else "gloo")
    store, r, w = next(dist.rendezvous("env://"))
    # an exec-restarted group (train/loop.py's watchdog) meets under new
    # keys of a store that may keep the last group's
    gen = os.environ.get(GENERATION_ENV, "0")
    dist.init_process_group(backend, store=dist.PrefixStore(f"s2t{gen}",
                                                             store),
                            rank=r, world_size=w)
    return device


def shutdown() -> None:
    if active():
        dist.destroy_process_group()


def prepare_restart() -> None:
    """Before an exec of the same command line: leave the group, and
    name the next one's generation."""
    shutdown()
    os.environ[GENERATION_ENV] = str(int(os.environ.get(GENERATION_ENV,
                                                        "0")) + 1)


@dataclasses.dataclass
class MeshConfig:
    data: int = -1     # -1 → every rank
    model: int = 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of the data axis (`data` = the world size) and this
    process's place on it."""
    data: int
    rank: int
    model: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def make_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    config = config or MeshConfig()
    if config.model > 1:
        raise NotImplementedError(
            f"trainer.mesh.model = {config.model}: tensor parallelism on a "
            f"model axis is not ported (the JAX Trainer shards nothing on "
            f"it); use model: 1")
    world = world_size()
    data = config.data if config.data > 0 else world
    if data != world:
        raise ValueError(
            f"trainer.mesh.data = {data}, but {world} process(es) run: "
            f"launch {data} ranks with torchrun, or set data: -1")
    return Mesh(data=data, rank=rank())


# ------------------------------------------------------------ collectives
def barrier() -> None:
    if active():
        dist.barrier()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks, on `t`'s device (a new tensor; `t` itself
    outside a group of more than one)."""
    if world_size() == 1:
        return t
    out = t.detach().to(_comm_device(), copy=True)
    dist.all_reduce(out)
    return out.to(t.device)


def all_reduce_max(x: float) -> float:
    if world_size() == 1:
        return x
    t = torch.tensor([x], dtype=torch.float64, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def global_count(count: torch.Tensor, floor=1.0) -> torch.Tensor:
    """The denominator of a rank's masked sum: the global count (at least
    `floor`) over the world size, so that the mean over the ranks of
    sum / global_count(count), which is what the gradient averaging of
    DDP and FSDP takes, is the global batch's sum over its count; alone,
    the count clamped at `floor`."""
    w = world_size()
    if w == 1:
        return count.clamp(min=floor)
    return all_reduce_sum(count).clamp(min=floor) / w


def all_gather_object(obj: Any) -> List[Any]:
    if world_size() == 1:
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any) -> Any:
    """Rank 0's `obj` on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _comm_device() -> torch.device:
    """Where this module's collectives put their tensors: the current
    card for NCCL, else the CPU (gloo's own place for them)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# --------------------------------------------------------- sharded tensors
def is_sharded(t: Any) -> bool:
    if not active():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a sharded tensor (a view: writing it writes
    the parameter), else `t`."""
    return t.to_local() if is_sharded(t) else t


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a sharded one (a collective), else `t`."""
    return t.full_tensor() if is_sharded(t) else t


def row_bounds(n: int) -> Tuple[int, int]:
    """[start, end) of this rank's rows of `n`: torch.chunk's split into
    world-size pieces of ceil(n / world) rows (the last ones shorter or
    empty), the split of FSDP2's dim-0 sharding."""
    w, r = world_size(), rank()
    c = -(-n // w)
    start = min(r * c, n)
    return start, min(start + c, n)


def shard_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows (along `dim`) of a whole tensor."""
    start, end = row_bounds(t.shape[dim])
    return t.narrow(dim, start, end - start)


def gather_rows(t: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
    """The whole tensor of `n` rows along `dim` from every rank's
    `shard_rows` piece `t` (a collective)."""
    w = world_size()
    if w == 1:
        return t
    c = -(-n // w)
    pad = list(t.shape)
    pad[dim] = c - t.shape[dim]
    piece = torch.cat([t, t.new_zeros(pad)], dim=dim).to(_comm_device())
    pieces = [torch.empty_like(piece) for _ in range(w)]
    dist.all_gather(pieces, piece.contiguous())
    return torch.cat(pieces, dim=dim).narrow(dim, 0, n).to(t.device)


def grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global norm of `grads`, sharded ones summed over the ranks;
    torch.nn.utils.get_total_norm when none is sharded."""
    sharded = [local(g) for g in grads if is_sharded(g)]
    if not sharded:
        return torch.nn.utils.get_total_norm(list(grads))
    sq = all_reduce_sum(torch.nn.utils.get_total_norm(sharded).square())
    whole = [g for g in grads if not is_sharded(g)]
    if whole:
        sq = sq + torch.nn.utils.get_total_norm(whole).square()
    return sq.sqrt()


# ---------------------------------------------------------------- models
class _DataParallel(DistributedDataParallel):
    """DistributedDataParallel whose other attributes are the wrapped
    module's, so that task code reading `model.encoder` or calling
    `model.joiner_step` runs unchanged on the wrapper."""

    def __getattr__(self, name: str):
        try:
            return super().__getattr__(name)
        except AttributeError:
            if name == "module":
                raise
            return getattr(self.module, name)


def _average_grad(p: torch.Tensor) -> None:
    p.grad.copy_(all_reduce_sum(p.grad) / world_size())


def wrap_model(model: nn.Module, mesh: Mesh, fsdp: bool = False
               ) -> nn.Module:
    """The module the training forward runs through: `model` itself
    outside a process group (with one process, sharding over one device
    is replication, as JAX's shard_params has it); else replicated under
    DistributedDataParallel, or with `fsdp` sharded in place by
    fully_shard (then `model` is returned). `model` is on this rank's
    device."""
    if not active():
        return model
    if not fsdp:
        # buffers are constants here, so nothing to broadcast per forward;
        # a frozen or skipped part (a wav2vec2 extractor) takes no gradient
        return _DataParallel(model, broadcast_buffers=False,
                             find_unused_parameters=True)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    dev = next(model.parameters()).device
    dmesh = init_device_mesh(dev.type, (mesh.data,))
    scalars = {p for p in model.parameters() if p.ndim == 0}
    units = [m for name, m in model.named_modules()
             if _LAYER_NAME.search(name)]
    for m in units:
        fully_shard(m, mesh=dmesh, reshard_after_forward=True,
                    ignored_params=scalars)
    fully_shard(model, mesh=dmesh, reshard_after_forward=False,
                ignored_params=scalars)
    model._s2t_units = units
    for p in scalars:
        if p.requires_grad:
            p.register_post_accumulate_grad_hook(_average_grad)
    return model


@contextlib.contextmanager
def gathered(model: nn.Module) -> Iterator[None]:
    """Every parameter of a fully_shard model whole on every rank for the
    body (evaluation and decoding call submodules and methods that the
    FSDP hooks do not see), sharded again after it; nothing otherwise."""
    units = getattr(model, "_s2t_units", None)
    if units is None:
        yield
        return
    for m in units + [model]:
        m.set_reshard_after_forward(False, recurse=False)
        m.unshard()
    try:
        yield
    finally:
        for m in units + [model]:
            m.reshard()
        for m in units:
            m.set_reshard_after_forward(True, recurse=False)


def full_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """`model`'s state dict as whole CPU tensors (a collective under
    FSDP: every rank calls it)."""
    return {k: full(v).detach().cpu() for k, v in model.state_dict().items()}


def load_full_state(model: nn.Module, state: Dict[str, torch.Tensor]
                    ) -> None:
    """Load a whole state dict (a checkpoint of any world size) into
    `model`, each rank taking its rows of a sharded parameter."""
    live = model.state_dict()
    if not any(is_sharded(v) for v in live.values()):
        model.load_state_dict(state)
        return
    missing = sorted(set(live) - set(state))
    unexpected = sorted(set(state) - set(live))
    if missing or unexpected:
        raise RuntimeError(f"state dict keys: missing {missing}, "
                           f"unexpected {unexpected}")
    with torch.no_grad():
        for k, v in live.items():
            src = state[k]
            if tuple(src.shape) != tuple(v.shape):
                raise RuntimeError(f"{k}: shape {tuple(src.shape)} in the "
                                   f"state, {tuple(v.shape)} in the model")
            if is_sharded(v):
                local(v).copy_(shard_rows(src))
            else:
                v.copy_(src)
