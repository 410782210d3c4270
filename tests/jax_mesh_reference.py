"""JAX's Trainer step over a data=2 mesh, the reference of
tests/test_torch_parallel.py.

`mesh_steps` runs the JAX package's train step (speech2text_tpu/train/
loop.py's `train_step`: loss, gradients, the Trainer's optimizer chain
as its __init__ builds it, the global gradient norm) jitted with the
Trainer's shardings over a ("data", "model") = 2 × 1 mesh of virtual CPU
devices, on the global batches of the task's pipeline. Run as a script
it does so for one case of the test's spec in a process of its own,
beside the port's ranks, importing neither torch nor the Trainer's
checkpointing:

    python tests/jax_mesh_reference.py <spec.json> <case> <start.npz> <out>

from the flat flax tree in `start.npz`, writing `<out>.npz` (the flat
parameters after the last step) and `<out>.json` (each step's metrics).
"""

import json
import os
import sys

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))


def flat(tree, prefix=""):
    """A nested dict of arrays → {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def nested(flat_tree):
    out = {}
    for key, v in flat_tree.items():
        *path, leaf = key.split("/")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = v
    return out


def mesh_steps(jtask, cfg, start, seed, steps):
    """`steps` steps from the flax tree `start`: ([metrics per step],
    the parameters after the last, as numpy)."""
    import jax
    import jax.numpy as jnp
    import optax
    from speech2text_tpu.optim import OptimSetup
    from speech2text_tpu.parallel.mesh import (MeshConfig, batch_sharding,
                                               make_mesh, replicated,
                                               shard_batch, shard_params)
    mesh = make_mesh(MeshConfig(data=2, model=1), devices=jax.devices()[:2])
    # the Trainer's chain (train/loop.py:72-81; no accumulation here)
    tx, _ = OptimSetup(cfg["optim_setup"])
    clip = (cfg.get("trainer") or {}).get("gradient_clip_val")
    if clip and cfg["optim_setup"]["optimizer"]["type"] != "ScaledAdam":
        tx = optax.chain(optax.clip_by_global_norm(float(clip)), tx)
    jtask.data_config.batch_multiple = 2
    pipe = iter(jtask.make_train_pipeline(0, 1, seed=seed))

    def train_step(params, opt_state, batch, rng, step_idx):
        (_, metrics), grads = jax.value_and_grad(
            lambda p: jtask.loss_fn(p, batch, rng, step_idx),
            has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        metrics["grad_norm"] = optax.global_norm(grads)
        return optax.apply_updates(params, updates), opt_state, metrics

    params = jax.tree.map(jnp.asarray, start)
    opt_state = jax.jit(tx.init)(params)     # eager: seconds of dispatches
    p_sh, o_sh = shard_params(mesh, params), shard_params(mesh, opt_state)
    rep = replicated(mesh)
    step = jax.jit(train_step, in_shardings=(p_sh, o_sh,
                                             batch_sharding(mesh), rep, rep),
                   out_shardings=(p_sh, o_sh, rep))
    params, opt_state = jax.device_put(params, p_sh), \
        jax.device_put(opt_state, o_sh)
    rng = jax.random.split(jax.random.PRNGKey(seed))[0]
    out = []
    with mesh:
        for i in range(steps):
            params, opt_state, metrics = step(
                params, opt_state, shard_batch(mesh, next(pipe)),
                jax.random.fold_in(rng, i), jnp.asarray(i, jnp.int32))
            out.append({k: float(v) for k, v in metrics.items()})
    return out, jax.tree.map(np.asarray, params)


def main(spec_path: str, case: str, start_path: str, out: str) -> None:
    sys.path.insert(0, TESTS)
    sys.path.insert(0, os.path.dirname(TESTS))
    import conftest  # noqa: F401  (the tests' 8-device CPU platform)
    from speech2text_tpu.tasks import TaskFactory
    with open(spec_path) as f:
        spec = json.load(f)
    cfg = spec[case]
    steps, params = mesh_steps(TaskFactory(cfg["task"]["type"])(cfg), cfg,
                               nested(dict(np.load(start_path))),
                               spec["seed"], spec["steps"])
    np.savez(out + ".npz", **flat(params))
    with open(out + ".json", "w") as f:
        json.dump(steps, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
