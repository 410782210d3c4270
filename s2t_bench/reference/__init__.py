"""The plain reference that decides `correct`: a frozen copy of the
speech2text_torch modules that the flagship's training step runs (the
non-streaming Zipformer2 encoder without recompute or training
dynamics, the stateless predictor and the joiner, the pruned RNN-T
loss, the fbank frontend and augmentation, ScaledAdam under Eden), with
kernels B1 and B2 replaced by their plain PyTorch versions and one
process. It imports nothing of the port; `step.ReferenceTrainer` takes
the port's training step.

A configuration file names its reference module under "reference"
(cell.py); the module defines `check_config(config)`, which raises
ValueError (or KeyError, TypeError) on a training config that it does
not support, cheaply and before any work on the card,
`check_traffic(config, traffic)`, which raises the same way on a traffic
mix whose labels its model cannot take, and
`ReferenceTrainer(config, seed, device, write_weights)` with `.model`
and `.train_step(batch, step) -> {"loss", ...}`. The control
(check.lower_precision) reaches the products that go through
`models.layers.Dense` and `Conv`."""
