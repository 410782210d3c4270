"""The plain reference that decides `correct`: a frozen copy of the
speech2text_torch modules that the flagship's training step runs (the
non-streaming Zipformer2 encoder without recompute or training
dynamics, the stateless predictor and the joiner, the pruned RNN-T
loss, the fbank frontend and augmentation, ScaledAdam under Eden), with
kernels B1 and B2 replaced by their plain PyTorch versions and one
process. It imports nothing of the port; `step.ReferenceTrainer` takes
the port's training step."""
