"""speech2text_torch: the PyTorch + CUDA (Hopper, sm_90a) port of
speech2text_tpu.

The JAX package beside it is the reference this port is held against
(tests/test_torch_*.py). This package imports torch, numpy and the
standard library only: never jax, flax or speech2text_tpu.

Covered so far: zipformer pruned-RNN-T serving (`serve.RnntServer`),
decoding a test set (`python -m speech2text_torch.inference`: greedy or
beam search, RNN-LM shallow fusion, simulated streaming, checkpoint
averaging), true streaming (`StreamingAsrSession`: raw PCM chunk by
chunk through the causal Zipformer2's caches and a resumable greedy
decode; `python -m speech2text_torch.tools.stream_demo`), training
from manifests (`python -m speech2text_torch.build_task`) and the
training step (`train.step.TrainStep`: the transducer lattice losses in `ops/rnnt.py` and `ops/pruned_rnnt.py`,
`losses.py`, ScaledAdam + Eden in `optim/`), with hand-written CUDA
kernels for the log-mel fbank (`ops/fbank.py`, `csrc/fbank.cu`) and the
zipformer attention weights (`ops/attn_weights.py`,
`csrc/attn_weights.cu`; its gradient is plain torch). `tools/` holds the
measurement helpers for the card: kernel timing and ablations.
"""

from .streaming import StreamingAsrSession

__all__ = ["StreamingAsrSession"]
