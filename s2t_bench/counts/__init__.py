"""Operation and byte counts of the training step, from a training
config and a batch's shapes alone (no program code): the model FLOPs of
a step (`zipformer.step_flops`), the least time of kernels B1 and B2 on a card
(`kernels.py`), and the card's published peaks (`peaks.py`).

What depends on the model lies in a counts module of its own,
counts/<name>.py, that a configuration file names under "counts"
(cell.PARTS): `step_flops(config, batch, pcm_len, label_len)`, the model
FLOPs of one training step, and `b2_calls(config, batch, pcm_len,
noise_len)`, the (B, N) of each kernel B2 call of its featurize. A
metric's reader reaches it as `r.cell.part("counts")`.

FLOPs count the matrix products and convolutions of the forward pass at
2 per multiply-add, over the padded batch, with every attention product
over the whole (T, T) square (what the mask leaves out is still
computed); elementwise work, norms, softmax and the lattice recursions
are not counted. Training takes 3× the forward of the trained modules
(the backward's two products per forward product). Recompute is not
counted.
"""
