"""The benchmark of speech2text_torch (the PyTorch and CUDA port) on
NVIDIA H100 cards. `python3 -m s2t_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` runs one cell of BENCHMARK.json once and
prints one JSON line. Nothing here imports JAX or the JAX package."""
