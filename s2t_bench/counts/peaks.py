"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {
    "bfloat16": 989e12,      # tensor cores
    "float16": 989e12,
    "tf32": 495e12,          # float32 inputs on tensor cores
    "float32": 67e12,        # float32 outside the tensor cores
}


def matmul_peak(dtype: str, float32_matmul_precision: str) -> float:
    """The peak FLOP/s of the products of a model in `dtype`: float32 runs
    at the TF32 rate unless the matmul precision is "highest"."""
    if dtype == "float32" and float32_matmul_precision != "highest":
        return FLOPS["tf32"]
    return FLOPS[dtype]
