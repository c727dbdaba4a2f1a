"""Published peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data
sheet; dense rates, no sparsity)."""

FLOPS_PER_S = {"float32": 67e12,        # outside the tensor cores (TF32 off)
               "tf32": 495e12,
               "bfloat16": 989e12,
               "float16": 989e12}
HBM_BYTES_PER_S = 3.35e12
