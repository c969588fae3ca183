"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W).  Frozen: a roofline share or an mfu is stated against
these, with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12           # float32 outside the tensor cores
TF32_FLOPS = 495e12         # TF32 on the tensor cores
BF16_FLOPS = 989e12         # bf16 / fp16 on the tensor cores
HBM_BYTES = 80e9

COMPUTE_PEAK = {"float32": F32_FLOPS, "bfloat16": BF16_FLOPS,
                "float16": BF16_FLOPS}
