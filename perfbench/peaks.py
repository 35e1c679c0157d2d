"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
rates without sparsity, at the 700 W power limit). Every share of a peak
or roofline is stated against these, with the card's power limit beside
it in the run's output."""

BF16_FLOPS = 989e12             # bf16 and fp16 tensor cores
FP8_FLOPS = 1979e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12              # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12       # 80 GB HBM3
HBM_BYTES = 80e9
