"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3, 700 W), dense rates.

Copies of the figures the port's ``perfmodel/roofline.py`` uses, frozen
here so that no change to the program moves the benchmark's yardstick.
"""

#: bf16 tensor-core operations per second, dense (no 2:4 sparsity)
BF16_FLOPS = 989.4e12
#: float32 operations per second outside the tensor cores
F32_FLOPS = 67e12
#: HBM3 bytes per second
HBM_BYTES_S = 3.35e12
