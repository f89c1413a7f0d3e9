"""The target card's peaks (the port of ``repro.roofline.hw``): one NVIDIA
H100 SXM 80GB HBM3 at its full 700 W power limit, from NVIDIA's data sheet
(dense rates, no sparsity). A card set below 700 W runs slower under load,
so a share of these peaks is stated with the card's power limit beside it.
"""

# H100 SXM 80GB HBM3, 700 W: bf16 (and fp16) on the tensor cores, dense
PEAK_FLOPS_BF16 = 989e12
# H100 SXM 80GB HBM3, 700 W: float32 on the CUDA cores (TF32 off)
PEAK_FLOPS_FP32 = 67e12
# H100 SXM 80GB HBM3, 700 W: device memory's rate, bytes/s
HBM_BW = 3.35e12
# H100 SXM 80GB HBM3: device memory, bytes: the data sheet's 80 GB in binary
# units, as the card counts them (it reports 81,559 MiB, 0.4 % below)
HBM_BYTES = 80 << 30
# H100 SXM 80GB HBM3, 700 W: NVLink to the host's other cards, bytes/s each way
NVLINK_BW = 450e9
# H100 SXM 80GB HBM3: streaming multiprocessors
SM_COUNT = 132

# the peak a dtype's operations run at (a float32 GEMM runs on the CUDA cores:
# the port leaves TF32 off)
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float16": PEAK_FLOPS_BF16,
              "float32": PEAK_FLOPS_FP32}
# H100 SXM 80GB HBM3: the largest thread-block cluster of K3's 132 KiB blocks
# that the card places (``kernels.fwht.max_cluster`` asks the card)
MAX_CLUSTER = 16
