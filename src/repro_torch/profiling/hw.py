"""NVIDIA H100 SXM5 constants that ``profiling/cost_model.py`` and
``profiling/roofline.py`` read (counterpart of ``repro/profiling/hw.py``,
which holds the TPU v5e's).

Published peaks, dense rates without sparsity, at the 700 W power limit.
The cost model reads them at call time, so a caller may set other values.
"""

# FLOP/s per card, dense bf16 tensor cores (NVIDIA H100 SXM5 datasheet)
PEAK_FLOPS_BF16 = 989e12
# bytes/s per card, HBM3 (NVIDIA H100 SXM5 datasheet)
HBM_BW = 3.35e12
# bytes per card, 80 GB of HBM3 (NVIDIA H100 SXM5 datasheet)
HBM_BYTES = 80 * 2 ** 30
# bytes/s per card per direction, NVLink 4 (NVIDIA H100 SXM5 datasheet):
# the link inside one NVLink domain of NVLINK_DOMAIN cards
ICI_BW = 450e9
# bytes/s per card between nodes (the counterpart of the v5e's DCN_BW):
# one 400 Gb/s NDR InfiniBand port per GPU on an HGX H100 node (NVIDIA
# DGX H100 datasheet: 8 ConnectX-7 ports of 400 Gb/s for 8 GPUs)
DCN_BW = 50e9
# cards joined all to all by NVLink in one HGX H100 node (NVIDIA HGX H100
# datasheet); a wider group crosses the DCN_BW network
NVLINK_DOMAIN = 8
# on-chip memory (the counterpart of the v5e's VMEM_BYTES): shared memory
# per SM, 228 KiB, and the L2 cache, 50 MiB (NVIDIA H100 Tensor Core GPU
# Architecture whitepaper)
SMEM_BYTES_PER_SM = 228 * 2 ** 10
L2_BYTES = 50 * 2 ** 20

# Production mesh (the reference's): one pod = (data=16, model=16) = 256
# cards, multi-pod = (pod=2, data=16, model=16) = 512.
CHIPS_PER_POD = 256
