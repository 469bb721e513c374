"""NVIDIA H100 SXM5 constants that ``profiling/cost_model.py`` reads
(counterpart of ``repro/profiling/hw.py``, which holds the TPU v5e's).

Published peaks, dense rates without sparsity, at the 700 W power limit.
The cost model reads them at call time, so a caller may set other values.
"""

# FLOP/s per card, dense bf16 tensor cores (NVIDIA H100 SXM5 datasheet)
PEAK_FLOPS_BF16 = 989e12
# bytes/s per card, HBM3 (NVIDIA H100 SXM5 datasheet)
HBM_BW = 3.35e12
# bytes per card, 80 GB of HBM3 (NVIDIA H100 SXM5 datasheet)
HBM_BYTES = 80 * 2 ** 30
# bytes/s per card per direction, NVLink 4 (NVIDIA H100 SXM5 datasheet)
ICI_BW = 450e9
