"""Target hardware constants (NVIDIA H100 SXM) for the roofline model.

The card: "NVIDIA H100 80GB HBM3, 700.00 W" as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
it.  The rates are NVIDIA's data sheet for the SXM part, dense, at the
full 700 W power limit; a card set below it runs slower under load.
``HBM_BYTES`` was read on that card from
``torch.cuda.get_device_properties(0).total_memory``.
"""

PEAK_FLOPS_BF16 = 989e12       # per card, bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12        # per card, float32 on the CUDA cores
HBM_BW = 3.35e12               # bytes/s per card
NVLINK_BW = 450e9              # bytes/s per card, per direction
HBM_BYTES = 85_017_493_504     # device memory of one card (79.18 GiB)
