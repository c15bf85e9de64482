"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a).

    gather_rows       K1  masked row gather (pack / unpack): one chunk of an
                          INIT-baked run table per block, or one warp per row
    a2a_fence         K2  fence epoch (Algorithm 1), optionally over groups:
                          each bucket one contiguous copy in 8 KiB chunks,
                          or one warp per row
                      K3  fence epoch with the pack gather fused in
    a2a_lock          K4  lock epoch (Algorithm 3): one clustered launch per
                          epoch, or one launch per active round
    a2a_hier          K5  stage 2 of the leader-combined hierarchy
    gather_matmul     K6  fused unpack-gather-matmul (the MoE expert FFN)

Sources are in ``csrc/``; ``_build`` compiles them with nvcc on first use.
Each kernel module also holds the kernel's plain PyTorch version, which the
wrappers take for CPU tensors.
"""
