"""PyTorch and CUDA port of ``repro`` for an NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports
nothing of it and no JAX.  Ported so far: the persistent alltoallv plan
(fence and lock) over P virtual ranks on one card, with four hand-written
CUDA kernels.

    from repro_torch.core import alltoallv_init
    from repro_torch.launch.mesh import VirtualMesh
"""
