"""PyTorch and CUDA port of ``repro`` for an NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports
nothing of it and no JAX.  Ported so far: the persistent exchange plans
(alltoallv, allgatherv, reduce-scatter; fence, lock, the leader-combined
hierarchy, ragged; wire codecs; ``variant="auto"`` through the break-even
model) over P virtual ranks on one card, epoch telemetry with spans and
Prometheus metrics (``obs``), and OLMoE-1B-7B serving through the
persistent MoE dispatch, with six hand-written CUDA kernels.

    from repro_torch.core import alltoallv_init
    from repro_torch.launch.mesh import VirtualMesh
"""
