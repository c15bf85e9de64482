"""The port's mesh: P virtual ranks on one device.

``VirtualMesh`` stands in for ``jax.sharding.Mesh``.  Every rank of the
exchange axis lives on the same card, and buffers keep the JAX package's
global view: rank ``i`` owns rows ``[i*rows, (i+1)*rows)`` of each global
buffer, as under ``NamedSharding(mesh, P("x"))``, and a put is a store into
the target rank's slice of one allocation.  Ranks in separate processes,
one per card, come with a later slice (ROADMAP.md).

Every constructor takes an explicit ``device``: CUDA by default, ``"cpu"``
for the kernels' plain versions, ``"meta"`` for the dry run
(``launch.dryrun``), which traces a step's shapes and allocates nothing.
"""

from __future__ import annotations

import torch


class VirtualMesh:
    """``shape`` ranks along ``axis_names`` on ``device`` (default: the
    current CUDA device).  With no GPU present a CUDA mesh raises; there is
    no fallback to the CPU, which must be asked for with ``device="cpu"``.
    """

    def __init__(self, shape, axis_names, device=None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} does not match axes {axis_names}")
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "VirtualMesh: no CUDA device is available; pass "
                    "device='cpu' to run the kernels' plain versions")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.device = dev

    def axis_sizes(self, axis) -> tuple[int, ...]:
        """Sizes of the named axis or axes, in the order given."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        return tuple(self.shape[a] for a in names)

    def __repr__(self) -> str:
        return f"VirtualMesh({self.shape}, device={self.device})"


def make_mesh(shape, axes, device=None) -> VirtualMesh:
    """Arbitrary mesh (port of ``repro.launch.mesh.make_mesh``): P virtual
    ranks on one device, CUDA unless ``device`` says otherwise."""
    return VirtualMesh(shape, axes, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> VirtualMesh:
    """(16, 16) single-pod (256 ranks) or (2, 16, 16) two-pod (512 ranks),
    as virtual ranks on ``device``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return VirtualMesh(shape, axes, device=device)


def make_host_mesh(n: int | None = None, axis: str = "x",
                   device=None) -> VirtualMesh:
    """1-D mesh of ``n`` virtual ranks.  The JAX package's default is one
    rank per device of the host; here every rank shares one device, so
    the default is one rank."""
    return make_mesh((1 if n is None else int(n),), (axis,), device=device)


def dp_size(mesh) -> int:
    """Total batch-sharding ways under the default rules (pod x data)."""
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= int(mesh.shape[a])
    return n
