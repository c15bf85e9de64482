"""The port's meshes: P virtual ranks on one device, or one process per rank.

``VirtualMesh`` stands in for ``jax.sharding.Mesh``.  Every rank of the
exchange axis lives on the same card, and buffers keep the JAX package's
global view: rank ``i`` owns rows ``[i*rows, (i+1)*rows)`` of each global
buffer, as under ``NamedSharding(mesh, P("x"))``, and a put is a store into
the target rank's slice of one allocation.

``ProcessMesh`` (``init_process_mesh``) is one rank of P processes along
one exchange axis under ``torch.distributed``: the paper's MPI ranks.  A
buffer is this rank's shard, as JAX's addressable shard is, and a put is a
store through a peer's mapped window (``core.window.SharedWindow``).  Gloo
is the control plane only (window handles, count digests, barriers), with a
timeout on every call; the exchanges' data moves by the port's own kernels.

Every constructor takes an explicit ``device``: CUDA by default, ``"cpu"``
for the kernels' plain versions, ``"meta"`` for the dry run
(``launch.dryrun``), which traces a step's shapes and allocates nothing.
"""

from __future__ import annotations

import datetime
import socket
import uuid

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


class ProcessMesh:
    """Rank ``rank`` of ``world_size`` processes along the exchange axis
    ``axis``, on ``device``: ``cuda:(rank % torch.cuda.device_count())`` by
    default (with one card every rank shares ``cuda:0``), ``"cpu"`` for the
    kernels' plain versions.  A CUDA mesh with no GPU present raises, as
    ``VirtualMesh`` does.  Made by ``init_process_mesh``; ``close()``
    frees what the mesh registered and leaves the process group.

    ``timeout`` (seconds) bounds every control-plane call; ``flag_timeout``
    every wait on a peer's flag in an epoch (``kernels.rma_signal``).
    ``token`` names this run's shared-memory files (CPU windows), so a
    launcher can remove what a killed rank left behind.
    ``ranks_on_device``: how many ranks of the mesh share this rank's card
    (or, on the CPU, its host), which sizes each peer kernel's grid
    (``core.window.peer_geometry``); ``init_process_mesh`` counts it."""

    is_process_mesh = True

    def __init__(self, rank: int, world_size: int, device, axis: str = "x",
                 timeout: float = 120.0, flag_timeout: float = 10.0,
                 token: str = ""):
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.shape = {axis: self.world_size}
        self.axis_names = (axis,)
        self.device = torch.device(device)
        self.timeout = float(timeout)
        self.flag_timeout = float(flag_timeout)
        self.token = token
        self.ranks_on_device = 1         # init_process_mesh counts them
        self.scratch: dict = {}          # the baseline's windows (core.baseline)
        self._regions = 0

    def axis_sizes(self, axis) -> tuple[int, ...]:
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        return tuple(self.shape[a] for a in names)

    def next_region(self) -> int:
        """A number for this rank's next registered window (its file name)."""
        self._regions += 1
        return self._regions

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier()

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj``, in rank order (gloo, bounded by the
        group's timeout)."""
        import torch.distributed as dist

        out = [None] * self.world_size
        dist.all_gather_object(out, obj)
        return out

    def agree(self, value, what: str) -> None:
        """Raise ``ValueError`` on every rank unless every rank passed the
        same ``value``: the ranks all-gather it, so none waits on another
        that raised."""
        values = self.all_gather_object(value)
        bad = [r for r, v in enumerate(values) if v != values[0]]
        if bad:
            raise ValueError(
                f"rank {self.rank}: ranks disagree on {what}: rank 0 has "
                f"{values[0]!r}, ranks {bad} have "
                f"{[values[r] for r in bad]!r}")

    def close(self) -> None:
        """Free the mesh's scratch windows (collective) and leave the
        process group."""
        import torch.distributed as dist

        for region in self.scratch.values():
            region.free()
        self.scratch.clear()
        if dist.is_initialized():
            dist.destroy_process_group()

    def __repr__(self) -> str:
        return (f"ProcessMesh(rank {self.rank} of {self.world_size}, "
                f"{self.shape}, device={self.device})")


def init_process_mesh(rank: int, world_size: int, init_method: str,
                      device=None, axis: str = "x", timeout: float = 120.0,
                      flag_timeout: float = 10.0,
                      token: str | None = None) -> ProcessMesh:
    """Join the process group (gloo, ``init_method`` such as
    ``"tcp://localhost:<port>"``, the world size and this rank given) and
    return this rank's ``ProcessMesh``.  ``device``: CUDA by default, rank
    r on ``cuda:(r % device_count)``; ``"cpu"`` for the plain versions.
    The ranks all-gather (host name, device UUID) once, so each learns how
    many ranks share its card (``ranks_on_device``)."""
    import torch.distributed as dist

    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ProcessMesh: no CUDA device is available; pass device='cpu' "
                "to run the kernels' plain versions")
        device = (torch.device("cuda", rank % torch.cuda.device_count())
                  if device is None or torch.device(device).index is None
                  else torch.device(device))
        torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", init_method=init_method, rank=int(rank),
        world_size=int(world_size),
        timeout=datetime.timedelta(seconds=timeout))
    mesh = ProcessMesh(rank, world_size, device, axis=axis, timeout=timeout,
                       flag_timeout=flag_timeout)
    dev = mesh.device
    where = (socket.gethostname(),
             str(torch.cuda.get_device_properties(dev).uuid)
             if dev.type == "cuda" else dev.type)
    names = mesh.all_gather_object((uuid.uuid4().hex[:12], where))
    mesh.token = token or names[0][0]
    mesh.ranks_on_device = sum(w == where for _, w in names)
    return mesh


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
