"""Placing a restored checkpoint on a mesh (port of ``repro.ckpt.reshard``).

The manifest stores whole (mesh-free) tensors.  On one card a
``VirtualMesh`` places nothing per rank, so restoring onto any mesh is a
copy to its device; a resume on another mesh geometry additionally needs
its plans resharded (``runtime.replan.reshard_plans``, ROADMAP.md item 18).
"""

from __future__ import annotations

import torch

from .._tree import tree_map


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """JSON-able geometry stamp of a mesh ({axis: size}), written next to
    captured INIT requests so an elastic resume can see the mesh changed."""
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def put_tree(host_tree, device, out=None):
    """Each leaf on ``device``.  Given ``out`` (a tree of the same
    structure already on the device), the leaves are copied into it in
    place, so a restore needs no second copy of the state."""
    if out is not None:
        def copy(x, o):
            with torch.no_grad():
                o.copy_(x)
            return o
        return tree_map(copy, host_tree, out)
    return tree_map(lambda x: torch.as_tensor(x).to(device), host_tree)
