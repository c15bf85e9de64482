"""Placing a restored checkpoint on a mesh (port of ``repro.ckpt.reshard``).

The manifest stores whole (mesh-free) tensors, so loading onto any mesh
is a placement against that mesh.  This is the elastic-scaling path:
train on one mesh, lose (or gain) ranks, resume on another, with the
plans of the new geometry prewarmed by ``runtime.replan.reshard_plans``.
On one card a ``VirtualMesh`` places nothing per rank, so placing is a
copy to the mesh's device.
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


def load_to_mesh(manager, mesh, step=None, out=None):
    """Load + place: every tree of the checkpoint onto the TARGET mesh.
    Returns ``(step, {"name": device tree}, extras)``, or three Nones when
    there is no checkpoint.  The JAX function also takes the target
    mesh's shardings; on one card nothing is placed per rank, so there is
    none to give.  ``out`` ({"name": device tree or None}) names live
    trees to restore into in place, so the state is never held twice."""
    step, host_trees, extras = manager.load(step)
    if step is None:
        return None, None, None
    out = out or {}
    placed = {name: put_tree(tree, mesh.device, out=out.get(name))
              for name, tree in host_trees.items()}
    return step, placed, extras
