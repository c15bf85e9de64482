"""Ulysses sequence-parallel attention of the port against the JAX package.

One JAX subprocess (``tests/_torch_parity_jax_families.py ulysses``, ~8 s
alone) runs ``ulysses_attention`` at the shapes of ``dist_cases``'
``ulysses_attention_matches_local`` and ``ulysses_hier_attention`` (B 2,
S 32, 4 heads of 8): on ``(4,)`` ("model", the fence head exchange) with
its vjp, and on ``(2, 2)`` ("pod", "model", the leader-combined head
exchange).  The port runs on ``VirtualMesh(..., device="cpu")``, where the
head exchanges take K2's plain version.

Tolerances (float32): outputs and gradients against JAX's rtol 2e-5, atol
2e-5 (``dist_cases``' own against ``_attend``); against the port's own
``_attend``: bit-equal (each head group's einsum is the same product).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity_jax_families as parity
from repro_torch.core import global_plan_cache
from repro_torch.kernels import _build
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.models import ulysses
from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ulysses") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, "tests", "_torch_parity_jax_families.py"),
         "ulysses", str(out)], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def run(ref, tag, grad=False):
    shape, names, axis, hier = parity.ULYSSES_MESHES[tag]
    mesh = VirtualMesh(shape, names, device="cpu")
    q, k, v = (torch.from_numpy(ref[n]).requires_grad_(grad)
               for n in ("q", "k", "v"))
    pos = torch.from_numpy(ref["pos"])
    with axis_rules(DEFAULT_RULES, mesh):
        plan = ulysses.UlyssesPlan.build(parity.ULYSSES["h"],
                                         parity.ULYSSES["d"], mesh,
                                         axis=axis, hier=hier)
        assert plan.p == 4 and plan.hier == hier
        o = ulysses.ulysses_attention(q, k, v, pos, plan)
    return (q, k, v), pos, o


@pytest.mark.parametrize("tag", list(parity.ULYSSES_MESHES))
def test_ulysses_matches_jax_and_attend(ref, tag):
    (q, k, v), pos, o = run(ref, tag)
    np.testing.assert_allclose(o.numpy(), ref[f"{tag}/o"], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(o.numpy(), ref["attend"], rtol=2e-5, atol=2e-5)
    assert torch.equal(o, ulysses._attend(q, k, v, pos, True))


def test_ulysses_backward_matches_jax(ref):
    """The head exchanges are their own transpose: the gradients of q, k
    and v through the port's fence exchanges against JAX's vjp."""
    (q, k, v), _, o = run(ref, "flat", grad=True)
    grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(ref["cot"]))
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(g.numpy(), ref[f"flat/{name}"], rtol=2e-5,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("tag", list(parity.ULYSSES_MESHES))
def test_ulysses_exchange_calls_and_positions_plan(ref, tag):
    """Four head exchanges per call (q, k, v and o), each one K2 epoch
    (plain here) flat or two (hops 1 and 3) under the hierarchy, and
    the positions gather a persistent allgatherv plan, INIT once: a second
    call hits the plan cache."""
    run(ref, tag)
    cache = global_plan_cache()
    hits, misses = cache.hits, cache.misses
    k2 = _build.counts()["a2a_fence"]["plain_calls"]
    run(ref, tag)
    want = 4 * (2 if parity.ULYSSES_MESHES[tag][3] else 1)
    assert _build.counts()["a2a_fence"]["plain_calls"] - k2 == want
    assert (cache.hits, cache.misses) == (hits + 1, misses)


def test_ulysses_positions_gather_pads_to_its_plan(ref):
    """S/P not tile-aligned: the allgatherv plan's send rows exceed S/P, so
    the positions are padded as in the JAX package, and the result is
    still ``_attend``'s."""
    mesh = VirtualMesh((4,), ("model",), device="cpu")
    gen = torch.Generator().manual_seed(1)
    b, s, h, d = 2, 12, 4, 8
    q, k, v = (torch.randn((b, s, h, d), generator=gen) for _ in range(3))
    pos = torch.arange(s)[None].expand(b, s)
    with axis_rules(DEFAULT_RULES, mesh):
        plan = ulysses.UlyssesPlan.build(h, d, mesh, axis="model")
        o = ulysses.ulysses_attention(q, k, v, pos, plan)
    assert torch.equal(o, ulysses._attend(q, k, v, pos, True))
    with pytest.raises(ValueError, match="not divisible"):
        ulysses.UlyssesPlan.build(6, d, mesh, axis="model")
    with pytest.raises(ValueError, match="outer, inner"):
        ulysses.UlyssesPlan.build(h, d, mesh, axis="model", hier=True)
