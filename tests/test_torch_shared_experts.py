"""The MoE layer's shared experts against the JAX package: the reduced
Moonshot-v1-16B-A3B MoE layer (8 experts, top-2, d_expert 64, 2 shared
experts: a dense SwiGLU of 128 hidden units on every token) on the CPU.

One JAX subprocess (``tests/_torch_parity_jax_families.py shared``, ~13 s
alone) writes, for each case of ``SHARED_CASES`` on a ``(1, P)`` mesh, the
layer's output, aux losses and the gradients of every weight (the shared
experts' ``sh_gate``, ``sh_up``, ``sh_down`` included) and of the input,
under a fixed cotangent.  256 tokens split evenly over the ranks, so no
rank carries padding and the JAX package's routing is right there.

Tolerances (float32, sums in another order): output rtol 1e-5, atol 1e-6;
aux losses rtol 1e-6; gradients rtol 1e-4, atol 1e-6.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity_jax_families as parity
from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.models import moe
from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("router", "w_gate", "w_up", "w_down", "sh_gate", "sh_up", "sh_down")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_shared") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, "tests", "_torch_parity_jax_families.py"),
         "shared", str(out)], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def case_id(case) -> str:
    return "P{}-{}-{}".format(*case)


def run_port(ref, case, grad=True):
    p, dispatch, variant = case
    cfg = get_reduced("moonshot-v1-16b-a3b")
    mcfg = dataclasses.replace(cfg.moe, dispatch=dispatch, a2a_variant=variant)
    prm = {n: torch.from_numpy(ref[f"params/{n}"]).requires_grad_(grad)
           for n in NAMES}
    x = torch.from_numpy(ref["x"]).requires_grad_(grad)
    mesh = VirtualMesh((1, p), ("data", "model"), device="cpu")
    with axis_rules(DEFAULT_RULES, mesh):
        plan = moe.MoEDispatchPlan.build(mcfg, parity.SHARED_TOKENS, mesh,
                                         d_model=cfg.d_model,
                                         dtype=torch.float32)
        assert plan.plan_backed == (dispatch == "persistent_a2a")
        y, aux = moe.apply_moe(prm, x, mcfg, plan)
    return prm, x, y, aux


@pytest.mark.parametrize("case", parity.SHARED_CASES, ids=case_id)
def test_shared_expert_layer_matches_jax(ref, case):
    prm, x, y, aux = run_port(ref, case)
    tag = case_id(case)
    np.testing.assert_allclose(y.detach().numpy(), ref[f"{tag}/y"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.detach().numpy(), ref[f"{tag}/aux"],
                               rtol=1e-6)
    obj = (y * torch.from_numpy(ref["cot"])).sum() \
        + (aux * torch.from_numpy(ref["aux_cot"])).sum()
    grads = torch.autograd.grad(obj, [prm[n] for n in NAMES] + [x])
    for name, g in zip(NAMES + ("x",), grads):
        want = ref[f"{tag}/d{name}"]
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_shared_experts_add_their_swiglu_in_the_working_dtype(ref):
    """The shared branch is ``silu(x @ sh_gate) * (x @ sh_up) @ sh_down`` on
    the whole input, added after the routed output, in x's dtype (the
    weights cast to it, as JAX's ``.astype(x.dtype)``)."""
    case = parity.SHARED_CASES[0]
    prm, x, y, _ = run_port(ref, case, grad=False)
    routed = {k: v for k, v in prm.items() if not k.startswith("sh_")}
    cfg = get_reduced("moonshot-v1-16b-a3b")
    mesh = VirtualMesh((1, case[0]), ("data", "model"), device="cpu")
    plain = dataclasses.replace(cfg.moe, n_shared_experts=0)
    with axis_rules(DEFAULT_RULES, mesh):
        y0, _ = moe.apply_moe(routed, x, plain, None)
        yb, _ = moe.apply_moe({k: v.to(torch.bfloat16) for k, v in prm.items()},
                              x.to(torch.bfloat16), cfg.moe, None)
    sh = (torch.nn.functional.silu(x @ prm["sh_gate"]) * (x @ prm["sh_up"])
          ) @ prm["sh_down"]
    assert torch.equal(y, y0 + sh)
    assert yb.dtype == torch.bfloat16
