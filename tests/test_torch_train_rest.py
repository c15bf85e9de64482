"""The rest of the port's training path against the JAX package, on the CPU:
the backward of every embedded epoch, the MoE layer under the wire codecs,
training under a codec, and a trainer that repeats itself bit for bit.

One subprocess (``tests/_torch_parity_jax_train_rest.py``, 8 host devices)
writes the JAX side once per test run; every case reads it.  The port runs
on ``VirtualMesh(..., device="cpu")``, where every kernel takes its plain
version.

Tolerances:

| compared value | tolerance |
|---|---|
| embedded vjp of a body that moves rows (alltoallv, reduce-scatter, the allgatherv fence, bf16 and int8 codecs) | exact, by value (JAX's scatter-add turns -0.0 into +0.0) |
| embedded vjp of the allgatherv lock and hierarchy | 1e-6 x max: the sum of the P copies of a row, in another order than XLA's |
| embedded vjp through a scale (fp8; int8 on the hierarchy's side channel) | 1e-6 x max: float32 arithmetic of the scale's path in another order |
| forward of a lossy codec | the codec's declared bound x the row's max |
| MoE gradients, int8 and fp8 | rtol 1e-4, atol 1e-6 at the train-parity test's cotangent scale (x 4096 here, a loss scale at which fp8 cotangents do not underflow) |
| MoE gradients, bf16 | expert weights as above; router and input within 2^-8 x max (see below) |
| train losses and gradient norms under bf16 | rtol 1e-4 |

Under bf16 the expert outputs are rounded to the wire dtype after a float32
FFN that XLA and PyTorch sum in different orders: 2 of the layer's 8192
outputs round to the neighbouring bf16 value.  The router's and the
input's gradients read those outputs, so they agree to the codec's
declared error (2^-8) of their largest entry, not to 1e-4 everywhere.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity_jax_train_rest as parity
from repro_torch._tree import leaves_with_paths
from repro_torch.configs import ShapeConfig, get_reduced
from repro_torch.core import (PlanCache, allgatherv_init, alltoallv_init,
                              reduce_scatter_init)
from repro_torch.data.synthetic import DataConfig, SyntheticTokens
from repro_torch.kernels import _build
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.models import api as model_api
from repro_torch.models import moe
from repro_torch.parallel import wirecodec
from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules
from repro_torch.train import ScheduleConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_train_rest") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, "tests", "_torch_parity_jax_train_rest.py"),
         str(out)], capture_output=True, text=True, timeout=600, env=env,
        cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def subtree(ref, prefix: str) -> dict:
    tree: dict = {}
    for key, v in ref.items():
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return tree


def port_plan(collective, variant, impl, codec, shape, schedule):
    names = ("x",) if len(shape) == 1 else ("o", "i")
    mesh = VirtualMesh(shape, names, device="cpu")
    kw = dict(axis=names[0] if len(names) == 1 else names, variant=variant,
              cache=PlanCache())
    counts = parity.counts_of(collective, int(np.prod(shape)))
    if collective == "alltoallv":
        return alltoallv_init(
            counts, (parity.VJP_F,), torch.float32, mesh, pack_impl=impl,
            lock_schedule=schedule, codec=codec, embeddable=True,
            error_tol=None if codec == "identity" else parity.CODEC_TOL, **kw)
    init = allgatherv_init if collective == "allgatherv" else reduce_scatter_init
    return init(counts, (parity.VJP_F,), torch.float32, mesh, **kw)


def vjp_tolerance(case) -> float:
    """The stated tolerance of a case's gradient, relative to its max."""
    collective, variant, _, codec, _, _ = case
    if collective == "allgatherv" and variant != "fence":
        return 1e-6
    if codec == "fp8" or (codec == "int8" and variant == "fence_hierarchy"):
        return 1e-6
    return 0.0


# ---------------------------------------------------------------------------
# The embedded epochs' backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", parity.VJP_CASES, ids=parity.case_id)
def test_embedded_vjp_matches_jax(ref, case):
    plan = port_plan(*case)
    tag = f"vjp/{parity.case_id(case)}"
    x = torch.from_numpy(ref[f"{tag}/x"]).requires_grad_(True)
    y = plan.embed()(x)
    (gx,) = torch.autograd.grad(
        y, x, torch.from_numpy(ref[f"{tag}/cot"]).view(y.shape))
    y = y.detach().reshape(-1, parity.VJP_F).numpy()
    want_y, want_g = ref[f"{tag}/y"], ref[f"{tag}/gx"]
    codec = wirecodec.get(case[3])
    if codec.name in ("int8", "fp8"):
        bound = codec.rel_error * np.abs(want_y).max(axis=1, keepdims=True)
        assert (np.abs(y - want_y) <= bound).all()
    else:
        np.testing.assert_array_equal(y, want_y)
    tol = vjp_tolerance(case)
    if tol:
        assert np.abs(gx.numpy() - want_g).max() <= tol * np.abs(want_g).max()
    else:
        np.testing.assert_array_equal(gx.numpy(), want_g)
    if case[3] == "int8" and case[1] != "fence_hierarchy":
        # round() and the inlined scale lanes (a bitcast) carry no gradient.
        assert not want_g.any() and not gx.numpy().any()
    else:
        assert np.abs(want_g).max() > 0


@pytest.mark.parametrize("case", parity.RAISE_CASES, ids=parity.case_id)
def test_untransposable_bodies_raise_as_in_jax(ref, case):
    """The flat ``pallas`` and ``fused`` bodies and the hierarchy's ``fused``
    body run a Pallas kernel in the JAX package, which has no transpose:
    ``jax.vjp`` raises NotImplementedError there, and so does the port's
    backward, naming that limit."""
    assert str(ref[f"raise/{parity.case_id(case)}"]).startswith(
        "NotImplementedError")
    variant, impl, shape = case
    plan = port_plan("alltoallv", variant, impl, "identity", shape, "ring")
    assert not plan.uniform_full
    x = torch.randn(plan.p, plan.send_rows, parity.VJP_F, requires_grad=True)
    y = plan.embed()(x)
    with pytest.raises(NotImplementedError, match="Pallas kernel has no "
                                                  "transpose"):
        y.sum().backward()


@pytest.mark.parametrize("variant,impl,want", [
    ("fence", "jnp", {"a2a_fence": 1}),
    ("lock", "jnp", {"a2a_lock": 1}),
    ("fence_hierarchy", "jnp", {"a2a_fence": 1}),
    ("fence_hierarchy", "pallas", {"a2a_fence": 1, "gather_rows": 2}),
])
def test_transposed_epoch_launches(variant, impl, want):
    """The backward as designed: the unpack's transpose, one bucket
    exchange (K2, or K4 for the lock), the pack's transpose; the gathers
    are K1 where the forward's were (the hierarchy's ``pallas`` packs).
    The hierarchy's backward is the flat transposed fence.  Counted here
    as calls of the kernels' plain versions."""
    shape = (2, 4) if variant == "fence_hierarchy" else (4,)
    plan = port_plan("alltoallv", variant, impl, "identity", shape, "ring")
    x = torch.randn(plan.p, plan.send_rows, parity.VJP_F, requires_grad=True)
    y = plan.embed()(x)
    _build.reset_counts()
    (gx,) = torch.autograd.grad(y, x, torch.randn(y.shape))
    calls = {k: v["plain_calls"] for k, v in _build.counts().items()
             if v["plain_calls"]}
    assert calls == want
    host = plan._transposes[1][0]
    assert all(t.shape[0] == plan.p for t in host)


# ---------------------------------------------------------------------------
# The MoE layer under the wire codecs
# ---------------------------------------------------------------------------

MOE_NAMES = ("router", "w_gate", "w_up", "w_down", "x")


def port_moe_grads(ref, codec):
    olmoe = get_reduced("olmoe-1b-7b")
    mcfg = dataclasses.replace(olmoe.moe, dispatch="persistent_a2a",
                               a2a_variant="fence", wire_codec=codec,
                               codec_tol=parity.CODEC_TOL)
    mesh = VirtualMesh((1, parity.MOE_EP), ("data", "model"), device="cpu")
    prm = {k: torch.from_numpy(v).requires_grad_(True)
           for k, v in subtree(ref, "moe/params/").items()}
    x = torch.from_numpy(ref["moe/x"]).requires_grad_(True)
    with axis_rules(DEFAULT_RULES, mesh):
        plan = moe.MoEDispatchPlan.build(mcfg, parity.MOE_TOKENS, mesh,
                                         d_model=olmoe.d_model,
                                         dtype=torch.float32,
                                         cache=PlanCache())
        y, aux = moe.apply_moe(prm, x, mcfg, plan)
    obj = (y * torch.from_numpy(ref["moe/cot"])).sum() \
        + (aux * torch.from_numpy(ref["moe/aux_cot"])).sum()
    grads = torch.autograd.grad(obj, [prm[n] for n in MOE_NAMES[:4]] + [x],
                                allow_unused=True, materialize_grads=True)
    return dict(zip(MOE_NAMES, (g.numpy() for g in grads)))


# ``test_moe_grads_match_jax``'s atol at its cotangent scale (1 / tokens),
# scaled with this file's loss scale.
MOE_ATOL = 1e-6 * parity.MOE_COT_SCALE * parity.MOE_TOKENS


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_moe_codec_grads_match_jax(ref, codec):
    got = port_moe_grads(ref, codec)
    for name, g in got.items():
        want = ref[f"moe/{codec}/d{name}"]
        if codec == "bf16" and name in ("router", "x"):
            assert np.abs(g - want).max() <= 2.0 ** -8 * np.abs(want).max()
        else:
            np.testing.assert_allclose(g, want, rtol=1e-4, atol=MOE_ATOL,
                                       err_msg=name)
    if codec == "int8":
        # JAX's semantics: round() has a zero derivative and the scale
        # lanes are a bitcast, so no expert weight gets a gradient.
        for name in ("w_gate", "w_up", "w_down"):
            assert not ref[f"moe/int8/d{name}"].any() and not got[name].any()
    for name in ("router", "x"):
        assert np.abs(got[name]).max() > 0


def test_moe_fp8_grads_nan_fault_of_the_reference(ref):
    """JAX's fp8 encode (``src/repro/parallel/wirecodec.py:127-128``)
    clamps an all-zero row's scale with ``jnp.maximum``; the division's
    cotangent for that scale is ``0 * inf``, and the maximum's derivative
    keeps the NaN, which reaches every expert weight (an unused bucket
    slot is an all-zero row).  The port's clamp transposes as a select:
    its gradient is the finite one JAX gives with the clamp written as a
    ``where`` (``fixed_fp8_encode``).  The router's and the input's
    gradients never meet the NaN, and equal the faulty run's."""
    for name in ("w_gate", "w_up", "w_down"):
        assert np.isnan(ref[f"moe/fp8/d{name}"]).any(), name
    got = port_moe_grads(ref, "fp8")
    for name, g in got.items():
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, ref[f"moe/fp8_fixed/d{name}"],
                                   rtol=1e-4, atol=MOE_ATOL, err_msg=name)
    for name in ("router", "x"):
        np.testing.assert_allclose(got[name], ref[f"moe/fp8/d{name}"],
                                   rtol=1e-4, atol=MOE_ATOL, err_msg=name)
        assert np.abs(got[name]).max() > 0


# ---------------------------------------------------------------------------
# Training under a codec, and a trainer that repeats itself
# ---------------------------------------------------------------------------


def test_train_steps_under_bf16_match_jax(ref):
    cfg = get_reduced("olmoe-1b-7b", n_layers=parity.TRAIN_LAYERS)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, wire_codec="bf16", codec_tol=parity.CODEC_TOL))
    mesh = VirtualMesh((1, parity.MOE_EP), ("data", "model"), device="cpu")
    shape = ShapeConfig("train_4k", "train", parity.TRAIN_SEQ,
                        parity.TRAIN_BATCH)
    bundle = steps_mod.make_train_bundle(
        cfg, shape, mesh, sched=ScheduleConfig(**parity.sched_kwargs()))
    assert bundle.moe_plan.a2a.dtype == torch.bfloat16
    params = model_api.params_from_jax(subtree(ref, "train/params/"), "cpu")
    opt = model_api.opt_state_from_jax(subtree(ref, "train/opt/"), "cpu")
    data = SyntheticTokens(DataConfig(cfg.vocab_size, parity.TRAIN_SEQ,
                                      parity.TRAIN_BATCH, seed=1234))
    losses, gnorms = [], []
    for s in range(parity.N_STEPS):
        params, opt, m = bundle(params, opt,
                                {"tokens": torch.from_numpy(data.batch_at(s))},
                                s)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, ref["train/losses"], rtol=1e-4)
    np.testing.assert_allclose(gnorms, ref["train/grad_norms"], rtol=1e-4)
    for _, v in leaves_with_paths(params):
        assert torch.isfinite(v).all()


# One busy thread, for at most the given seconds: the load under which
# the unordered adds showed, without starving tests that run beside it.
_LOAD = """
import sys, time, torch
torch.set_num_threads(1)
a = torch.randn(384, 384)
end = time.time() + float(sys.argv[1])
while time.time() < end:
    a = torch.tanh(a @ a)
"""


def _losses_of_four_thread_run():
    from repro_torch.core import reset_global_plan_cache
    from repro_torch.parallel.sharding import RULE_PROFILES
    from repro_torch.train import Trainer, TrainerConfig

    reset_global_plan_cache()
    cfg = get_reduced("olmoe-1b-7b", n_layers=1)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, a2a_variant="fence_hierarchy"))
    mesh = VirtualMesh((2, 1, 4), ("pod", "data", "model"), device="cpu")
    bundle = steps_mod.make_train_bundle(
        cfg, ShapeConfig("train_4k", "train", 32, 8), mesh,
        sched=ScheduleConfig(kind="cosine", peak_lr=3e-4, warmup_steps=1,
                             total_steps=4, decay_steps=2),
        rules=RULE_PROFILES["hier_ep"])
    tr = Trainer(bundle, TrainerConfig(n_steps=4, log_every=100))
    tr.run()
    return [h["loss"] for h in tr.history]


def test_trainer_bit_reproducible_with_threads_under_load():
    """Two runs of the reduced trainer with 4 intra-op threads, while a
    second process loads the CPUs, give bit-equal losses at every step.
    The token embedding's backward used to add repeated tokens' rows with
    atomic adds across threads, and such runs differed in the last bit."""
    load = subprocess.Popen([sys.executable, "-c", _LOAD, "60"])
    n = torch.get_num_threads()
    try:
        torch.set_num_threads(4)
        first = _losses_of_four_thread_run()
        second = _losses_of_four_thread_run()
    finally:
        torch.set_num_threads(n)
        load.kill()
        load.wait()
    assert len(first) == 4 and np.isfinite(first).all()
    assert first == second
