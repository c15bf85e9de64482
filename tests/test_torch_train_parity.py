"""The port's training path against the JAX package, on the CPU.

One subprocess (``tests/_torch_parity_jax_train.py``, 8 host devices)
writes the JAX side once per test run; every case reads it.  The port runs
on ``VirtualMesh(..., device="cpu")``, where every kernel takes its plain
version.

Tolerances:

| compared value | tolerance |
|---|---|
| exchange vjp (identity embedded epoch, fence and lock; int8's zeros) | exact |
| first loss and its metrics | rtol 1e-5 |
| gradients (fp32), the MoE layer's and the model's | rtol 1e-4, atol 1e-6 |
| step 2-3 losses | rtol 1e-4 |
| synced gradients | exact without error feedback; the new residual within one int8 step |

``test_moe_grads_match_jax`` pins that the MoE body is differentiable:
every expert and router gradient exists and equals JAX's, and so does
the gradient of the layer's input.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity_jax_train as parity
from repro_torch._tree import leaves_with_paths
from repro_torch.configs import ShapeConfig, get_reduced
from repro_torch.core import alltoallv_init
from repro_torch.data.synthetic import DataConfig, SyntheticTokens
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.models import api as model_api
from repro_torch.models import moe
from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules
from repro_torch.train import ScheduleConfig
from repro_torch.train import grad as grad_util

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_train") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_parity_jax_train.py"),
         str(out)], capture_output=True, text=True, timeout=600, env=env,
        cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def subtree(ref, prefix: str) -> dict:
    """The arrays under ``prefix`` as a nested dict of numpy arrays."""
    tree: dict = {}
    for key, v in ref.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def flat(tree) -> dict:
    return dict(leaves_with_paths(tree))


# ---------------------------------------------------------------------------
# The exchange's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["fence", "lock"])
def test_identity_embedded_epoch_vjp_is_exact(ref, variant):
    p, rows, f = parity.VJP_P, parity.VJP_ROWS, parity.VJP_F
    mesh = VirtualMesh((p,), ("x",), device="cpu")
    plan = alltoallv_init(np.full((p, p), rows, np.int64), (f,), torch.float32,
                          mesh, axis="x", variant=variant, embeddable=True)
    assert plan.identity_maps
    x = torch.from_numpy(ref["vjp/x"]).requires_grad_(True)
    y = plan.embed()(x)
    assert y.grad_fn is not None
    (gx,) = torch.autograd.grad(y, x, torch.from_numpy(ref["vjp/cot"]).view(
        y.shape))
    np.testing.assert_array_equal(y.detach().reshape(-1, f).numpy(),
                                  ref[f"vjp/{variant}/y"])
    np.testing.assert_array_equal(gx.numpy(), ref[f"vjp/{variant}/gx"])


def test_codec_embedded_epoch_backward_raises(ref):
    """A lossy codec's embedded epoch differentiates as JAX's: under int8
    the ``round`` has a zero derivative and the inlined scale lanes are a
    bitcast, so the gradient is exactly JAX's zeros (a zero tensor, not
    none: the backward runs)."""
    p, rows, f = parity.CODEC_P, parity.CODEC_ROWS, parity.CODEC_F
    mesh = VirtualMesh((p,), ("x",), device="cpu")
    plan = alltoallv_init(np.full((p, p), rows, np.int64), (f,), torch.float32,
                          mesh, axis="x", codec="int8", error_tol=0.5 / 127,
                          embeddable=True)
    x = torch.from_numpy(ref["vjp/int8/x"]).requires_grad_(True)
    y = plan.embed()(x)
    y.sum().backward()
    want = ref["vjp/int8/gx"]
    assert not want.any()
    np.testing.assert_array_equal(x.grad.numpy(), want)


# ---------------------------------------------------------------------------
# The MoE layer's gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", parity.MOE_GRAD_CASES, ids=parity.moe_case_id)
def test_moe_grads_match_jax(ref, case):
    import dataclasses

    dispatch, variant, k = case
    olmoe = get_reduced("olmoe-1b-7b")
    mcfg = dataclasses.replace(olmoe.moe, dispatch=dispatch,
                               a2a_variant=variant, overlap_chunks=k)
    mesh = VirtualMesh((1, parity.EP), ("data", "model"), device="cpu")
    prm = {k2: torch.from_numpy(v).requires_grad_(True)
           for k2, v in subtree(ref, "moe/params/").items()}
    x = torch.from_numpy(ref["moe/x"]).requires_grad_(True)
    with axis_rules(DEFAULT_RULES, mesh):
        plan = moe.MoEDispatchPlan.build(mcfg, parity.MOE_TOKENS, mesh,
                                         d_model=olmoe.d_model,
                                         dtype=torch.float32)
        assert plan.plan_backed == (dispatch == "persistent_a2a")
        y, aux = moe.apply_moe(prm, x, mcfg, plan)
    obj = (y * torch.from_numpy(ref["moe/cot"])).sum() \
        + (aux * torch.from_numpy(ref["moe/aux_cot"])).sum()
    names = ("router", "w_gate", "w_up", "w_down")
    grads = torch.autograd.grad(obj, [prm[n] for n in names] + [x],
                                allow_unused=True)
    tag = f"moe/{parity.moe_case_id(case)}"
    for name, g in zip(names + ("x",), grads):
        assert g is not None, name
        want = ref[f"{tag}/d{name}"]
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# The training step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_train(ref):
    cfg = get_reduced("olmoe-1b-7b", n_layers=parity.N_LAYERS)
    mesh = VirtualMesh((1, parity.EP), ("data", "model"), device="cpu")
    shape = ShapeConfig("train_4k", "train", parity.SEQ, parity.BATCH)
    bundle = steps_mod.make_train_bundle(
        cfg, shape, mesh, sched=ScheduleConfig(**parity.sched_kwargs()))
    params = model_api.params_from_jax(subtree(ref, "train/params/"), "cpu")
    opt = model_api.opt_state_from_jax(subtree(ref, "train/opt/"), "cpu")
    return cfg, bundle, params, opt


def test_train_plan_geometry_needs_no_padding(ref, port_train):
    _, bundle, _, _ = port_train
    plan = bundle.meta["moe_plan"]
    assert [plan.tokens_per_shard, plan.capacity] == list(ref["train/plan"])
    assert plan.tokens_per_shard * parity.EP == parity.BATCH * parity.SEQ


def test_first_loss_metrics_and_grads_match_jax(ref, port_train):
    cfg, bundle, params, _ = port_train
    batch = {"tokens": torch.from_numpy(ref["train/tokens0"])}

    def loss_fn(p, b):
        return model_api.model_loss(p, cfg, b, moe_plan=bundle.moe_plan,
                                    remat=True)

    with bundle.trace_context():
        loss, metrics, grads = grad_util.value_and_grad(loss_fn, params, batch)
    np.testing.assert_allclose(float(loss), ref["train/loss0"], rtol=1e-5)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), ref[f"train/metrics0/{k}"],
                                   rtol=1e-5, err_msg=k)
    want = flat(subtree(ref, "train/grads/"))
    got = flat(grads)
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    for key in [k for k in got if "/moe/" in k]:
        assert np.abs(got[key].numpy()).max() > 0, key


def test_three_steps_match_jax_losses(ref, port_train):
    _, bundle, _, _ = port_train
    # Fresh state: the step updates it in place.
    params = model_api.params_from_jax(subtree(ref, "train/params/"), "cpu")
    opt = model_api.opt_state_from_jax(subtree(ref, "train/opt/"), "cpu")
    data = SyntheticTokens(DataConfig(bundle.meta["cfg"].vocab_size,
                                      parity.SEQ, parity.BATCH, seed=1234))
    losses, gnorms = [], []
    for s in range(parity.N_STEPS):
        params, opt, m = bundle(params, opt,
                                {"tokens": torch.from_numpy(data.batch_at(s))}, s)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses[0], ref["train/losses"][0], rtol=1e-5)
    np.testing.assert_allclose(losses, ref["train/losses"], rtol=1e-4)
    np.testing.assert_allclose(gnorms, ref["train/grad_norms"], rtol=1e-4)
    assert int(opt["count"]) == parity.N_STEPS


# ---------------------------------------------------------------------------
# Gradient syncs
# ---------------------------------------------------------------------------


def _sync_inputs():
    g, e = parity.sync_tree()
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(v)
                      for k, v in t.items()}
    return to_t(g), to_t(e)


def test_persistent_rs_sync_matches_jax_exactly(ref):
    mesh = VirtualMesh((2, 4), ("data", "model"), device="cpu")
    g, _ = _sync_inputs()
    out = flat(grad_util.persistent_rs_sync(mesh, ("data",))(g))
    want = flat(subtree(ref, "sync/rs/"))
    for key, v in out.items():
        np.testing.assert_array_equal(v.numpy(), want[key], err_msg=key)
    for key, v in flat(g).items():     # two equal addends, halved: exact
        np.testing.assert_array_equal(out[key].numpy(), v.numpy())


@pytest.mark.parametrize("tag", ["rs_ef", "comp_ef", "comp"])
def test_error_feedback_syncs_match_jax(ref, tag):
    mesh = VirtualMesh((2, 4), ("data", "model"), device="cpu")
    g, e = _sync_inputs()
    if tag == "comp":
        e = {k: (torch.zeros_like(v) if not isinstance(v, dict) else
                 {k2: torch.zeros_like(v2) for k2, v2 in v.items()})
             for k, v in e.items()}
    fn = (grad_util.persistent_rs_sync(mesh, ("data",), error_feedback=True)
          if tag == "rs_ef" else grad_util.compressed_sync(mesh, ("data",)))
    synced, new_err = fn(g, e)
    want_g = flat(subtree(ref, f"sync/{tag}/g/"))
    want_e = flat(subtree(ref, f"sync/{tag}/err/"))
    for key, v in flat(synced).items():
        np.testing.assert_array_equal(v.numpy(), want_g[key], err_msg=key)
    carry = {k: v.numpy() + flat(e)[k].numpy() for k, v in flat(g).items()}
    for key, v in flat(new_err).items():
        step = max(np.abs(carry[key]).max(), 1e-12) / 127.0
        assert np.abs(v.numpy() - want_e[key]).max() <= step, key
