"""The port's MoE layer on every mesh the JAX package takes, on the CPU: a
data axis > 1 (``(2, 4)`` under ``DEFAULT_RULES``) and hierarchical EP
over ``("pod", "model")`` (``(2, 2, 2)`` and ``(2, 1, 4)`` under
``HIER_EP_RULES``), against the JAX package; and the training, serving and
example entry points on those meshes.

One subprocess (``tests/_torch_parity_jax_moe_mesh.py``, 8 host devices)
writes the JAX side once per test run; every case reads it.  The port runs
on ``VirtualMesh(..., device="cpu")``, where every kernel takes its plain
version.

Tolerances (as in ``tests/test_torch_train_parity.py``):

| compared value | tolerance |
|---|---|
| exchanges and their vjp (grouped embed, hierarchy against flat fence, pack impls, overlap depths) | exact |
| layer output and aux, first loss | rtol 1e-5 |
| gradients (router, experts, layer input) | rtol 1e-4, atol 1e-6 |
| later losses and gradient norms | rtol 1e-4 |
| a resumed run's losses against the uninterrupted run's | rtol 1e-2 |
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity_jax_moe_mesh as parity
from repro_torch.configs import ShapeConfig, get_reduced
from repro_torch.core import PlanCache, alltoallv_init
from repro_torch.data.synthetic import DataConfig, SyntheticTokens
from repro_torch.kernels import _build
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.models import api as model_api
from repro_torch.models import moe
from repro_torch.parallel.sharding import (DEFAULT_RULES, RULE_PROFILES,
                                           axis_rules, batch_ways)
from repro_torch.train import ScheduleConfig, Trainer, TrainerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("router", "w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_moe_mesh") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_parity_jax_moe_mesh.py"),
         str(out)], capture_output=True, text=True, timeout=600, env=env,
        cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def subtree(ref, prefix: str) -> dict:
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


def mesh_of(name: str):
    shape, axes, rules = parity.MESHES[name]
    return VirtualMesh(shape, axes, device="cpu"), RULE_PROFILES[rules]


def layer_inputs(seed: int = 11):
    """The layer's parameters and tokens, drawn here from a seed (for the
    port-only cases), as the JAX side draws its own."""
    olmoe = get_reduced("olmoe-1b-7b")
    gen = torch.Generator().manual_seed(seed)
    d, m = olmoe.d_model, olmoe.moe
    prm = {"router": torch.randn(d, m.n_experts, generator=gen) * d ** -0.5,
           "w_gate": torch.randn(m.n_experts, d, m.d_expert, generator=gen)
           * d ** -0.5,
           "w_up": torch.randn(m.n_experts, d, m.d_expert, generator=gen)
           * d ** -0.5,
           "w_down": torch.randn(m.n_experts, m.d_expert, d, generator=gen)
           * m.d_expert ** -0.5}
    b, s = parity.LAYER_SHAPE
    x = torch.randn(b, s, d, generator=gen)
    cot = torch.randn(b, s, d, generator=gen) / (b * s)
    return prm, x, cot, torch.tensor([0.5, -0.25])


def run_layer(name, variant, k, prm, x, cot, aux_cot, *, pack_impl="jnp",
              plan_backed=True):
    """The MoE layer on mesh ``name``: (y, aux, gradients of
    ``sum(y * cot) + sum(aux * aux_cot)`` by NAMES + x, the plan)."""
    olmoe = get_reduced("olmoe-1b-7b")
    mcfg = dataclasses.replace(olmoe.moe, a2a_variant=variant,
                               overlap_chunks=k)
    mesh, rules = mesh_of(name)
    prm = {n: v.detach().clone().requires_grad_(True) for n, v in prm.items()}
    x = x.detach().clone().requires_grad_(True)
    b, s, d = x.shape
    with axis_rules(rules, mesh):
        plan = moe.MoEDispatchPlan.build(
            mcfg, b * s // batch_ways(b * s, mesh), mesh, d_model=d,
            dtype=torch.float32, pack_impl=pack_impl,
            plan_backed=plan_backed, cache=PlanCache())
        y, aux = moe.apply_moe(prm, x, mcfg, plan)
    obj = (y * cot).sum() + (aux * aux_cot).sum()
    grads = torch.autograd.grad(obj, [prm[n] for n in NAMES] + [x])
    return y.detach(), aux.detach(), grads, plan


# ---------------------------------------------------------------------------
# The layer against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", parity.LAYER_CASES, ids=parity.case_id)
def test_layer_matches_jax(ref, case):
    name, variant, k = case
    prm = {n: torch.from_numpy(v) for n, v in
           subtree(ref, "layer/params/").items()}
    y, aux, grads, plan = run_layer(
        name, variant, k, prm, torch.from_numpy(ref["layer/x"]),
        torch.from_numpy(ref["layer/cot"]),
        torch.from_numpy(ref["layer/aux_cot"]))
    tag = f"layer/{parity.case_id(case)}"
    assert [plan.ep_size, plan.tokens_per_shard, plan.capacity,
            plan.overlap_chunks] == list(ref[f"{tag}/plan"])
    assert plan.variant == str(ref[f"{tag}/variant"])
    if name != "2x4":
        assert plan.axis == plan.hier_axes == ("pod", "model")
    np.testing.assert_allclose(y.numpy(), ref[f"{tag}/y"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(aux.numpy(), ref[f"{tag}/aux"], rtol=1e-5)
    for n, g in zip(NAMES + ("x",), grads):
        want = ref[f"{tag}/d{n}"]
        assert np.abs(want).max() > 0, n
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-6,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# Port-only: exact equalities between the port's own paths
# ---------------------------------------------------------------------------


def assert_same(a, b):
    ya, auxa, ga, _ = a
    yb, auxb, gb, _ = b
    assert torch.equal(ya, yb) and torch.equal(auxa, auxb)
    for n, u, v in zip(NAMES + ("x",), ga, gb):
        assert torch.equal(u, v), n


@pytest.mark.parametrize("name", ["2x2x2", "2x1x4"])
def test_hierarchy_bit_equal_to_flat_fence(name):
    """Over the same (pod, model) pair the hierarchy's output and vjp are
    the flat fence's, bit for bit: on the uniform MoE pattern the
    leader-combined epoch moves the rows the flat all-to-all moves, and
    its backward is the same epoch on the cotangent."""
    inputs = layer_inputs()
    hier = run_layer(name, "fence_hierarchy", 1, *inputs)
    assert hier[3].variant == "fence_hierarchy"
    assert hier[3].a2a.hier_schedule is not None
    assert_same(hier, run_layer(name, "fence", 1, *inputs))


def test_hierarchy_pack_impls_equal_and_fused_runs_k5():
    """``pack_impl`` "fused" (K1, K2, K5) equals "pallas" (K1, K2) and
    "jnp" (K2) bit for bit on (2, 2, 2), forward and backward; K5's plain
    version runs in both."""
    inputs = layer_inputs()
    out = {}
    for impl in ("jnp", "pallas", "fused"):
        _build.reset_counts()
        out[impl] = run_layer("2x2x2", "fence_hierarchy", 1, *inputs,
                              pack_impl=impl)
        calls = {k: v["plain_calls"] for k, v in _build.counts().items()
                 if v["plain_calls"]}
        # Per exchange two K2 hops (all data shards in one launch each);
        # forward and backward: two exchanges each.
        assert calls["a2a_fence"] == 8, (impl, calls)
        assert calls.get("a2a_hier", 0) == (4 if impl == "fused" else 0)
        assert (calls.get("gather_rows", 0) > 0) == (impl != "jnp")
    assert_same(out["fused"], out["jnp"])
    assert_same(out["pallas"], out["jnp"])


@pytest.mark.parametrize("case", [("2x4", "fence", 4), ("2x4", "lock", 2),
                                  ("2x2x2", "fence_hierarchy", 2),
                                  ("2x1x4", "fence_hierarchy", 3)],
                         ids=parity.case_id)
def test_overlap_depths_bit_equal_to_depth_one(case):
    """Every depth gives depth 1's output, aux losses, router gradient and
    layer-input gradient bit for bit: the chunks partition the capacity
    axis and every row takes the same ops.  An expert weight's gradient is
    a sum over the rows, which a depth-k backward adds up as k partial
    products, so it equals depth 1's within the fp32 rounding of that
    order (the gradient tolerance).  (2x4 at depth 4 takes depth 3, the
    largest that splits its capacity of 24 into tile-aligned chunks.)"""
    name, variant, k = case
    inputs = layer_inputs()
    deep = run_layer(name, variant, k, *inputs)
    one = run_layer(name, variant, 1, *inputs)
    assert deep[3].overlap_chunks == min(k, 3)
    assert torch.equal(deep[0], one[0]) and torch.equal(deep[1], one[1])
    for n, u, v in zip(NAMES + ("x",), deep[2], one[2]):
        if n in ("router", "x"):
            assert torch.equal(u, v), n
        else:
            np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=n)


def test_table_free_exchange_equals_plan_backed():
    """``plan_backed=False`` (the table-free exchange over the data groups)
    equals the plan-backed layer, for the fence and the hierarchy."""
    inputs = layer_inputs()
    for name, variant in (("2x4", "fence"), ("2x2x2", "fence_hierarchy")):
        bare = run_layer(name, variant, 1, *inputs, plan_backed=False)
        assert not bare[3].plan_backed
        assert_same(bare, run_layer(name, variant, 1, *inputs))


def test_data_shards_route_and_pad_on_their_own():
    """Padding is per data shard: 2 x 200 tokens on (2, 4) (t_loc 56, 24
    padding rows per shard) give each shard's output and gradients of
    running it alone on (1, 4) with the same plan geometry, and the aux
    losses are the mean over the shards.  This pins the port's routing,
    which ranks within expert among valid entries only (ROADMAP.md queue
    3: the JAX package ranks padding too)."""
    prm, x, cot, aux_cot = layer_inputs()
    x, cot = x[:, :200], cot[:, :200]
    y, aux, grads, plan = run_layer("2x4", "fence", 1, prm, x, cot, aux_cot)
    assert plan.tokens_per_shard * plan.ep_size - 200 == 24
    mesh = VirtualMesh((1, 4), ("data", "model"), device="cpu")
    mcfg = get_reduced("olmoe-1b-7b").moe
    ys, auxs, gparams, gx = [], [], None, []
    for r in range(2):
        p = {n: v.clone().requires_grad_(True) for n, v in prm.items()}
        xr = x[r:r + 1].clone().requires_grad_(True)
        with axis_rules(DEFAULT_RULES, mesh):
            alone = moe.MoEDispatchPlan.build(mcfg, 200, mesh, d_model=128,
                                              dtype=torch.float32,
                                              cache=PlanCache())
            assert alone.tokens_per_shard == plan.tokens_per_shard
            yr, ar = moe.apply_moe(p, xr, mcfg, alone)
        ys.append(yr.detach())
        auxs.append(ar.detach())
        g = torch.autograd.grad((yr * cot[r:r + 1]).sum()
                                + (ar * aux_cot).sum() / 2,
                                [p[n] for n in NAMES] + [xr])
        gparams = (list(g[:4]) if gparams is None
                   else [a + b for a, b in zip(gparams, g[:4])])
        gx.append(g[4])
    np.testing.assert_allclose(y.numpy(), torch.cat(ys).numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(aux.numpy(), (auxs[0] + auxs[1]).numpy() / 2,
                               rtol=1e-6)
    for n, got, want in zip(NAMES + ("x",), grads,
                            gparams + [torch.cat(gx)]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


# ---------------------------------------------------------------------------
# The grouped embedded epoch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["fence", "lock", "fence_hierarchy"])
def test_grouped_embed_is_each_group_alone(variant):
    """``plan.embed(groups=2)`` on ``[2*P, ...]`` is the one-group epoch
    on each half; the fence takes one K2 launch for both groups, the
    hierarchy one per hop, the lock one K4 epoch per group; the vjp is
    exact."""
    mesh = VirtualMesh((2, 2, 4), ("data", "o", "i"), device="cpu")
    axis = ("o", "i") if variant == "fence_hierarchy" else "i"
    p = 8 if variant == "fence_hierarchy" else 4
    plan = alltoallv_init(np.full((p, p), 16, np.int64), (6,), torch.float32,
                          mesh, axis=axis, variant=variant, embeddable=True,
                          cache=PlanCache())
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2 * p, p * 16, 6, generator=gen, requires_grad=True)
    _build.reset_counts()
    y = plan.embed(2)(x)
    calls = {k: v["plain_calls"] for k, v in _build.counts().items()
             if v["plain_calls"]}
    want = {"fence": {"a2a_fence": 1}, "lock": {"a2a_lock": 2},
            "fence_hierarchy": {"a2a_fence": 2}}[variant]
    assert calls == want
    alone = torch.cat([plan.embed()(x[:p]), plan.embed()(x[p:])])
    assert torch.equal(y, alone)
    cot = torch.randn(y.shape, generator=gen)
    (g,) = torch.autograd.grad(y, x, cot)
    (g1,) = torch.autograd.grad(alone, x, cot)
    assert torch.equal(g, g1)


@pytest.mark.parametrize("impl", ["pallas", "fused"])
def test_grouped_hierarchy_with_run_tables(monkeypatch, impl):
    """On a card the grouped hierarchy's K1 packs read run tables baked from
    the tiled tables; with them bound here (the helper a card answers
    true), two groups still give the flat fence's rows."""
    from repro_torch.core import plan as plan_mod
    monkeypatch.setattr(plan_mod, "bakes_run_tables", lambda dev, rb: True)
    mesh = VirtualMesh((2, 2, 4), ("data", "o", "i"), device="cpu")
    counts = np.full((8, 8), 16, np.int64)
    hier = alltoallv_init(counts, (4,), torch.float32, mesh, axis=("o", "i"),
                          variant="fence_hierarchy", pack_impl=impl,
                          embeddable=True, cache=PlanCache())
    flat = alltoallv_init(counts, (4,), torch.float32, mesh, axis=("o", "i"),
                          embeddable=True, cache=PlanCache())
    x = torch.randn(16, 8 * 16, 4, generator=torch.Generator().manual_seed(4))
    assert torch.equal(hier.embed(2)(x), flat.embed(2)(x))
    packs = hier._hier_body(2)[2]
    assert all(p.keywords["runs"] is not None for p in packs)


def test_non_uniform_hierarchy_backward_still_raises(ref):
    """Only the uniform full pattern's hierarchy epoch is self-adjoint; on a
    ragged pattern the backward is the transposed flat epoch (the flat
    alltoallv of the transposed counts, from the inverse tables), equal to
    JAX's ``jax.vjp`` by value.  ``groups`` > 1 is refused for
    table-driven bodies other than the hierarchy."""
    mesh = VirtualMesh((2, 4), ("o", "i"), device="cpu")
    plan = alltoallv_init(parity.hier_vjp_counts(), (4,), torch.float32,
                          mesh, axis=("o", "i"), variant="fence_hierarchy",
                          embeddable=True, cache=PlanCache())
    assert not plan.uniform_full
    x = torch.from_numpy(ref["hier_vjp/x"]).requires_grad_(True)
    y = plan.embed()(x)
    (gx,) = torch.autograd.grad(
        y, x, torch.from_numpy(ref["hier_vjp/cot"]).view(y.shape))
    np.testing.assert_array_equal(y.detach().reshape(-1, 4).numpy(),
                                  ref["hier_vjp/y"])
    np.testing.assert_array_equal(gx.numpy(), ref["hier_vjp/gx"])
    flat = alltoallv_init(parity.hier_vjp_counts(), (4,), torch.float32,
                          VirtualMesh((8,), ("x",), device="cpu"), axis="x",
                          embeddable=True, cache=PlanCache())
    with pytest.raises(ValueError, match="groups"):
        flat.embed(2)


# ---------------------------------------------------------------------------
# Training and serving entry points
# ---------------------------------------------------------------------------


def test_train_steps_match_jax(ref):
    """``examples/train_moe_ep.py``'s setup on (2, 4): the plan geometry,
    three steps' losses and gradient norms of the train bundle against
    JAX's, from JAX's initial state."""
    cfg = get_reduced("olmoe-1b-7b")
    mesh, rules = mesh_of("2x4")
    shape = ShapeConfig("moe_ep", "train", parity.SEQ, parity.BATCH)
    bundle = steps_mod.make_train_bundle(
        cfg, shape, mesh, sched=ScheduleConfig(**parity.sched_kwargs()),
        rules=rules)
    plan = bundle.moe_plan
    assert [plan.ep_size, plan.tokens_per_shard, plan.capacity] == list(
        ref["train/plan"])
    params = model_api.params_from_jax(subtree(ref, "train/params/"), "cpu")
    opt = model_api.opt_state_from_jax(subtree(ref, "train/opt/"), "cpu")
    data = SyntheticTokens(DataConfig(cfg.vocab_size, parity.SEQ,
                                      parity.BATCH, seed=1234))
    losses, gnorms = [], []
    for s in range(parity.N_STEPS):
        params, opt, m = bundle(params, opt,
                                {"tokens": torch.from_numpy(data.batch_at(s))},
                                s)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses[0], ref["train/losses"][0], rtol=1e-5)
    np.testing.assert_allclose(losses, ref["train/losses"], rtol=1e-4)
    np.testing.assert_allclose(gnorms, ref["train/grad_norms"], rtol=1e-4)


@pytest.mark.parametrize("name,variant", [("2x4", "fence"),
                                          ("2x1x4", "fence_hierarchy")])
def test_train_checkpoint_resume(tmp_path, name, variant):
    """A reduced train on the mesh, checkpointed at step 2 and resumed by a
    fresh Trainer: steps 2-3 within 1e-2 of the uninterrupted run."""
    cfg = get_reduced("olmoe-1b-7b", n_layers=2)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, a2a_variant=variant))
    mesh, rules = mesh_of(name)
    bundle = steps_mod.make_train_bundle(
        cfg, ShapeConfig("moe_ep", "train", 64, 4), mesh, rules=rules,
        sched=ScheduleConfig(kind="wsd", peak_lr=3e-3, warmup_steps=1,
                             total_steps=4, decay_steps=1))
    assert bundle.moe_plan.variant == variant

    def trainer(steps, ckpt):
        return Trainer(bundle, TrainerConfig(
            n_steps=steps, ckpt_dir=str(tmp_path) if ckpt else None,
            ckpt_every=2, log_every=1, async_ckpt=False))

    full = trainer(4, False)
    full.run()
    first = {h["step"]: h["loss"] for h in full.history}
    writer = trainer(2, True)
    writer.run()
    writer.close()
    resumed = trainer(4, True)
    assert resumed.try_resume() and resumed.start_step == 2
    resumed.run()
    resumed.close()
    again = {h["step"]: h["loss"] for h in resumed.history}
    assert sorted(again) == [2, 3]
    for s, v in again.items():
        assert abs(v - first[s]) <= 1e-2 * abs(first[s]), (s, v, first[s])


@pytest.mark.parametrize("args", [
    ["--mesh", "2,4"],
    ["--rules", "hier_ep", "--a2a-variant", "fence_hierarchy",
     "--mesh", "2,2,2"]], ids=["2x4", "hier_ep-2x2x2"])
def test_launch_train_on_the_mesh(args):
    from repro_torch.launch import train as train_launch
    result = train_launch.main(
        ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu", "--steps",
         "2", "--seq-len", "64", "--global-batch", "4", "--log-every", "1"]
        + args)
    assert result["final_step"] == 2


def test_launch_serve_on_2x4_matches_1x8(capsys):
    """``launch.serve --mesh 2,4`` generates; with nothing dropped by the
    capacity at this size, its greedy tokens are those of ``--mesh 1,8``."""
    from repro_torch.launch import serve as serve_launch
    common = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
              "--batch", "2", "--prompt-len", "16", "--tokens", "4"]
    toks = []
    for mesh in ("2,4", "1,8"):
        serve_launch.main(common + ["--mesh", mesh])
        first, rest = capsys.readouterr().out.split("\n", 1)
        assert first.startswith("generated (2, 4)"), first
        toks.append(rest)
    assert toks[0] == toks[1]


def test_example_twin_trains_three_steps(capsys):
    """``examples/train_moe_ep_torch.py 3 --device cpu``: the (2, 4) plan
    and three steps."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "train_moe_ep_torch", os.path.join(ROOT, "examples",
                                           "train_moe_ep_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    trainer = mod.main(["3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "EP=4, 2 experts/shard" in out and "finished at step 3" in out
    assert len(trainer.history) == 3
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
