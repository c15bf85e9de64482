"""The port's MoE layer and kernel K6 against the JAX package, on the CPU.

K6 (``kernels.gather_matmul``, through ``ops.fused_unpack_matmul``) is held
against the interpreted Pallas kernel and the JAX jnp path in this
process, and its ``autograd.Function`` against ``jax.grad``; ``_route``
against JAX's ``_route``.  ``apply_moe`` is held against JAX's on a
``(1, P)`` ("data", "model") mesh of 8 host devices, run once per test run
in the subprocess ``tests/_torch_parity_jax_moe.py moe``; the port runs on
``VirtualMesh((1, P), ("data", "model"), device="cpu")``, where every
kernel takes its plain version.

Tolerances: K6 and its gradients within 1e-5 (float32, sums in another
order); ``_route``'s slots, keep masks and counts bit for bit, its
weights bit for bit where the softmax is exact (logits 0 or -200) and
within 1e-6 elsewhere, since XLA's and PyTorch's ``exp`` differ in the
last bit, and its aux losses (sums over tokens) within 1e-6; ``apply_moe`` within ``rtol=2e-4, atol=2e-5``, as
the dist case ``moe_plan_backed_parity`` holds the JAX dispatch paths.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity_jax_moe as parity
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.core import INIT_STATS, PlanCache, alltoallv_init
from repro_torch.kernels import _build, gather_matmul as gm, ops
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.models import moe
from repro_torch.parallel import wirecodec
from repro_torch.planstore import PlanStore
from repro_torch.parallel.sharding import (DEFAULT_RULES, HIER_EP_RULES,
                                         ParamFactory, axis_rules)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_moe") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_parity_jax_moe.py"),
         "moe", str(out)], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


def k6_inputs(e, n, d, f, seed=0):
    """Source rows with repeated indices and zeros in the mask."""
    rng = np.random.default_rng(seed)
    r = 2 * n + 3
    x = rng.standard_normal((r, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    idx = rng.integers(0, r, (e, n)).astype(np.int32)
    idx[:, ::3] = idx[:, :1]
    valid = rng.random((e, n)) < 0.75
    valid[0, 0] = False
    return x, idx, valid, w


K6_SHAPES = [(1, 8, 128, 128), (2, 16, 100, 72), (4, 32, 128, 72), (3, 24, 100, 128)]


@pytest.mark.parametrize("shape", K6_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k6_matches_interpreted_pallas(shape):
    """The port's op against the Pallas kernel in interpret mode (reached
    through ``ops.fused_unpack_matmul(interpret=True)``, which pads D and F
    to 128 lanes as on a TPU) and against the op's jnp path."""
    x, idx, valid, w = k6_inputs(*shape)
    got = ops.fused_unpack_matmul(torch.from_numpy(x), torch.from_numpy(idx),
                                  torch.from_numpy(w),
                                  torch.from_numpy(valid)).numpy()
    pallas = np.asarray(jops.fused_unpack_matmul(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w),
        jnp.asarray(valid.astype(np.int32)), interpret=True))
    jnp_path = np.asarray(jops.fused_unpack_matmul(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w),
        jnp.asarray(valid.astype(np.int32))))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, jnp_path, rtol=0, atol=1e-5)
    assert not got[~valid].any()


def test_k6_scales_fold_as_jax():
    """``scales`` (a codec's per-row dequant factors) pre-scale x, as the
    JAX kernel path does; the values equal the jnp path's."""
    x, idx, valid, w = k6_inputs(2, 16, 100, 72, seed=1)
    sc = np.random.default_rng(2).random((x.shape[0], 1)).astype(np.float32)
    got = ops.fused_unpack_matmul(torch.from_numpy(x), torch.from_numpy(idx),
                                  torch.from_numpy(w), torch.from_numpy(valid),
                                  scales=torch.from_numpy(sc)).numpy()
    want = np.asarray(jops.fused_unpack_matmul(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w),
        jnp.asarray(valid.astype(np.int32)), scales=jnp.asarray(sc)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_k6_invalid_rows_are_plus_zero_with_nan_sources():
    """A NaN or inf in a source row that only invalid entries reference does
    not reach the output: invalid rows are +0.0 by selection (the Pallas
    kernel multiplies by the mask and would give NaN)."""
    x, idx, valid, w = k6_inputs(4, 32, 100, 72, seed=3)
    x = np.concatenate([x, np.full((2, x.shape[1]), np.nan, np.float32)])
    x[-1] = np.inf
    idx[~valid] = np.where(np.arange((~valid).sum()) % 2, x.shape[0] - 1,
                           x.shape[0] - 2)
    got = gm.gather_matmul(torch.from_numpy(x), torch.from_numpy(idx),
                           torch.from_numpy(valid), torch.from_numpy(w)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[~valid].view(np.uint32), 0)


@pytest.mark.parametrize("interpret", [True, None], ids=["custom_vjp", "jnp"])
def test_k6_gradient_matches_jax(interpret):
    """K6's ``autograd.Function`` backward against ``jax.grad`` of
    ``fused_unpack_matmul``: the kernel path's custom VJP (interpret mode)
    and the jnp path's autodiff."""
    x, idx, valid, w = k6_inputs(3, 16, 100, 72, seed=4)
    ct = np.random.default_rng(5).standard_normal((3, 16, 72)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = gm.gather_matmul(xt, torch.from_numpy(idx), torch.from_numpy(valid), wt)
    (out * torch.from_numpy(ct)).sum().backward()

    def loss(xx, ww):
        y = jops.fused_unpack_matmul(xx, jnp.asarray(idx), ww,
                                     jnp.asarray(valid.astype(np.int32)),
                                     interpret=interpret)
        return (y * ct).sum()

    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw), rtol=0, atol=1e-5)


def test_k6_wrapper_takes_no_fallback():
    """The plain version is taken only for CPU tensors: ``meta`` tensors
    take the shape path (no launch, no plain call), and a ``meta`` tensor
    beside CPU ones raises."""
    t = torch.empty((8, 4), device="meta")
    i = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    v = torch.zeros((2, 8), dtype=torch.bool, device="meta")
    w = torch.empty((2, 4, 3), device="meta")
    before = dict(_build.counts()["gather_matmul"])
    out = gm.gather_matmul_kernel(t, i, v, w)
    assert out.shape == (2, 8, 3) and out.device.type == "meta"
    assert _build.counts()["gather_matmul"] == before
    with pytest.raises(ValueError, match="CUDA"):
        gm.gather_matmul_kernel(t, torch.zeros((2, 8), dtype=torch.int32),
                                torch.zeros((2, 8), dtype=torch.bool), w)
    assert _build.counts()["gather_matmul"] == before


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _both_routes(x, router, valid, k, e, cap):
    j = jmoe._route(jnp.asarray(x), jnp.asarray(router), jnp.asarray(valid),
                    k, e, cap)
    t = moe._route(torch.from_numpy(x), torch.from_numpy(router),
                   torch.from_numpy(valid), k, e, cap)
    return j, t


@pytest.mark.parametrize("k", [1, 2, 8])
def test_route_matches_jax(k):
    """Random logits, no padding: slots, keep mask and counts bit for bit,
    weights and aux within 1e-6."""
    rng = np.random.default_rng(k)
    t, d, e = 64, 32, 16
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * 0.3).astype(np.float32)
    cap = 4 * k          # the mean load per expert: some experts overflow
    (js, jk, jw, jc, jaux), (ts, tk, tw, tc, taux) = _both_routes(
        x, router, np.ones(t, bool), k, e, cap)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tk.numpy().sum() < t * k, "capacity must drop some entries"
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    for a, b in zip(taux, jaux):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 8])
def test_route_bit_exact_with_exact_softmax(k):
    """Logits of exactly 0 on k+1 experts per token and -200 elsewhere: the
    softmax is exact in both packages, so slots, keep mask, weights and
    counts are equal bit for bit, including the ties, which go to the
    lower expert.  The aux losses are sums over tokens, which XLA and
    PyTorch take in another order: within 1e-6."""
    rng = np.random.default_rng(10 + k)
    t, e = 64, 16
    x = -np.ones((t, e), np.float32)
    for i in range(t):
        x[i, rng.choice(e, k + 1, replace=False)] = 0.0
    router = 200.0 * np.eye(e, dtype=np.float32)
    (js, jk, jw, jc, jaux), (ts, tk, tw, tc, taux) = _both_routes(
        x, router, np.ones(t, bool), k, e, 8)
    for got, want in ((ts, js), (tk, jk), (tw, jw), (tc, jc)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(taux, jaux):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def rank_within_expert_oracle(flat_e, flat_valid, cap):
    """Keep an entry iff it is valid and fewer than ``cap`` valid entries of
    its expert precede it in token order."""
    seen: dict = {}
    keep = np.zeros(flat_e.shape, bool)
    for i, (ex, ok) in enumerate(zip(flat_e, flat_valid)):
        if ok:
            keep[i] = seen.get(ex, 0) < cap
            seen[ex] = seen.get(ex, 0) + 1
    return keep


@pytest.mark.parametrize("case", [(16, 10, 8, 2, 4), (8, 4, 64, 8, 8)],
                         ids=["16tok-10valid-E8-k2-cap4", "olmoe-decode-rank0"])
def test_route_padding_fault_of_the_reference(case):
    """The reference's ``_route`` (``repro/models/moe.py:295-304``) ranks
    padding entries among valid ones but builds ``starts`` from valid
    counts, so valid entries of higher experts are pushed past capacity.
    On a chunk with padding it keeps fewer valid entries than the port,
    whose keep mask is the rank-within-expert oracle's."""
    t, n_valid, e, k, cap = case
    rng = np.random.default_rng(7)
    d = 32
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    valid = np.arange(t) < n_valid
    (_, jk, _, jc, _), (ts, tk, _, tc, _) = _both_routes(x, router, valid, k, e, cap)
    flat_e = (ts.numpy() // cap)
    # dropped entries' slot is the overflow row; recover their expert from
    # the top-k of the port's own probabilities
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(router), -1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    flat_e = top.reshape(-1).numpy()
    oracle = rank_within_expert_oracle(flat_e, np.repeat(valid, k), cap)
    np.testing.assert_array_equal(tk.numpy(), oracle)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(np.asarray(jk).sum()) < int(oracle.sum()), (
        int(np.asarray(jk).sum()), int(oracle.sum()))


# ---------------------------------------------------------------------------
# apply_moe against the JAX package
# ---------------------------------------------------------------------------


def moe_params(jax_ref, pattern):
    p = {k[len("params/"):]: torch.from_numpy(v.copy())
         for k, v in jax_ref.items() if k.startswith("params/")}
    p["router"] = torch.from_numpy(jax_ref[f"{pattern}/router"].copy())
    return p


def port_apply_moe(jax_ref, p, pattern, dispatch, variant, k, cf, tokens=None,
                   overlap=None):
    base = MoEConfig(n_experts=parity.N_EXPERTS, top_k=2, d_expert=32,
                     dispatch=dispatch, a2a_variant=variant, overlap_chunks=k,
                     capacity_factor=cf)
    x = torch.from_numpy(jax_ref[f"{pattern}/x"].copy())
    if tokens is not None:
        x = x[:tokens]
    t = x.shape[0]
    mesh = VirtualMesh((1, p), ("data", "model"), device="cpu")
    with axis_rules(DEFAULT_RULES, mesh):
        plan = moe.MoEDispatchPlan.build(base, t, mesh, d_model=parity.D_MODEL,
                                         dtype=torch.float32, cache=PlanCache(),
                                         overlap_chunks=overlap)
        y, aux = moe.apply_moe(moe_params(jax_ref, pattern),
                               x.view(1, t, parity.D_MODEL), base, plan)
    return plan, y.view(t, parity.D_MODEL), aux


@pytest.mark.parametrize("case", parity.MOE_CASES, ids=parity.moe_case_id)
def test_apply_moe_matches_jax(jax_ref, case):
    """Dense/banded/skewed routing (``dist_cases._routed_moe_setup``) over
    P in {4, 8}, fence and lock, persistent/non-persistent/gspmd dispatch,
    overlap_chunks 1 and 2, with and without capacity drops."""
    p, pattern, dispatch, variant, k, cf = case
    plan, y, aux = port_apply_moe(jax_ref, p, pattern, dispatch, variant, k, cf)
    cid = parity.moe_case_id(case)
    np.testing.assert_allclose(y.numpy(), jax_ref[f"{cid}/y"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(aux.numpy(), jax_ref[f"{cid}/aux"], rtol=1e-5)
    assert plan.ep_size == p and plan.overlap_chunks == k
    assert plan.plan_backed == (dispatch == "persistent_a2a")
    if plan.plan_backed:
        assert plan.a2a.identity_maps and plan.a2a.p == p


def test_apply_moe_with_padding_matches_jax_gspmd(jax_ref):
    """200 tokens over 8 ranks of t_loc 32: the last ranks carry padding.
    The port's persistent dispatch equals JAX's gspmd dispatch, which
    routes all tokens at once and has no padding."""
    p, pattern, tokens = parity.PADDED
    plan, y, _ = port_apply_moe(jax_ref, p, pattern, "persistent_a2a", "fence",
                                1, 16.0, tokens=tokens)
    assert plan.ep_size * plan.tokens_per_shard > tokens
    np.testing.assert_allclose(y.numpy(), jax_ref["padded/gspmd_y"],
                               rtol=2e-4, atol=2e-5)


def test_overlap_chunks_bit_identical(jax_ref):
    """Any pipeline depth gives the same bits as depth 1 (the chunks
    partition the capacity axis and the FFN is row-independent)."""
    outs = {}
    for k in (1, 2, 4):
        plan, y, _ = port_apply_moe(jax_ref, 8, "skewed", "persistent_a2a",
                                    "fence", 1, 16.0, overlap=k)
        assert plan.overlap_chunks == k
        outs[k] = y
    assert torch.equal(outs[1], outs[2]) and torch.equal(outs[1], outs[4])


@pytest.mark.parametrize("case", parity.CODEC_CASES, ids=parity.codec_case_id)
def test_apply_moe_codec_matches_jax(jax_ref, case):
    """The reduced OLMoE-1B-7B's MoE layer under a fused wire codec (int8
    and fp8 with their scales inlined, bf16) is within the codec's bound
    (``rel_error x`` each output row's max) of JAX's on the same weights
    and tokens; its backing plan moves wire rows."""
    from repro_torch.configs.registry import get_reduced

    p, codec = case
    olmoe = get_reduced("olmoe-1b-7b")
    d, t = olmoe.d_model, parity.CODEC_TOKENS
    mcfg = dataclasses.replace(
        olmoe.moe, wire_codec=codec,
        codec_tol=None if codec == "identity" else parity.CODEC_TOL)
    params = {k[len("codec/params/"):]: torch.from_numpy(v.copy())
              for k, v in jax_ref.items() if k.startswith("codec/params/")}
    x = torch.from_numpy(jax_ref["codec/x"].copy())
    mesh = VirtualMesh((1, p), ("data", "model"), device="cpu")
    with axis_rules(DEFAULT_RULES, mesh):
        plan = moe.MoEDispatchPlan.build(mcfg, t, mesh, d_model=d,
                                         dtype=torch.float32, cache=PlanCache())
        y, _ = moe.apply_moe(params, x.view(1, t, d), mcfg, plan)
    y = y.view(t, d).numpy()
    want = jax_ref[f"{parity.codec_case_id(case)}/y"]
    c = wirecodec.get(codec)
    bound = max(c.rel_error, 1e-5) * np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(y - want) <= bound).all(), float(np.abs(y - want).max())
    lanes = c.scale_lanes
    assert plan.a2a.spec.feature_shape == (d + lanes,)
    assert plan.a2a.dtype == (c.wire_dtype or torch.float32)


def test_wire_scatter_keeps_bytes_fault_of_the_reference():
    """The codec'd dispatch scatters wire rows with their inlined scale
    lanes.  The JAX package adds them into a zero buffer
    (``_scatter_buckets``, ``.at[slot].add``), which turns an fp8 byte
    0x80 (-0.0) into 0x00; as the third byte of an inlined float32 scale
    that clears the exponent's low bit and halves the scale.  The port
    stores the rows as raw bits (``_scatter_wire``): every byte arrives."""
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (1, 6, 12), dtype=np.uint8)
    raw[0, :, 10] = 0x80                     # a scale's third byte
    raw[0, 0, :] = 0x80
    slot = torch.tensor([[3, 0, 5, 1, 6, 2]])           # 6: dropped
    keep = slot < 6
    rows = torch.from_numpy(raw).view(torch.float8_e4m3fn)
    got = moe._scatter_wire(rows, slot, 1, 6).view(torch.uint8).numpy()[0]
    kept = slot[0] < 6
    want = np.zeros((6, 12), np.uint8)
    want[slot[0][kept].numpy()] = raw[0][kept.numpy()]
    np.testing.assert_array_equal(got, want)
    jrows = jnp.asarray(raw[0]).view(jnp.float8_e4m3fn)
    jgot = np.asarray(jmoe._scatter_buckets(
        jrows, jnp.asarray(slot[0].numpy()), jnp.asarray(keep[0].numpy()), 1,
        6, 12)).view(np.uint8)
    assert (jgot[want == 0x80] == 0).all()   # the reference loses them


def test_plan_geometry_matches_jax(jax_ref):
    """t_loc, capacity, experts per rank, clamped depth and EP size."""
    got = []
    for n_tokens, ep, cf, top_k, e, k in parity.GEOMETRY:
        mcfg = MoEConfig(n_experts=e, top_k=top_k, d_expert=32,
                         capacity_factor=cf)
        mesh = VirtualMesh((1, ep), ("data", "model"), device="cpu")
        with axis_rules(DEFAULT_RULES, mesh):
            plan = moe.MoEDispatchPlan.build(mcfg, n_tokens, mesh,
                                             plan_backed=False, overlap_chunks=k)
        got.append([plan.tokens_per_shard, plan.capacity, plan.e_local,
                    plan.overlap_chunks, plan.ep_size])
    np.testing.assert_array_equal(np.asarray(got), jax_ref["geometry"])


def test_count_kept_counts_routed_entries(jax_ref):
    """``count_kept`` records one count per MoE call: all 512 entries at a
    capacity factor of 16, fewer under skew at 1.25."""
    with moe.count_kept() as kept:
        port_apply_moe(jax_ref, 8, "skewed", "persistent_a2a", "fence", 1, 16.0)
        port_apply_moe(jax_ref, 8, "skewed", "persistent_a2a", "fence", 1, 1.25)
    assert kept[0] == parity.TOKENS * 2 and 0 < kept[1] < kept[0]


@pytest.mark.parametrize("what", ["codec", "codec_no_tol", "auto", "store",
                                  "data_axis", "hier_ep", "shared_experts"])
def test_unported_options_raise(what):
    """Each option the slice does not port raises NotImplementedError
    naming its ROADMAP item.  A wire codec is ported: ``int8`` with a
    ``codec_tol`` builds a backing plan of int8 wire rows (``d_model``
    plus 4 scale lanes); without one it raises the JAX package's
    ValueError.  ``a2a_variant="auto"`` is ported: it measures the
    embeddable candidates (fence and lock; never ragged) and the layer takes
    the winner's variant; without ``d_model`` it raises the JAX package's
    ValueError.  A data axis larger than 1 and hierarchical EP are ported:
    on ``(2, 4)`` the plan's EP axis is ``model`` (the data axis is a
    replica of it), and under ``HIER_EP_RULES`` on ``(2, 4)`` ``("pod",
    "model")`` it is the linearized pair, over which ``fence_hierarchy``
    stays the variant.  ``store=`` is ported: a layer built against a populated
    plan store with a fresh cache loads its backing plan's tables (zero
    bakes) and serves bit-equal rows.  Shared experts are ported: the
    layer adds their dense SwiGLU to the routed output."""
    base = MoEConfig(n_experts=8, top_k=2, d_expert=32)
    mesh = VirtualMesh((1, 8), ("data", "model"), device="cpu")
    rules, kw = DEFAULT_RULES, {}
    if what.startswith("codec"):
        base = dataclasses.replace(
            base, wire_codec="int8",
            codec_tol=0.1 if what == "codec" else None)
        with axis_rules(rules, mesh):
            if what == "codec_no_tol":
                with pytest.raises(ValueError, match="lossy"):
                    moe.MoEDispatchPlan.build(base, 64, mesh, d_model=16)
                return
            plan = moe.MoEDispatchPlan.build(base, 64, mesh, d_model=16)
        assert plan.codec == "int8"
        assert plan.a2a.spec.feature_shape == (20,)
        assert plan.a2a.dtype == torch.int8
        return
    if what == "auto":
        base = dataclasses.replace(base, a2a_variant="auto")
        with axis_rules(rules, mesh):
            plan = moe.MoEDispatchPlan.build(base, 64, mesh, d_model=16,
                                             cache=PlanCache())
            with pytest.raises(ValueError, match="d_model"):
                moe.MoEDispatchPlan.build(base, 64, mesh)
        choice = plan.a2a.auto_choice
        assert plan.variant == plan.a2a.spec.variant == choice["variant"]
        assert sorted(choice["times"]) == ["fence", "lock"]
        return
    if what == "store":
        with tempfile.TemporaryDirectory() as d, axis_rules(rules, mesh):
            cold = moe.MoEDispatchPlan.build(base, 64, mesh, d_model=16,
                                             store=PlanStore(d),
                                             cache=PlanCache())
            bakes = INIT_STATS.table_bakes
            warm = moe.MoEDispatchPlan.build(base, 64, mesh, d_model=16,
                                             store=PlanStore(d),
                                             cache=PlanCache())
        assert not cold.a2a.warm_loaded and warm.a2a.warm_loaded
        assert INIT_STATS.table_bakes == bakes
        rows = torch.randn(cold.a2a.global_send_shape,
                           generator=torch.Generator().manual_seed(3))
        assert torch.equal(warm.a2a.embed()(rows), cold.a2a.embed()(rows))
        return
    if what == "data_axis":
        mesh = VirtualMesh((2, 4), ("data", "model"), device="cpu")
        with axis_rules(rules, mesh):
            plan = moe.MoEDispatchPlan.build(base, 64, mesh, d_model=16,
                                             cache=PlanCache())
        assert (plan.axis, plan.hier_axes, plan.ep_size) == ("model", None, 4)
        assert plan.a2a.p == 4 and plan.variant == "fence"
        return
    if what == "hier_ep":
        mesh = VirtualMesh((2, 4), ("pod", "model"), device="cpu")
        base = dataclasses.replace(base, a2a_variant="fence_hierarchy")
        with axis_rules(HIER_EP_RULES, mesh):
            plan = moe.MoEDispatchPlan.build(base, 64, mesh, d_model=16,
                                             cache=PlanCache())
        assert plan.axis == plan.hier_axes == ("pod", "model")
        assert plan.ep_size == 8 and plan.variant == "fence_hierarchy"
        assert plan.a2a.hier_schedule is not None and plan.a2a.uniform_full
        return
    # Shared experts are ported: the plan builds, the layer draws
    # sh_gate/sh_up/sh_down of n_shared * d_expert hidden units and adds
    # their dense SwiGLU to the routed output.
    base = dataclasses.replace(base, n_shared_experts=1)
    with axis_rules(rules, mesh):
        plan = moe.MoEDispatchPlan.build(base, 64, mesh, d_model=16,
                                         cache=PlanCache(), **kw)
        f = ParamFactory(torch.Generator().manual_seed(0))
        moe.init_moe(f.scope("moe"), 16, base)
        prm = f.params["moe"]
        assert prm["sh_gate"].shape == prm["sh_up"].shape == (16, 32)
        assert prm["sh_down"].shape == (32, 16)
        x = torch.randn((1, 64, 16), generator=torch.Generator().manual_seed(1))
        y, _ = moe.apply_moe(prm, x, base, plan)
        routed = {k: v for k, v in prm.items() if not k.startswith("sh_")}
        y0, _ = moe.apply_moe(routed, x, dataclasses.replace(
            base, n_shared_experts=0), plan)
        sh = (torch.nn.functional.silu(x @ prm["sh_gate"]) * (x @ prm["sh_up"])
              ) @ prm["sh_down"]
        assert torch.equal(y, y0 + sh)


def test_k6_cuda_request_without_toolkit_raises(monkeypatch, tmp_path):
    """K6 where there is no toolkit: the build raises, nothing is counted,
    and the plain version is not taken."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(gm.KERNEL, "_fn", None)
    before = dict(_build.counts()["gather_matmul"])
    with pytest.raises(RuntimeError, match="nvcc"):
        gm.KERNEL.launch()
    assert _build.counts()["gather_matmul"] == before


def test_plan_cache_keeps_devices_apart():
    """A fault of the port, repaired here: the plan cache keyed plans by the
    pattern signature alone, so a CPU mesh and a CUDA mesh of one shape got
    the same plan, whose tables and window live on one device (the serving
    check on the card runs the same MoE dispatch on both).  Now each device
    gets its own plan ("meta" stands in for the card here)."""
    cache = PlanCache()
    counts = np.full((8, 8), 16)
    plans = [alltoallv_init(counts, (4,), torch.float32,
                            VirtualMesh((8,), ("x",), device=dev), axis="x",
                            cache=cache) for dev in ("cpu", "meta", "cpu")]
    assert plans[0] is plans[2] and plans[1] is not plans[0]
    assert plans[1].mesh.device.type == "meta"
    assert cache.stats["hits"] == 1 and cache.stats["misses"] == 2
