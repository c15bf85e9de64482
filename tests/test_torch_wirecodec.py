"""The port's wire codecs against the JAX package's, and codec'd plans.

``repro_torch.parallel.wirecodec`` is held against ``repro.parallel.wirecodec``
in process on the same seeded rows: bf16 wire bits equal; int8 and fp8
codes equal on at least 99.9 % of the elements and never more than one
step apart; scales within 1 ulp; decoded values within ``rel_error x`` the
row max of JAX's.  ``inline_rows``/``split_rows`` round-trip bit for bit;
``require`` and ``allowed`` answer as JAX does.

The codec'd plans (``fence x {jnp, pallas, fused}``, ``lock``, the
hierarchy) run on ``VirtualMesh(..., device="cpu")``: valid rows bit-equal
to the numpy oracle applied to ``decode(encode(x))`` (every exchange moves
bytes exactly and encode works per row), and within the codec's bound of
the JAX plan with the same codec, run in one JAX subprocess
(``tests/_torch_parity_jax_patterns.py codec``, 8 host devices).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity_jax_patterns as parity
from repro.parallel import wirecodec as jax_wc
from repro_torch.core import PlanCache, alltoallv_init, metadata as md
from repro_torch.core import reference
from repro_torch.kernels import a2a_fence, a2a_lock, gather_rows, ops
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.parallel import wirecodec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSSY = ("bf16", "int8", "fp8")
SEEDS = range(6)
BITS = {1: np.uint8, 2: np.uint16, 4: np.uint32}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_codec") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_parity_jax_patterns.py"),
         "codec", str(out)], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def rows(seed, n=64, d=48):
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-4, 3)
    x = (rng.standard_normal((n, d)) * scale).astype(np.float32)
    x[3] = 0.0                                    # an all-zero row
    return x


def both(name, x):
    """(port wire, port scales), (JAX wire, JAX scales) as numpy."""
    tw, ts = wirecodec.get(name).encode(torch.from_numpy(x))
    jw, js = jax_wc.get(name).encode(jnp.asarray(x))
    bits = BITS[tw.element_size()]
    return ((tw.view(getattr(torch, "uint8" if bits is np.uint8 else "int16"))
             .numpy().view(bits), None if ts is None else ts.numpy()),
            (np.asarray(jw).view(bits), None if js is None else np.asarray(js)))


def fp8_ordinal(b):
    """e4m3fn bytes in value order (sign-magnitude -> signed ordinal)."""
    b = b.astype(np.int32)
    return np.where(b & 0x80, -(b & 0x7F), b & 0x7F)


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_wire_bits_equal_jax(seed):
    (tw, ts), (jw, js) = both("bf16", rows(seed))
    assert ts is None and js is None
    np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("seed", SEEDS)
def test_scaled_codes_match_jax(name, seed):
    """Codes equal on >= 99.9 % of the elements and at most one step apart;
    scales within 1 ulp; decoded values within rel_error x row max."""
    x = rows(seed)
    (tw, ts), (jw, js) = both(name, x)
    if name == "int8":
        steps = np.abs(tw.view(np.int8).astype(np.int32)
                       - jw.view(np.int8).astype(np.int32))
    else:
        steps = np.abs(fp8_ordinal(tw) - fp8_ordinal(jw))
    assert (steps == 0).mean() >= 0.999 and steps.max() <= 1
    assert np.abs(ts.view(np.int32) - js.view(np.int32)).max() <= 1
    c = wirecodec.get(name)
    got = c.decode(*c.encode(torch.from_numpy(x)), torch.float32).numpy()
    jc = jax_wc.get(name)
    want = np.asarray(jc.decode(*jc.encode(jnp.asarray(x)), jnp.float32))
    row_max = np.abs(x).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= c.rel_error * row_max).all()
    assert (np.abs(got - x) <= c.rel_error * row_max + 1e-6 * row_max).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_scale_inline_roundtrip_bitexact(seed):
    """inline_rows/split_rows is a bitcast shuttle: payload and scales come
    back bit for bit."""
    x = torch.from_numpy(rows(seed))
    for name in ("int8", "fp8"):
        c = wirecodec.get(name)
        wire, scales = c.encode(x)
        k = wirecodec.inline_lanes(wire, scales)
        assert k == c.scale_lanes == 4
        packed = wirecodec.inline_rows(wire, scales, k)
        assert packed.shape == (x.shape[0], x.shape[1] + k)
        assert packed.dtype == wire.dtype
        w2, s2 = wirecodec.split_rows(packed, k)
        assert torch.equal(w2.view(torch.uint8), wire.view(torch.uint8))
        assert torch.equal(s2.view(torch.int32), scales.view(torch.int32))


def test_inline_lanes_gating_and_declared_dtypes():
    x = torch.from_numpy(rows(0))
    wire, scales = wirecodec.get("int8").encode(x)
    assert wirecodec.inline_lanes(wire, None) == 0
    assert wirecodec.inline_lanes(wire.reshape(64, 6, 8), scales) == 0
    assert wirecodec.inline_lanes(x, scales) == 1
    for name, c in wirecodec.CODECS.items():
        jc = jax_wc.get(name)
        assert (c.wire_bits, c.lossy, c.rel_error, c.has_scales,
                c.scale_lanes, c.ratio) == (jc.wire_bits, jc.lossy,
                                            jc.rel_error, jc.has_scales,
                                            jc.scale_lanes, jc.ratio)
    assert wirecodec.get("fp8").wire_dtype == torch.float8_e4m3fn


def test_zero_rows_no_nan():
    x = torch.zeros(4, 8)
    for name in LOSSY:
        c = wirecodec.get(name)
        back = c.decode(*c.encode(x), torch.float32)
        assert torch.isfinite(back).all() and (back == 0).all()


@pytest.mark.parametrize("tol", [None, 0.0, 2.0 ** -8, 0.5 / 127, 0.01,
                                 2.0 ** -4, 1.0])
def test_require_and_allowed_match_jax(tol):
    assert wirecodec.allowed(tol) == jax_wc.allowed(tol)
    for name in wirecodec.CODECS:
        try:
            jax_wc.require(name, tol)
        except ValueError:
            with pytest.raises(ValueError, match="never"):
                wirecodec.require(name, tol)
        else:
            assert wirecodec.require(name, tol).name == name
    with pytest.raises(ValueError, match="unknown"):
        wirecodec.require("zstd", 1.0)
    with pytest.raises(ValueError):
        wirecodec.allowed(-0.1)


def codec_plan(case):
    codec, variant, impl, shape = case
    names = ("x",) if len(shape) == 1 else ("o", "i")
    mesh = VirtualMesh(shape, names, device="cpu")
    counts = parity.ragged_counts_of(8, parity.CODEC_COUNTS)
    plan = alltoallv_init(counts, parity.CODEC_FEATURE, torch.float32, mesh,
                          axis=names[0] if len(names) == 1 else names,
                          variant=variant, pack_impl=impl, codec=codec,
                          error_tol=parity.ERROR_TOL, cache=PlanCache())
    return plan, counts


@pytest.mark.parametrize("case", parity.CODEC_PLANS, ids=parity.plan_id)
def test_codec_plan_matches_oracle_and_jax(jax_ref, case):
    """Valid rows bit-equal to the oracle of decode(encode(x)) (standalone,
    stale padding kept; embedded, zero padding), and within the codec's
    bound of the JAX plan with the same codec."""
    plan, counts = codec_plan(case)
    f = parity.CODEC_FEATURE
    x = jax_ref[f"{parity.plan_id(case)}/x"]
    xt = torch.from_numpy(x.reshape((-1,) + f))
    c = wirecodec.get(case[0])
    dec = c.decode(*c.encode(xt), torch.float32).numpy().reshape(x.shape)
    want = reference.alltoallv_global(dec, counts, plan.recv_rows)
    win = plan.start(xt)
    win.fill_(5.0)
    got = plan.wait(plan.start(xt)).numpy().reshape(want.shape)
    emb = plan.embed()(xt).numpy()
    jax_out = jax_ref[f"{parity.plan_id(case)}/out"].reshape(want.shape)
    src_max = reference.alltoallv_global(
        np.abs(x).max(axis=-1, keepdims=True), counts, plan.recv_rows)
    rc = md.recv_counts(counts).sum(axis=1)
    for r in range(plan.p):
        n = rc[r]
        np.testing.assert_array_equal(got[r, :n].view(np.uint32),
                                      want[r, :n].view(np.uint32))
        np.testing.assert_array_equal(emb[r, :n].view(np.uint32),
                                      want[r, :n].view(np.uint32))
        assert (got[r, n:] == 5.0).all() and (emb[r, n:] == 0.0).all()
        assert (np.abs(got[r, :n] - jax_out[r, :n])
                <= c.rel_error * src_max[r, :n]).all()


def test_codec_plan_kernels_take_wire_widths():
    """``kernels()`` names each kernel by the width of the rows it moves:
    int8 wire rows of 16 bytes with their 4-byte scale channel, and 20-byte
    rows with the scales inlined (jnp packs)."""
    names, caps = {}, set()
    for case in parity.CODEC_PLANS:
        plan, _ = codec_plan(case)
        names[case[:3]] = ([k.name for k in plan.kernels()],
                           plan.wire_row_bytes)
        caps.add(plan.capacity)
    # K2 by its rule: every width here, at the plans' capacities (multiples
    # of 8), makes buckets of 16-byte multiples, so the bucket kernel.
    assert all(a2a_fence.fence_kernel_choice("cuda", w * c, 0, 0) == "bulk"
               for w in (4, 16, 20, 32) for c in caps)
    fence = a2a_fence.fence_cuda_kernel(20, min(caps)).name
    assert fence == a2a_fence.FENCE_BULK.name
    lock_cluster = a2a_lock.CLUSTER.name
    assert names[("int8", "fence", "jnp")] == ([fence], 20)
    assert names[("bf16", "fence", "jnp")] == ([fence], 32)
    assert names[("int8", "fence", "pallas")] == (
        [gather_rows.RUNS.name, fence], 16)
    assert names[("int8", "fence", "fused")] == (
        [a2a_fence.FUSED_BULK.name, gather_rows.RUNS.name, fence], 16)
    assert names[("int8", "lock", "jnp")] == ([a2a_lock.KERNEL.name], 20)
    assert names[("fp8", "lock", "pallas")] == (
        [gather_rows.RUNS.name, lock_cluster, a2a_lock.KERNEL.name], 16)
    assert a2a_fence.fused_kernel_choice("cuda", 20, 0) == "warp"
    assert gather_rows.kernel_choice("cuda", 20, (0,), True) == "warp"


def test_olmoe_wire_rows_move_as_bytes():
    """OLMoE's int8 wire rows (2048 codes + 4 scale lanes = 2052 bytes) go
    through K2's plain version byte for byte; the kernel rule takes any
    width."""
    c = wirecodec.get("int8")
    x = torch.randn(8 * 8 * 2, 2048)
    wire, scales = c.encode(x)
    rowsw = wirecodec.inline_rows(wire, scales, 4).reshape(8, 16, 2052)
    out = a2a_fence.rma_alltoallv_fence(rowsw, 8, 2)
    want = rowsw.view(8, 8, 2, 2052).transpose(0, 1).reshape(8, 16, 2052)
    assert torch.equal(out, want)


def test_fused_unpack_matmul_scales_fold():
    """``ops.fused_unpack_matmul(..., scales=)`` equals decode, gather and
    matmul (the JAX kernel path's pre-scaling)."""
    rng = np.random.default_rng(5)
    rows_, d, e, n, f = 64, 16, 4, 8, 12
    x = torch.from_numpy(rng.standard_normal((rows_, d)).astype(np.float32))
    c = wirecodec.get("int8")
    wire, scales = c.encode(x)
    idx = torch.from_numpy(rng.integers(0, rows_, (e, n)).astype(np.int32))
    valid = torch.from_numpy(rng.integers(0, 2, (e, n)).astype(bool))
    w = torch.from_numpy((rng.standard_normal((e, d, f)) * 0.1).astype(np.float32))
    got = ops.fused_unpack_matmul(wire, idx, w, valid, scales=scales)
    dec = c.decode(wire, scales, torch.float32)
    h = dec[idx.long()] * valid[..., None]
    torch.testing.assert_close(got, torch.einsum("end,edf->enf", h, w),
                               rtol=1e-5, atol=1e-5)
