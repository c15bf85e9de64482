"""The port's kernels against the JAX package's, on the CPU.

Here every wrapper takes its kernel's plain PyTorch version (the CUDA
kernels run only on the card: ``chip_smoke.py`` holds each against its
plain version there).  The row gather is compared with the Pallas kernel
run through the interpreter, over ``tests/test_kernels.py``'s shape and
dtype sweep; the exchange kernels with the JAX package's oracles.
Tolerance: valid rows bit for bit (the kernels only move rows); invalid
rows by value (the Pallas kernel multiplies them by 0, which can give -0.0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops, ref as jax_ref
from repro_torch.core import metadata as md
from repro_torch.kernels import _build, a2a_fence, a2a_hier, a2a_lock, gather_rows, ops
from repro_torch.kernels import ref as torch_ref
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.testing.patterns import banded_counts, random_counts

TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
                jnp.float16: torch.float16}


def as_torch(a) -> torch.Tensor:
    """The same values as the JAX array ``a``, as a torch tensor of its
    dtype (through float32, which holds bf16 and f16 exactly)."""
    f32 = np.array(a.astype(jnp.float32))
    return torch.from_numpy(f32).to(TORCH_DTYPES[a.dtype.type])


def assert_gather_equal(got: torch.Tensor, want, valid: np.ndarray):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(got[valid].view(np.uint32),
                                  want[valid].view(np.uint32))
    np.testing.assert_array_equal(got[~valid], 0)
    assert not np.signbit(got[~valid]).any()


@pytest.mark.parametrize("rows,feat,dtype", [
    (32, 128, jnp.float32),
    (40, 100, jnp.float32),
    (64, 256, jnp.bfloat16),
    (8, 64, jnp.float32),
    (128, 512, jnp.float16),
])
def test_gather_rows_matches_pallas(rows, feat, dtype):
    """ops.pack (Pallas, interpreted) == the port's K1 on one rank."""
    rng = np.random.default_rng(rows + feat)
    xs = rng.standard_normal((rows, feat))
    n = ((rows * 2 + 7) // 8) * 8
    idx = rng.integers(0, rows, n).astype(np.int32)
    valid = rng.integers(0, 2, n).astype(bool)
    x = jnp.asarray(xs, dtype)
    want = jax_ops.pack(x, jnp.asarray(idx), jnp.asarray(valid, jnp.int32))
    got = ops.pack(as_torch(x)[None], torch.from_numpy(idx)[None],
                   torch.from_numpy(valid)[None])[0]
    assert got.dtype == TORCH_DTYPES[dtype]
    assert_gather_equal(got, want, valid)


def test_gather_multi_dim_features():
    """ops.unpack on (3, 5) rows, and the write-through form."""
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((16, 3, 5)).astype(np.float32)
    idx = rng.integers(0, 16, 24).astype(np.int32)
    valid = np.ones(24, bool)
    valid[::5] = False
    want = jax_ops.unpack(jnp.asarray(xs), jnp.asarray(idx),
                          jnp.asarray(valid, jnp.int32))
    x, i, v = (torch.from_numpy(a)[None] for a in (xs, idx, valid))
    assert_gather_equal(ops.unpack(x, i, v)[0], want, valid)
    window = torch.full((1, 24, 3, 5), 7.0)
    ops.unpack(x, i, v, out=window)
    np.testing.assert_array_equal(window[0][v[0]].numpy(), np.asarray(want)[valid])
    assert (window[0][~v[0]] == 7.0).all()


def test_fence_matches_bucketed_ref():
    """K2 == repro.kernels.ref.a2a_bucketed_ref (dist case rma_kernels'
    oracle, and the port's copy of it), and K2 twice is the identity."""
    rng = np.random.default_rng(1)
    p, cap, f = 4, 8, 16
    x = rng.standard_normal((p, p * cap, f)).astype(np.float32)
    want = jax_ref.a2a_bucketed_ref(x, p, cap)
    np.testing.assert_array_equal(torch_ref.a2a_bucketed_ref(x, p, cap), want)
    once = a2a_fence.rma_alltoallv_fence(torch.from_numpy(x), p, cap)
    np.testing.assert_array_equal(once.numpy(), want)
    twice = ops.rma_alltoallv(once, variant="fence", p=p, capacity=cap)
    np.testing.assert_array_equal(twice.numpy(), x)


@pytest.mark.parametrize("groups", [2, 4])
def test_fence_groups_equal_fence_per_group(groups):
    """K2 over ``groups`` groups in one call == K2 on each group alone ==
    the JAX package's bucketed exchange oracle per group (the inner
    all-to-alls of the hierarchy)."""
    rng = np.random.default_rng(groups)
    p, cap = 8 // groups, 3
    x = rng.standard_normal((groups * p, p * cap, 2, 3)).astype(np.float32)
    got = ops.rma_alltoallv(torch.from_numpy(x), variant="fence", p=p,
                            capacity=cap, groups=groups).numpy()
    for g in range(groups):
        part = x[g * p:(g + 1) * p]
        np.testing.assert_array_equal(
            got[g * p:(g + 1) * p],
            a2a_fence.rma_alltoallv_fence(torch.from_numpy(part), p, cap).numpy())
        np.testing.assert_array_equal(got[g * p:(g + 1) * p],
                                      jax_ref.a2a_bucketed_ref(part, p, cap))
    with pytest.raises(ValueError, match="fence"):
        ops.rma_alltoallv(torch.from_numpy(x), variant="lock", p=p,
                          capacity=cap, groups=groups)


def packed_case(counts, feature=(4,), seed=0):
    p = counts.shape[0]
    cap = md.global_capacity(counts)
    send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
    recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
    t = md.baked_index_tables(counts, cap, recv_rows)
    xs = np.random.default_rng(seed).standard_normal(
        (p, send_rows) + feature).astype(np.float32)
    return xs, t, cap


@pytest.mark.parametrize("counts", [banded_counts(8), random_counts(8, 5, 30)],
                         ids=["banded", "skewed"])
def test_fused_fence_matches_oracles(counts):
    """K3 == the JAX package's pack oracle followed by its bucketed
    exchange oracle."""
    p = counts.shape[0]
    xs, t, cap = packed_case(counts)
    packed = np.stack([np.asarray(jax_ref.pack_ref(
        jnp.asarray(xs[i]), jnp.asarray(t.pack_src[i]),
        jnp.asarray(t.pack_valid[i]))) for i in range(p)])
    want = jax_ref.a2a_bucketed_ref(packed, p, cap)
    got = ops.fused_pack_alltoallv(
        torch.from_numpy(xs), torch.from_numpy(t.pack_src),
        torch.from_numpy(t.pack_valid), p=p, capacity=cap)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("elided", [True, False], ids=["elided", "full"])
@pytest.mark.parametrize("sched", ["ring", "pairwise"])
@pytest.mark.parametrize("counts", [banded_counts(8), random_counts(8, 7, 30)],
                         ids=["banded", "skewed"])
def test_lock_matches_oracle(counts, sched, elided):
    """K4 == the bucketed exchange oracle with each received bucket cut to
    the capacity of the round that carried it (zero above)."""
    p = counts.shape[0]
    cap = md.global_capacity(counts)
    caps = (md.xor_round_capacities(counts) if sched == "pairwise"
            else md.ring_round_capacities(counts))
    packed = np.random.default_rng(2).standard_normal(
        (p, p * cap, 4)).astype(np.float32)
    want = jax_ref.a2a_bucketed_ref(packed, p, cap)
    if elided:
        for i in range(p):
            for j in range(p):
                r = (i ^ j) if sched == "pairwise" else (i - j) % p
                keep = cap if r == 0 else min(int(caps[r]), cap)
                want[i, j * cap + keep:(j + 1) * cap] = 0
    got = a2a_lock.rma_alltoallv_lock(torch.from_numpy(packed), p, cap,
                                      caps if elided else None, sched)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lock_steps_fold_local_and_elided_rounds_into_first_launch():
    caps = md.ring_round_capacities(banded_counts(8))
    steps = a2a_lock.lock_steps(8, 16, caps, "ring")
    assert steps[0][0] == (0, 16)
    assert len(steps) == md.active_round_schedule(caps).size
    assert sorted(r for s in steps for r, _ in s) == list(range(8))
    all_local = a2a_lock.lock_steps(4, 8, np.zeros(4, np.int64), "ring")
    assert all_local == [[(0, 8), (1, 0), (2, 0), (3, 0)]]
    with pytest.raises(ValueError, match="power-of-two"):
        a2a_lock.lock_steps(6, 8, None, "pairwise")


@pytest.mark.parametrize("call", [
    lambda t, i, v: gather_rows.gather_rows(t, i, v),
    lambda t, i, v: a2a_fence.rma_alltoallv_fence(t, 2, 4),
    lambda t, i, v: a2a_fence.rma_alltoallv_fence_fused(t, i, v, 2, 4),
    lambda t, i, v: a2a_lock.rma_alltoallv_lock(t, 2, 4),
    lambda t, i, v: a2a_hier.rma_hier_leader_exchange(
        t, i, v, torch.zeros((2, 1), dtype=torch.int32, device="meta"),
        torch.zeros(8, dtype=torch.int16, device="meta")),
], ids=["gather_rows", "a2a_fence", "a2a_fence_fused", "a2a_lock", "a2a_hier"])
def test_wrappers_take_no_fallback(call):
    """The plain version is taken only for CPU tensors.  ``meta`` tensors
    take the shape path (the dry run's): an empty output, no launch and no
    plain call."""
    t = torch.empty((2, 8, 4), device="meta")
    i = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    v = torch.zeros((2, 8), dtype=torch.bool, device="meta")
    counts = {k: dict(c) for k, c in _build.counts().items()}
    assert call(t, i, v).device.type == "meta"
    assert _build.counts() == counts


@pytest.mark.parametrize("call", [
    lambda t, i, v: gather_rows.gather_rows(t, i, v),
    lambda t, i, v: a2a_fence.rma_alltoallv_fence_fused(t, i, v, 2, 4),
    lambda t, i, v: a2a_hier.rma_hier_leader_exchange(
        t, i, v, torch.zeros((2, 1), dtype=torch.int32, device="meta"),
        torch.zeros(8, dtype=torch.int16, device="meta")),
], ids=["gather_rows", "a2a_fence_fused", "a2a_hier"])
def test_meta_beside_cpu_raises(call):
    """The shape path takes ``meta`` tensors only: tables on the CPU beside
    a ``meta`` buffer raise, and nothing is counted."""
    t = torch.empty((2, 8, 4), device="meta")
    i = torch.zeros((2, 8), dtype=torch.int32)
    v = torch.zeros((2, 8), dtype=torch.bool)
    counts = {k: dict(c) for k, c in _build.counts().items()}
    with pytest.raises(ValueError, match="meta"):
        call(t, i, v)
    assert _build.counts() == counts


def test_cuda_request_without_toolkit_or_card_raises(monkeypatch, tmp_path):
    """Without nvcc a kernel cannot be built, and its launch raises instead
    of falling back; without a GPU a default (CUDA) mesh raises."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    probe = _build.CudaKernel("probe", "gather_rows", "repro_gather_rows", [])
    with pytest.raises(RuntimeError, match="nvcc"):
        probe.launch()
    assert probe.launches == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VirtualMesh((8,), ("x",))


def test_hier_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    """K5 on a CUDA request where there is no toolkit: the build raises,
    nothing is counted, and the plain version is not taken."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(a2a_hier.HIER, "_fn", None)
    counts = {k: dict(c) for k, c in _build.counts().items()}
    with pytest.raises(RuntimeError, match="nvcc"):
        a2a_hier.HIER.launch()
    assert _build.counts() == counts
