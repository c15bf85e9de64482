"""K2's bucket kernel (``fence_bulk_kernel``) on the CPU: its rule, its
chunk arithmetic, and the plans that take it.

The kernel does not run here (``chip_smoke.py`` holds it against its plain
version and the warp-per-row kernel on the card).  Its copies are computed
in plain Python by ``a2a_fence.fence_chunks``, as the CUDA loop computes
them: bucket (g, src -> tgt) is one contiguous run of ``C * row_bytes``
bytes, cut into chunks of at most 8 KiB, the chunks walked in output
order.  Below they are enacted in numpy over raw bytes and compared bit for
bit with the port's plain version and the JAX package's oracle
(``repro.kernels.ref.a2a_bucketed_ref``), and every plan kind's capacity is
checked to be a multiple of 8, so that the rule sends every plan with rows
of even width to the bucket kernel.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.core import (PlanCache, allgatherv_init, alltoallv_init,
                              reduce_scatter_init)
from repro_torch.core import metadata as md
from repro_torch.kernels import a2a_fence
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.testing.patterns import hugetrace_like_counts

BASE = 0x7F00_0000_0000  # a 256-byte aligned device address


@pytest.mark.parametrize("device, bucket_bytes, packed_off, out_off, want", [
    ("cpu", 16, 0, 0, "plain"),
    ("cpu", 300, 4, 0, "plain"),
    ("cuda", 16, 0, 0, "bulk"),
    ("cuda", 0, 0, 0, "bulk"),                 # C = 0: nothing to copy
    ("cuda", 8 * 4, 0, 0, "bulk"),             # 4-byte rows at C = 8
    ("cuda", 488 * 4, 0, 0, "bulk"),           # the B scale channel
    ("cuda", 8 * 2052, 0, 0, "bulk"),          # OLMoE int8 wire rows
    ("cuda", 5 * 1024, 0, 0, "bulk"),          # 1 KiB rows at cap 5
    ("cuda", 5 * 60, 0, 0, "warp"),            # (3, 5) fp32 rows at cap 5
    ("cuda", 5 * 4, 0, 0, "warp"),             # 4-byte rows at cap 5
    ("cuda", 7, 0, 0, "warp"),
    ("cuda", 1024, 4, 0, "warp"),              # a base 4 bytes off
    ("cuda", 1024, 8, 0, "warp"),
    ("cuda", 1024, 0, 4, "warp"),              # an output 4 bytes off
    ("cuda", 1024, 16, 32, "bulk"),
])
def test_fence_kernel_choice(device, bucket_bytes, packed_off, out_off, want):
    assert a2a_fence.fence_kernel_choice(device, bucket_bytes,
                                         BASE + packed_off,
                                         BASE + out_off) == want


def test_fence_kernel_for_cpu_and_cuda_kernel():
    x = torch.zeros((4, 2 * 8, 3))
    assert a2a_fence.fence_kernel_for(x, 8) == "plain"
    assert a2a_fence.fence_cuda_kernel(4, 8) is a2a_fence.FENCE_BULK
    assert a2a_fence.fence_cuda_kernel(60, 5) is a2a_fence.FENCE
    assert a2a_fence.FENCE_BULK.name == "a2a_fence_bulk"


def replay(packed: np.ndarray, chunks: np.ndarray) -> np.ndarray:
    """The bulk kernel's copies enacted on raw bytes; untouched bytes keep
    a sentinel."""
    src = packed.reshape(-1).view(np.uint8)
    out = np.full(src.shape, 0xA5, np.uint8)
    for s, d, n in chunks:
        out[d:d + n] = src[s:s + n]
    return out.view(packed.dtype).reshape(packed.shape)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("p", [1, 2, 8])
@pytest.mark.parametrize("capacity", [0, 8, 488])
@pytest.mark.parametrize("row_width", [1, 2, 4, 1024, 2052])
def test_fence_chunks_replay(groups, p, capacity, row_width):
    """The chunk copies equal the plain version and the JAX oracle bit for
    bit; every chunk is at most 8 KiB and, for 16-byte buckets, a 16-byte
    multiple on 16-byte offsets; every output byte is written once."""
    rng = np.random.default_rng(groups * 1000 + p * 100 + row_width)
    packed = rng.integers(0, 256, (groups * p, p * capacity, row_width),
                          dtype=np.uint8)
    chunks = a2a_fence.fence_chunks(groups, p, capacity, row_width)
    bucket = capacity * row_width
    per_bucket = -(-bucket // a2a_fence.FENCE_CHUNK_BYTES)
    assert chunks.shape == (groups * p * p * per_bucket, 3)
    assert (chunks[:, 2] > 0).all()
    assert (chunks[:, 2] <= a2a_fence.FENCE_CHUNK_BYTES).all()
    assert chunks[:, 2].sum() == packed.size
    # output order: the stores stream
    assert (chunks[1:, 1] == chunks[:-1, 1] + chunks[:-1, 2]).all()
    if bucket % 16 == 0:
        assert (chunks % 16 == 0).all()
    got = replay(packed, chunks)
    plain = a2a_fence.rma_alltoallv_fence_plain(torch.from_numpy(packed), p,
                                                capacity, groups).numpy()
    assert np.array_equal(got, plain)
    oracle = np.concatenate([jax_ref.a2a_bucketed_ref(
        packed[g * p:(g + 1) * p], p, capacity) for g in range(groups)])
    assert np.array_equal(got, oracle)


def test_fence_chunks_tail_and_small_chunks():
    """A bucket that is not a chunk multiple ends in a shorter chunk, and
    another chunk size (the launcher takes any positive 16-byte multiple)
    gives the same bytes."""
    g, p, cap, rb = 2, 3, 40, 1040            # 41,600-byte buckets
    packed = np.random.default_rng(3).integers(
        0, 256, (g * p, p * cap, rb), dtype=np.uint8)
    want = a2a_fence.rma_alltoallv_fence_plain(torch.from_numpy(packed), p,
                                               cap, g).numpy()
    for chunk in (a2a_fence.FENCE_CHUNK_BYTES, 4096, 16):
        chunks = a2a_fence.fence_chunks(g, p, cap, rb, chunk)
        sizes = chunks[:, 2].reshape(g * p * p, -1)
        assert (sizes[:, :-1] == chunk).all()
        assert (sizes[:, -1] == cap * rb - chunk * (sizes.shape[1] - 1)).all()
        assert np.array_equal(replay(packed, chunks), want)


def moe_plan_capacity() -> int:
    from repro_torch.configs import get_reduced
    from repro_torch.models import api as model_api
    from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules

    cfg = get_reduced("olmoe-1b-7b", n_layers=1)
    mesh = VirtualMesh((1, 4), ("data", "model"), device="cpu")
    with axis_rules(DEFAULT_RULES, mesh):
        plan = model_api.build_moe_plan(cfg, 4 * 31, mesh)
    return plan.a2a.capacity


def grad_sync_capacities(monkeypatch) -> list[int]:
    """The reduce-scatter and allgatherv plans ``persistent_rs_sync`` builds
    for a small tree of 1,001 floats on a (2, 4) mesh."""
    from repro_torch import core
    from repro_torch.train import grad as grad_util

    caps = []

    def recording(init):
        def wrapped(*a, **kw):
            plan = init(*a, **kw)
            caps.append(plan.capacity)
            return plan
        return wrapped

    monkeypatch.setattr(core, "reduce_scatter_init",
                        recording(core.reduce_scatter_init))
    monkeypatch.setattr(core, "allgatherv_init", recording(core.allgatherv_init))
    mesh = VirtualMesh((2, 4), ("data", "model"), device="cpu")
    sync = grad_util.persistent_rs_sync(mesh, ("data",))
    tree = {"a": torch.randn(7, 11), "b": torch.randn(924)}
    out = sync(tree)
    assert all(torch.equal(out[k], tree[k]) for k in tree)
    assert len(caps) == 2
    return caps


def plan_capacities(monkeypatch) -> dict[str, list[int]]:
    cpu8 = VirtualMesh((8,), ("x",), device="cpu")
    grid = VirtualMesh((2, 4), ("o", "i"), device="cpu")
    counts = hugetrace_like_counts(8, 13)
    vec = np.array([3, 0, 17, 9, 1, 30, 5, 12])
    flat = alltoallv_init(counts, (4,), torch.float32, cpu8, axis="x",
                          variant="fence", cache=PlanCache())
    hier = alltoallv_init(counts, (4,), torch.float32, grid, axis=("o", "i"),
                          variant="fence_hierarchy", cache=PlanCache())
    rs = reduce_scatter_init(vec, (4,), torch.float32, cpu8, axis="x",
                             variant="fence", cache=PlanCache())
    ag = allgatherv_init(vec, (4,), torch.float32, cpu8, axis="x",
                         variant="fence", cache=PlanCache())
    s = hier.hier_schedule
    return {"flat": [flat.capacity], "hier s1/s3": [s.s1_cap, s.s3_cap],
            "reduce_scatter": [rs.capacity], "allgatherv": [ag.capacity],
            "moe": [moe_plan_capacity()],
            "grad_sync": grad_sync_capacities(monkeypatch)}


def test_every_plan_capacity_is_a_multiple_of_8(monkeypatch):
    """So C * row_bytes is a 16-byte multiple for every even row width, and
    the rule sends every such plan's exchange to the bucket kernel."""
    caps = plan_capacities(monkeypatch)
    for kind, cs in caps.items():
        assert all(c > 0 and c % md.TILE_ROWS == 0 for c in cs), (kind, cs)
        for c in cs:
            for width in (2, 4, 6, 1024, 2052):
                assert a2a_fence.fence_cuda_kernel(width, c) \
                    is a2a_fence.FENCE_BULK, (kind, c, width)


@pytest.mark.parametrize("variant, impl, codec, want", [
    ("fence", "jnp", "identity", ["a2a_fence_bulk"]),
    ("fence", "pallas", "identity", ["gather_rows_runs", "a2a_fence_bulk"]),
    ("fence", "pallas", "int8", ["gather_rows_runs", "a2a_fence_bulk"]),
    ("fence", "fused", "int8",
     ["a2a_fence_fused_bulk", "gather_rows_runs", "a2a_fence_bulk"]),
    ("lock", "jnp", "identity", ["a2a_lock_cluster"]),
])
def test_plan_kernels_name_the_bucket_kernel(variant, impl, codec, want):
    """``plan.kernels()`` names K2 by the rule: the bucket kernel for the
    plan's rows and for a codec's 4-byte scale channel (never the warp
    kernel)."""
    mesh = VirtualMesh((8,), ("x",), device="cpu")
    kw = {"error_tol": 0.1} if codec != "identity" else {}
    plan = alltoallv_init(hugetrace_like_counts(8, 13), (16,), torch.float32,
                          mesh, axis="x", variant=variant, pack_impl=impl,
                          codec=codec, cache=PlanCache(), **kw)
    assert [k.name for k in plan.kernels()] == want

