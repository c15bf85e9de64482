"""The port's roofline against the JAX package's (``repro.roofline``):
``count_params`` on every config, the collective ring models against
``parse_collectives`` on HLO lines, ``analyze``'s terms against JAX's
rescaled by the constants' ratios, and each kernel wrapper's ``meta``
path: the plain version's shape and dtype, no launch and no plain call,
the cost its shapes give.  No subprocess: JAX's roofline modules are
plain Python."""

import math

import pytest
import torch

from repro.configs import get as jax_get
from repro.configs import get_reduced as jax_get_reduced
from repro.configs import list_archs as jax_list_archs
from repro.roofline import analyze as jax_analyze
from repro.roofline import hw as jax_hw
from repro.roofline.hlo import parse_collectives

from repro_torch.configs import SHAPES, get, get_reduced, list_archs
from repro_torch.kernels import _build, a2a_fence, a2a_hier, a2a_lock
from repro_torch.kernels import gather_matmul, gather_rows
from repro_torch.roofline import analyze, hw, trace
from repro_torch.roofline.trace import StepCounter


def test_registries_agree():
    assert list_archs() == jax_list_archs() and len(list_archs()) == 10


@pytest.mark.parametrize("arch", sorted(jax_list_archs()))
@pytest.mark.parametrize("cut", ["full", "reduced"])
def test_count_params_equals_jax(arch, cut):
    if cut == "full":
        got, want = analyze.count_params(get(arch)), jax_analyze.count_params(
            jax_get(arch))
    else:
        got = analyze.count_params(get_reduced(arch))
        want = jax_analyze.count_params(jax_get_reduced(arch))
    assert got == tuple(int(v) for v in want)
    assert all(type(v) is int for v in got)


def _hlo(op, dtype_dims, group, start=False):
    """One optimized-HLO line of collective ``op`` with result
    ``dtype_dims`` (a list of (dtype, dims)) over groups of ``group``."""
    shapes = [f"{d}[{','.join(map(str, dims))}]{{0}}" for d, dims in dtype_dims]
    res = shapes[0] if len(shapes) == 1 else "(" + ", ".join(shapes) + ")"
    ids = ",".join(map(str, range(group)))
    suffix = "-start" if start else ""
    return (f"  %{op}.1 = {res} {op}{suffix}(f32[8]{{0}} %p), "
            f"replica_groups={{{{{ids}}}}}, channel_id=1")


_BYTES = {"f32": 4, "bf16": 2, "s8": 1}
_CASES = [
    ("all-reduce", [("f32", (1024, 16))]),
    ("all-gather", [("bf16", (64, 128))]),
    ("reduce-scatter", [("f32", (256,))]),
    ("all-to-all", [("bf16", (8, 2048, 64))]),
    ("collective-permute", [("s8", (4096,))]),
    ("all-to-all", [("f32", (16, 16)), ("bf16", (2, 8))]),      # a tuple
]


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_collective_stats_equal_parse_collectives(case):
    """Ring models, group sizes 1, 2 and 8: the port's records sum to the
    JAX parse of the same ops.  JAX's ragged-all-to-all has the all-to-all
    model, which the port records its ragged epoch as."""
    op, dtype_dims = _CASES[case]
    size = sum(math.prod(d) * _BYTES[t] for t, d in dtype_dims)
    for group in (1, 2, 8):
        lines = [_hlo(op, dtype_dims, group), _hlo(op, dtype_dims, group, True)]
        want = parse_collectives("\n".join(lines))
        got = trace.collective_stats([(op, size, group)] * 2)
        assert got.to_json() == want.to_json(), (op, group)
        if op == "all-to-all":
            ragged = parse_collectives(_hlo("ragged-all-to-all", dtype_dims,
                                            group))
            assert trace.wire_bytes(op, size, group) == \
                ragged.wire_bytes["ragged-all-to-all"]


def test_unknown_collective_raises():
    with pytest.raises(ValueError):
        StepCounter().collective("all-to-some", 8, 2)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
def test_analyze_terms_equal_jax_rescaled(shape_name):
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.roofline.hlo import CollectiveStats as JaxStats

    arch = "olmoe-1b-7b"
    cost = {"flops": 3.1e14, "bytes accessed": 4.7e12}
    records = [("all-to-all", 1 << 20, 16), ("all-reduce", 1 << 18, 2)]
    stats = trace.collective_stats(records)
    chips = 256
    got = analyze.analyze(get(arch), SHAPES[shape_name], "pod256", chips, cost,
                          stats, peak_memory=1.5e9)
    want = jax_analyze.analyze(jax_get(arch), JAX_SHAPES[shape_name], "pod256",
                               chips, cost, JaxStats(**stats.__dict__),
                               peak_memory=1.5e9)
    assert got.compute_s == pytest.approx(
        want.compute_s * jax_hw.PEAK_FLOPS_BF16 / hw.PEAK_FLOPS_BF16, rel=1e-12)
    assert got.memory_s == pytest.approx(
        want.memory_s * jax_hw.HBM_BW / hw.HBM_BW, rel=1e-12)
    assert got.collective_s == pytest.approx(
        want.collective_s * jax_hw.ICI_LINK_BW / hw.NVLINK_BW, rel=1e-12)
    assert got.model_flops == want.model_flops
    assert got.useful_ratio == want.useful_ratio
    assert got.collectives == want.collectives
    assert got.dominant == max(
        ("compute", got.compute_s), ("memory", got.memory_s),
        ("collective", got.collective_s), key=lambda kv: kv[1])[0]
    assert got.mfu is None
    step = got.with_step(0.5)
    assert step.mfu == got.model_flops / (0.5 * hw.PEAK_FLOPS_BF16)
    assert step.to_json()["step_seconds"] == 0.5


def test_t_model_flops():
    """T (OLMoE-1B-7B, 4 of 16 layers, 4 x 4096 tokens): 475,004,928 active
    parameters, 6 * N_active * D model FLOPs."""
    import dataclasses

    from repro_torch.configs import ShapeConfig

    cfg = dataclasses.replace(get("olmoe-1b-7b"), n_layers=4)
    assert analyze.count_params(cfg) == (1_884_291_072, 475_004_928)
    shape = ShapeConfig("train_4k", "train", 4096, 4)
    assert analyze.model_flops(cfg, shape) == 6.0 * 475_004_928 * 4 * 4096


def test_hw_constants():
    assert hw.PEAK_FLOPS_BF16 == 989e12 and hw.PEAK_FLOPS_FP32 == 67e12
    assert hw.HBM_BW == 3.35e12 and hw.NVLINK_BW == 450e9
    assert 79 * 2**30 < hw.HBM_BYTES < 80 * 2**30


def _meta_cases():
    """(kernel id, wrapper call on a device, cost) for each kernel at a
    small shape."""
    def fence(dev):
        packed = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(
            4, 8, 3).to(dev)
        return a2a_fence.rma_alltoallv_fence(packed, 4, 2), 2 * 4 * 8 * 3 * 4, 0

    def lock(dev):
        packed = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(
            4, 8, 3).to(dev)
        return (a2a_lock.rma_alltoallv_lock(packed, 4, 2, [2, 1, 0, 2]),
                2 * 4 * 8 * 3 * 4, 0)

    def fused(dev):
        x = torch.ones(4, 5, 6, dtype=torch.bfloat16, device=dev)
        idx = torch.zeros(4, 8, dtype=torch.int32, device=dev)
        valid = torch.ones(4, 8, dtype=torch.bool, device=dev)
        out = a2a_fence.rma_alltoallv_fence_fused(x, idx, valid, 4, 2)
        return out, 4 * 5 * 6 * 2 + 4 * 8 * 5 + 4 * 8 * 6 * 2, 0

    def gather(dev):
        x = torch.ones(2, 5, 4, dtype=torch.float32, device=dev)
        x2 = torch.ones(2, 3, 4, dtype=torch.float32, device=dev)
        idx = torch.zeros(2, 7, dtype=torch.int32, device=dev)
        valid = torch.ones(2, 7, dtype=torch.bool, device=dev)
        out = gather_rows.gather_rows(x, idx, valid, x2=x2)
        return out, (2 * 5 + 2 * 3 + 2 * 7) * 16 + 2 * 7 * 5, 0

    def hier(dev):
        s1 = torch.ones(4, 6, 2, dtype=torch.float32, device=dev)
        src = torch.zeros(4, 5, dtype=torch.int32, device=dev)
        valid = torch.ones(4, 5, dtype=torch.bool, device=dev)
        frm = torch.full((4, 2), -1, dtype=torch.int32, device=dev)
        rr = torch.zeros(5, dtype=torch.int16, device=dev)
        out = a2a_hier.rma_hier_leader_exchange(s1, src, valid, frm, rr)
        return (out, 4 * 6 * 8 + 4 * 5 * 5 + 4 * 2 * 4 + 5 * 2 + 4 * 5 * 8,
                0)

    def matmul(dev):
        x = torch.ones(6, 8, dtype=torch.float32, device=dev)
        idx = torch.zeros(3, 4, dtype=torch.int32, device=dev)
        valid = torch.ones(3, 4, dtype=torch.bool, device=dev)
        w = torch.ones(3, 8, 5, dtype=torch.float32, device=dev)
        out = gather_matmul.gather_matmul(x, idx, valid, w)
        return (out, (6 * 8 + 3 * 8 * 5 + 3 * 4 * 5) * 4 + 3 * 4 * 5,
                2 * 3 * 4 * 8 * 5)

    return [("K2", fence), ("K4", lock), ("K3", fused), ("K1", gather),
            ("K5", hier), ("K6", matmul)]


@pytest.mark.parametrize("case", range(6))
def test_wrapper_meta_path(case):
    """On ``meta`` each wrapper returns the plain version's shape and dtype,
    counts no launch and no plain call, and reports one call of its kernel
    with the cost of its shapes, as the CPU run does."""
    kid, fn = _meta_cases()[case]
    got = {}
    for dev in ("cpu", "meta"):
        _build.reset_counts()
        with StepCounter() as counter:
            out, nbytes, flops = fn(dev)
        counts = _build.counts()
        got[dev] = out
        assert counter.kernels[kid] == {"calls": 1, "flops": flops,
                                        "bytes": nbytes}, dev
        assert sum(c["calls"] for k, c in counter.kernels.items()
                   if k != kid) == 0
        assert counter.aten_flops == 0
        assert all(c["launches"] == 0 for c in counts.values())
        plain = sum(c["plain_calls"] for c in counts.values())
        assert plain == (1 if dev == "cpu" else 0), (dev, counts)
    assert got["meta"].device.type == "meta"
    assert got["meta"].shape == got["cpu"].shape
    assert got["meta"].dtype == got["cpu"].dtype


def test_plain_aten_ops_hidden_and_no_counter_no_cost():
    """The plain version's bmm inside K6 is not counted as aten FLOPs; a
    call without a counter reports nothing and costs one check."""
    x = torch.ones(6, 8)
    idx = torch.zeros(3, 4, dtype=torch.int32)
    valid = torch.ones(3, 4, dtype=torch.bool)
    w = torch.ones(3, 8, 5)
    assert trace.active() is None
    with StepCounter() as c:
        gather_matmul.gather_matmul_kernel(x, idx, valid, w)
        torch.bmm(torch.ones(3, 4, 8), w)
        assert trace.active() is c
    assert c.aten_flops == 2 * 3 * 4 * 8 * 5
    assert c.kernels["K6"]["flops"] == 2 * 3 * 4 * 8 * 5
    assert c.flops == 2 * c.aten_flops


def test_live_bytes_high_water():
    """Live storage: what was held at the start, plus the peak of what the
    ops made and freed; a view adds nothing."""
    held = torch.zeros(256, device="meta")
    with StepCounter() as c:
        c.hold(held)
        a = torch.empty(1024, device="meta") + 1          # 4 KiB (+ 4 KiB temp)
        v = a.view(32, 32)
        del a, v
        b = held * 2
    assert c.live_start_bytes == 1024
    assert c.live_peak_bytes == 1024 + 2 * 4096
    assert c.live_bytes == 1024 + 1024
    del b
