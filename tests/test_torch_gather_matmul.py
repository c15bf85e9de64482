"""K6's kernel-choice rule and the launch geometry of its wgmma kernel, on
the CPU.

``kernels.gather_matmul.kernel_for`` picks one of three hand-written
kernels for a CUDA call by dtype, shape and alignment (or the plain version
for CPU tensors), and ``wgmma_geometry`` computes the wgmma kernel's launch,
which its C launcher checks against its own numbers on the card.  Neither
needs a card, so both are pinned here: the serve path's shapes (taken from
the OLMoE-1B-7B prefill and decode bundles on EP 8) go to the wgmma kernel,
the other bfloat16 calls to the mma.sync kernel, float32 to the CUDA-core
kernel; every shape of ``chip_smoke.py``'s K6 sweep and of the serve path
fits an H100 block's shared memory, and up to 128 rows two blocks fit one
SM.  K6's values are held against the JAX package in
``tests/test_torch_moe.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import _build, gather_matmul as gm
from repro_torch.launch import steps
from repro_torch.launch.mesh import VirtualMesh

BASE = 0x7F00_0000_0000          # a 256-byte aligned device address
SM_SHARED = 228 * 1024           # an H100 SM's shared memory
MAX_DYNAMIC_SMEM = 232448        # an H100 block's opt-in shared memory
PER_BLOCK_EXTRA = 4096           # static shared memory (~1 KB) + the 1 KB the
                                 # card reserves per block, rounded up


def serve_shapes():
    """(E, N, D, F) of K6 in OLMoE-1B-7B's prefill (4 x 128 tokens) and
    decode (batch 4) on VirtualMesh((1, 8)), as the bundles build them."""
    cfg = get("olmoe-1b-7b")
    mesh = VirtualMesh((1, 8), ("data", "model"), device="cpu")
    out = {}
    for name, make, shape in (
            ("prefill", steps.make_prefill_bundle, ShapeConfig("p", "prefill", 128, 4)),
            ("decode", steps.make_decode_bundle, ShapeConfig("d", "decode", 152, 4))):
        plan = make(cfg, shape, mesh).moe_plan
        out[name] = (plan.n_experts, plan.ep_size * plan.chunk_capacity,
                     cfg.d_model, cfg.moe.d_expert)
    return out


@pytest.fixture(scope="module")
def serve():
    return serve_shapes()


def test_serve_shapes(serve):
    """The shapes ``chip_smoke.py`` times K6 at."""
    assert serve == {"prefill": (64, 128, 2048, 1024),
                     "decode": (64, 64, 2048, 1024)}


@pytest.mark.parametrize("shape", ["prefill", "decode"])
def test_serve_path_takes_wgmma(serve, shape):
    _, _, d, f = serve[shape]
    assert gm.kernel_choice("cuda", torch.bfloat16, d, f, BASE, BASE + 2**26) == "wgmma"


@pytest.mark.parametrize("d,f,x_off,w_off", [
    (100, 1024, 0, 0),       # D not a multiple of 8
    (2048, 60, 0, 0),        # F not a multiple of 8
    (2048, 1024, 2, 0),      # x one bf16 past an aligned base
    (2048, 1024, 0, 8),      # w 8 bytes past an aligned base
    (0, 1024, 0, 0),         # no D
])
def test_other_bf16_calls_take_mma_sync(d, f, x_off, w_off):
    assert gm.kernel_choice("cuda", torch.bfloat16, d, f, BASE + x_off,
                            BASE + w_off) == "mma_sync"


@pytest.mark.parametrize("d,f", [(2048, 1024), (100, 72), (128, 60)])
def test_float32_takes_cuda_cores(d, f):
    """No TF32: float32 stays exact on the CUDA cores."""
    assert gm.kernel_choice("cuda", torch.float32, d, f, BASE, BASE) == "cuda_core"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_takes_plain(dtype):
    """CPU tensors at a serve shape take the plain version and no kernel
    counter moves."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((40, 16), np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((2, 16, 24), np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 40, (2, 8)).astype(np.int32))
    valid = torch.from_numpy(rng.integers(0, 2, (2, 8)).astype(bool))
    assert gm.kernel_for(x, w) == "plain"
    before = _build.counts()
    out = gm.gather_matmul_kernel(x, idx, valid, w)
    after = _build.counts()
    for name in ("gather_matmul", "gather_matmul_wgmma"):
        assert after[name]["launches"] == before[name]["launches"]
    assert after["gather_matmul"]["plain_calls"] == before["gather_matmul"]["plain_calls"] + 1
    torch.testing.assert_close(out, gm.gather_matmul_plain(x, idx, valid, w),
                               rtol=0, atol=0)


SWEEP = [(e, n, f) for e in (1, 8, 64) for n in (8, 64, 128, 136, 256, 300)
         for f in (72, 1024)]


@pytest.mark.parametrize("e,n,f", SWEEP)
def test_geometry_fits_and_reads_w_once(e, n, f):
    """Shared memory within a block's opt-in limit; up to 256 rows one row
    chunk, so every (expert, F tile) block streams its w tile once."""
    g = gm.wgmma_geometry(e, n, f)
    assert g.smem_bytes <= MAX_DYNAMIC_SMEM
    assert g.smem_bytes % 1024 == 0
    assert g.rows_per_block == (128 if n <= 128 else 256)
    assert g.slots == g.rows_per_block // 128
    chunks = -(-n // g.rows_per_block)
    assert chunks == (1 if n <= 256 else 2)
    assert g.grid == chunks * e * -(-f // gm.WG_TILE_F)


@pytest.mark.parametrize("shape", ["prefill", "decode"])
def test_serve_geometry(serve, shape):
    """At the serve shapes: 512 blocks of 128 rows x 128 columns, a 3-stage
    ring of 32 KB stages, and two blocks to an SM."""
    e, n, _, f = serve[shape]
    g = gm.wgmma_geometry(e, n, f)
    assert (g.slots, g.rows_per_block, g.stages, g.grid) == (1, 128, 3, 512)
    assert g.smem_bytes == 3 * (gm.WG_W_BYTES + 2 * gm.WG_X_TILE_BYTES) + 1024
    assert 2 * (g.smem_bytes + PER_BLOCK_EXTRA) <= SM_SHARED
