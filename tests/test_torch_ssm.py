"""The state-space pieces of the port against the JAX package:
``models/scan_utils.py`` (the chunked Mamba scan and the chunkwise mLSTM
across several chunks, their final states and gradients, both decode
steps), the Mamba, mLSTM and sLSTM blocks with their caches, and the
reduced xLSTM-125m (forward, prefill plus greedy decode, ``model_loss``
and its gradients, the parameter round trip).

One JAX subprocess (``tests/_torch_parity_jax_ssm.py ssm``, ~45 s alone)
writes every reference array; the port runs on the CPU.

Tolerances (float32).  The Mamba scan combines inside a chunk by log-step
doubling where XLA's ``associative_scan`` uses a tree, so sums associate
differently: outputs and final states within rtol 1e-5, atol 1e-5 x
max|JAX|; gradients rtol 1e-4, atol 1e-5 x max|JAX|.  The mLSTM, both
decode steps and the blocks: rtol 1e-5 (1e-4 for the blocks' outputs),
atol 1e-5 x max|JAX|.  The architecture: ``_torch_family_checks``.
"""

import numpy as np
import pytest
import torch

import _torch_family_checks as chk
import _torch_parity_jax_ssm as parity
from _torch_family_checks import t
from repro_torch.models import mamba, scan_utils, xlstm

ARCH = "xlstm-125m"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return chk.run_reference("ssm", tmp_path_factory.mktemp("jax_ssm") / "ref.npz")


def rel_close(got, want, rtol=1e-5, atol_rel=1e-5, msg=""):
    want = np.asarray(want)
    atol = atol_rel * max(float(np.abs(want).max()), 1e-30)
    chk.close(got, want, rtol=rtol, atol=atol, msg=msg)


@pytest.mark.parametrize("tag", ["mamba_scan", "mamba_scan_strong"])
def test_mamba_scan_matches_jax(ref, tag):
    """6 chunks of 16 steps; ``strong`` adds 4 to ``a_log`` so that
    ``exp(delta A)`` underflows to 0 in places (the cumulative-product
    form would divide by those zeros)."""
    names = ("delta", "a_log", "b", "c", "x")
    args = [t(ref[f"{tag}/{k}"]).requires_grad_(True) for k in names]
    y, h = scan_utils.chunked_mamba_scan(*args, chunk=parity.MAMBA_SCAN["chunk"],
                                         return_final_state=True)
    rel_close(y, ref[f"{tag}/y"], msg="y")
    rel_close(h, ref[f"{tag}/h"], msg="final state")
    loss = (y * t(ref[f"{tag}/cot"])).sum() + h.sum()
    grads = torch.autograd.grad(loss, args)
    for name, g in zip(names, grads):
        assert bool(torch.isfinite(g).all()), name
        rel_close(g, ref[f"{tag}/grad_{name}"], rtol=1e-4, msg=name)
    if tag == "mamba_scan_strong":
        a = torch.exp(t(ref[f"{tag}/delta"])[..., None]
                      * -torch.exp(t(ref[f"{tag}/a_log"])))
        assert bool((a == 0).any())


def test_mamba_scan_is_the_recurrence():
    """The doubling scan against the step-by-step recurrence it
    parallelises, at a chunk that is not a power of two."""
    gen = torch.Generator().manual_seed(3)
    b, s, c, n = 2, 40, 5, 3
    delta = torch.nn.functional.softplus(torch.randn(b, s, c, generator=gen))
    a_log = torch.randn(c, n, generator=gen)
    bm, cm = torch.randn(b, s, n, generator=gen), torch.randn(b, s, n, generator=gen)
    x = torch.randn(b, s, c, generator=gen)
    y, h_end = scan_utils.chunked_mamba_scan(delta, a_log, bm, cm, x, chunk=20,
                                             return_final_state=True)
    h = torch.zeros(b, c, n)
    for i in range(s):
        h, yi = scan_utils.mamba_decode_step(h, delta[:, i], a_log, bm[:, i],
                                             cm[:, i], x[:, i])
        torch.testing.assert_close(y[:, i], yi, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h_end, h, rtol=1e-5, atol=1e-5)


def test_mlstm_scan_matches_jax(ref):
    """4 chunks of 16: outputs, the carried (C~, n~, m) and the gradients,
    finite through the -inf causal mask."""
    names = ("q", "k", "v", "log_i", "log_f")
    args = [t(ref[f"mlstm_scan/{k}"]).requires_grad_(True) for k in names]
    y, (c, n, m) = scan_utils.chunkwise_mlstm(
        *args, chunk=parity.MLSTM_SCAN["chunk"], return_final_state=True)
    for name, got in (("y", y), ("c", c), ("n", n), ("m", m)):
        rel_close(got, ref[f"mlstm_scan/{name}"], msg=name)
    loss = (y * t(ref["mlstm_scan/cot"])).sum() + c.sum() + n.sum()
    grads = torch.autograd.grad(loss, args)
    for name, g in zip(names, grads):
        assert bool(torch.isfinite(g).all()), name
        rel_close(g, ref[f"mlstm_scan/grad_{name}"], rtol=1e-4, msg=name)


def test_mamba_decode_step_matches_jax(ref):
    p = "mamba_step/"
    h_new, y = scan_utils.mamba_decode_step(
        *(t(ref[p + k]) for k in ("h", "delta", "a_log", "b", "c", "x")))
    rel_close(h_new, ref[p + "h_new"])
    rel_close(y, ref[p + "y"])


@pytest.mark.parametrize("tag", ["mlstm_step", "mlstm_step_first"])
def test_mlstm_decode_step_matches_jax(ref, tag):
    """From a carried state and from the initial one (m = -1e30)."""
    p = f"{tag}/"
    (c, n, m), y = scan_utils.mlstm_decode_step(
        tuple(t(ref[p + k]) for k in ("c", "n", "m")),
        *(t(ref[p + k]) for k in ("q", "k", "v", "log_i", "log_f")))
    for name, got in (("c_new", c), ("n_new", n), ("m_new", m), ("y", y)):
        rel_close(got, ref[p + name], msg=name)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_block_prefill_and_decode_match_jax(ref, kind):
    """The block over 48 positions (3 chunks of 16 where it chunks) with
    ``return_cache``, then one decode step from that cache."""
    bl = parity.BLOCK
    params = chk.subtree(ref, f"blocks/params/{kind}/")
    params = {k: t(v) for k, v in params.items()}
    x, x1 = t(ref["blocks/x"]), t(ref["blocks/x1"])
    with torch.no_grad():
        if kind == "mamba":
            kw = dict(d_state=bl["d_state"], d_conv=bl["d_conv"])
            y, cache = mamba.apply_mamba(params, x, chunk=bl["chunk"],
                                         return_cache=True, **kw)
            y1, cache1 = mamba.mamba_decode_step(params, cache, x1, **kw)
        elif kind == "mlstm":
            y, cache = xlstm.apply_mlstm(params, x, n_heads=bl["heads"],
                                         chunk=bl["chunk"], return_cache=True)
            y1, cache1 = xlstm.mlstm_decode_step(params, cache, x1,
                                                 n_heads=bl["heads"])
        else:
            y, cache = xlstm.apply_slstm(params, x, n_heads=bl["heads"],
                                         return_cache=True)
            y1, cache1 = xlstm.slstm_decode_step(params, cache, x1,
                                                 n_heads=bl["heads"])
    rel_close(y, ref[f"blocks/{kind}/y"], rtol=1e-4, msg="y")
    rel_close(y1, ref[f"blocks/{kind}/y1"], rtol=1e-4, msg="y1")
    for tag, got in (("cache", cache), ("cache1", cache1)):
        want = chk.subtree(ref, f"blocks/{kind}/{tag}/")
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            rel_close(got[name], w, rtol=1e-4, msg=f"{tag}/{name}")


def test_caches_start_where_jax_starts():
    """The decode caches' initial values: mLSTM's and sLSTM's ``m`` at
    -1e30, everything else 0, recurrent state float32 whatever the cache
    dtype; Mamba's conv tail in the cache dtype."""
    from repro_torch import configs
    from repro_torch.models import transformer
    caches = transformer.init_caches(configs.get_reduced(ARCH), 2, 8,
                                     torch.bfloat16)
    assert sorted(caches[0]) == ["c", "m", "n"] and sorted(caches[1]) == ["c", "h", "m", "n"]
    for c in caches:
        for name, v in c.items():
            assert v.dtype == torch.float32 and v.shape[0] == 2
            assert bool((v == (-1e30 if name == "m" else 0.0)).all()), name
    jamba = transformer.init_caches(configs.get_reduced("jamba-v0.1-52b"), 2, 8,
                                    torch.bfloat16)
    assert jamba[0]["conv"].dtype == torch.bfloat16
    assert jamba[0]["ssm"].dtype == torch.float32
    assert sorted(jamba[4]) == ["k", "v"] and jamba[4]["k"].shape[2] == 8


def test_params_round_trip_every_key(ref):
    chk.check_round_trip(ref, ARCH, ("mlstm/wq", "mlstm/w_if", "slstm/r_gates",
                                     "slstm/w_gates"))


def test_forward_logits_match_jax(ref):
    chk.check_lm_forward(ref, ARCH)


def test_prefill_and_decode_match_jax(ref):
    chk.check_lm_prefill_decode(ref, ARCH)


def test_train_loss_and_grads_match_jax(ref):
    chk.check_loss_and_grads(ref, ARCH, {"tokens": t(ref[f"{ARCH}/tokens"])})
