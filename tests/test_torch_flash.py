"""The flash attention path of the port against the JAX package's
``_flash_attention`` (forward and vjp) and ``apply_attention``'s switch.

One JAX subprocess (``tests/_torch_parity_jax_families.py flash``, ~12 s
alone) writes the flash forward and vjp at S = 2048 with GQA g = 2 on two
position sets (aranges; and offset positions where the first key chunk is
fully masked for half the queries and 50 queries see no key at all, the
rows where the online softmax's ``exp(0)`` quirk shows), ``apply_attention``
at 4096 keys, and which (queries, keys) take the flash path.

Tolerances (float32): flash output and gradients rtol 1e-5, atol 1e-5 x
max|JAX|; ``apply_attention`` at 4096 keys rtol 1e-4, atol 1e-5; the path
taken, equal for every (queries, keys) of ``SWITCH``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity_jax_families as parity
from repro_torch.models import attention
from repro_torch.parallel.sharding import ParamFactory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_flash") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, "tests", "_torch_parity_jax_families.py"),
         "flash", str(out)], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def close(got, want, rtol=1e-5, rel_atol=1e-5, msg=""):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel_atol * float(np.abs(want).max()),
                               err_msg=msg)


@pytest.mark.parametrize("kind", parity.FLASH_POSITIONS)
def test_flash_forward_and_vjp_match_jax(ref, kind):
    q, k, v = (torch.from_numpy(ref[f"flash/{n}"]).requires_grad_(True)
               for n in ("q", "k", "v"))
    qp, kp = (torch.from_numpy(a) for a in parity.position_arrays(
        kind, parity.FLASH["s"]))
    scale = parity.FLASH["dh"] ** -0.5
    o = attention._flash_attention(q, k, v, qp, kp, True, scale)
    close(o.detach().numpy(), ref[f"flash/{kind}/o"], msg="o")
    grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(ref["flash/do"]))
    for name, g in zip(("dq", "dk", "dv"), grads):
        close(g.numpy(), ref[f"flash/{kind}/{name}"], msg=name)


def test_flash_keeps_the_masked_row_quirk(ref):
    """On the offset positions the first 50 queries see no key at all: both
    packages return the mean of v there (every masked key weighs exp(0)),
    as the direct path's softmax over equal scores does."""
    o = ref["flash/offset/o"][0, :50]                     # [50, N, G, dh]
    v = ref["flash/v"][0]                                  # [S, N, dh]
    mean = v.mean(0)[:, None, :]                           # [N, 1, dh]
    np.testing.assert_allclose(o, np.broadcast_to(mean, o.shape), rtol=1e-4,
                               atol=1e-5)
    qp, kp = (torch.from_numpy(a) for a in parity.position_arrays(
        "offset", parity.FLASH["s"]))
    q, k, vt = (torch.from_numpy(ref[f"flash/{n}"]) for n in ("q", "k", "v"))
    scale = parity.FLASH["dh"] ** -0.5
    mask = qp[:, :, None] >= kp[:, None, :]
    direct = attention._direct_attention(q, k, vt, mask, scale)
    flash = attention._flash_attention(q, k, vt, qp, kp, True, scale)
    close(flash.numpy(), direct.numpy(), rtol=1e-4, rel_atol=1e-5)


def test_flash_saves_no_score_matrix():
    """The autograd residuals are q, k, v, o, lse and the positions: no
    tensor of ``Sq x Sk`` elements is saved for the backward."""
    b, s, n, g, dh = 1, 2048, 1, 2, 8
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((b, s, n, g, dh), generator=gen, requires_grad=True)
    k = torch.randn((b, s, n, dh), generator=gen, requires_grad=True)
    v = torch.randn((b, s, n, dh), generator=gen, requires_grad=True)
    pos = torch.arange(s)[None]
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = attention._flash_attention(q, k, v, pos, pos, True, dh ** -0.5)
    assert o.grad_fn is not None and saved
    assert max(saved) < s * s, saved
    assert sorted(saved) == sorted([q.numel(), k.numel(), v.numel(), s, s,
                                    q.numel(), b * n * g * s])


def test_apply_attention_at_4096_keys_matches_jax(ref, monkeypatch):
    """``apply_attention`` at 4096 keys: both packages take the flash path
    (the port's counted by a spy), and the outputs agree."""
    cfg = parity.FLASH_APPLY
    prm = {k: torch.from_numpy(ref[f"apply/params/{k}"])
           for k in ("wq", "wk", "wv", "wo")}
    x = torch.from_numpy(ref["apply/x"])
    pos = torch.arange(cfg["s"])[None].expand(cfg["b"], -1)
    took = []
    real = attention._flash_attention
    monkeypatch.setattr(attention, "_flash_attention",
                        lambda *a: took.append(1) or real(*a))
    with torch.no_grad():
        y, _ = attention.apply_attention(
            prm, x, n_heads=cfg["n_heads"], n_kv=cfg["n_kv"],
            head_dim=cfg["head_dim"], positions=pos)
    assert took == [1]
    np.testing.assert_allclose(y.numpy(), ref["apply/y"], rtol=1e-4, atol=1e-5)


def test_flash_switch_matches_jax(ref, monkeypatch):
    """For every (queries, keys) of ``SWITCH`` (a KV cache of ``keys``
    positions) the port takes the flash path exactly where JAX's
    ``apply_attention`` does, and ``use_flash`` says so."""
    cfg = parity.FLASH_APPLY
    f = ParamFactory(torch.Generator().manual_seed(0))
    attention.init_attention(f.scope("attn"), cfg["d_model"], cfg["n_heads"],
                             cfg["n_kv"], cfg["head_dim"])
    prm = f.params["attn"]
    took = []
    monkeypatch.setattr(attention, "_flash_attention",
                        lambda q, *a: took.append(1) or torch.zeros_like(q))
    monkeypatch.setattr(attention, "_direct_attention",
                        lambda q, *a: torch.zeros_like(q))
    flags = []
    for sq, sk in parity.SWITCH:
        took.clear()
        cache = {"k": torch.zeros((1, sk, cfg["n_kv"], cfg["head_dim"])),
                 "v": torch.zeros((1, sk, cfg["n_kv"], cfg["head_dim"]))}
        with torch.no_grad():
            attention.apply_attention(
                prm, torch.zeros((1, sq, cfg["d_model"])),
                n_heads=cfg["n_heads"], n_kv=cfg["n_kv"],
                head_dim=cfg["head_dim"], positions=torch.arange(sq)[None],
                kv_cache=cache, cache_index=0)
        flags.append(bool(took))
        assert attention.use_flash(sq, sk) == bool(took)
    assert flags == ref["switch/flash"].tolist()
    assert any(flags) and not all(flags)
