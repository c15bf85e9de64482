"""Checks shared by the port's parity tests of the state-space, audio and
vision families (``tests/test_torch_ssm.py``, ``test_torch_jamba.py``,
``test_torch_encdec_vlm.py``): the JAX reference run in a subprocess, and
the comparisons every reduced architecture goes through.

Tolerances (float32, sums in another order):

| compared value | tolerance |
|---|---|
| forward, prefill and decode logits | rtol 1e-4, atol 1e-5 |
| final decode caches (KV and recurrent state) | rtol 1e-4, atol 1e-5 x max |
| greedy tokens | equal |
| training loss and metrics | rtol 1e-5 |
| gradients | rtol 1e-4, atol 1e-4 x the leaf's largest JAX gradient |
| parameter round trip | exact, every key |
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

import _torch_parity_jax_ssm as parity
from repro_torch import configs
from repro_torch._tree import leaves_with_paths
from repro_torch.models import api as model_api
from repro_torch.train import grad as grad_util

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_reference(mode: str, out) -> dict:
    """Run ``_torch_parity_jax_ssm.py MODE`` and load what it wrote."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_parity_jax_ssm.py"),
         mode, str(out)], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
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


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def port_params(ref, arch):
    return model_api.params_from_jax(subtree(ref, f"{arch}/params/"), "cpu")


def close(got, want, rtol=1e-4, atol=1e-5, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


def check_round_trip(ref, arch: str, want_keys) -> None:
    """``params_from_jax`` carries every key across exactly, and the
    port's own ``init_model`` draws the same keys, shapes and dtypes."""
    jtree = subtree(ref, f"{arch}/params/")
    want = dict(leaves_with_paths(jtree))
    have = dict(leaves_with_paths(port_params(ref, arch)))
    assert sorted(have) == sorted(want)
    for path, v in want.items():
        assert np.array_equal(have[path].numpy(), v), path
    cfg = configs.get_reduced(arch)
    own, specs = model_api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    own = dict(leaves_with_paths(own))
    assert sorted(own) == sorted(want)
    for path, v in want.items():
        assert tuple(own[path].shape) == v.shape, path
        assert own[path].dtype == torch.float32, path
    paths = " ".join(want)
    for key in want_keys:
        assert key in paths, key


def check_loss_and_grads(ref, arch: str, batch: dict) -> None:
    cfg = configs.get_reduced(arch)
    params = port_params(ref, arch)

    def loss_fn(p, b):
        return model_api.model_loss(p, cfg, b, remat=True)

    loss, metrics, grads = grad_util.value_and_grad(loss_fn, params, batch)
    np.testing.assert_allclose(float(loss), ref[f"{arch}/loss"], rtol=1e-5)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), ref[f"{arch}/metrics/{k}"],
                                   rtol=1e-5, err_msg=k)
    want = dict(leaves_with_paths(subtree(ref, f"{arch}/grads/")))
    have = dict(leaves_with_paths(grads))
    assert sorted(have) == sorted(want)
    for path, g in want.items():
        assert bool(torch.isfinite(have[path]).all()), path
        np.testing.assert_allclose(have[path].numpy(), g, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g).max()),
                                   err_msg=str(path))


def check_decode_steps(ref, arch: str, step, caches, index0: int):
    """Greedy decode along JAX's tokens: every step's logits."""
    greedy = ref[f"{arch}/greedy"]
    with torch.no_grad():
        for d in range(parity.DECODE):
            logits, caches = step(t(greedy[:, d:d + 1]), caches, index0 + d)
            close(logits, ref[f"{arch}/decode{d}_logits"], msg=f"step {d}")
    return caches


def check_lm_forward(ref, arch: str) -> None:
    from repro_torch.models import transformer
    cfg = configs.get_reduced(arch)
    with torch.no_grad():
        logits, _, _ = transformer.forward(port_params(ref, arch), cfg,
                                           t(ref[f"{arch}/tokens"]))
    close(logits, ref[f"{arch}/logits"])


def check_lm_prefill_decode(ref, arch: str) -> None:
    """Prefill into caches of ``MAX_SEQ`` positions, greedy decode steps
    (each step's logits against JAX's), the final caches (attention KV and
    every recurrent state, copied back into its stacked slot) against
    JAX's; then ``ServeEngine`` on (1, 1), whose ``grow_caches`` carries
    the recurrent state whole, gives JAX's greedy tokens."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    cfg = configs.get_reduced(arch)
    params = port_params(ref, arch)
    caches = transformer.init_caches(cfg, parity.BATCH, parity.MAX_SEQ,
                                     torch.float32)
    with torch.no_grad():
        logits, _, caches = transformer.forward(
            params, cfg, t(ref[f"{arch}/tokens"]), caches=caches, cache_index=0)
    close(logits, ref[f"{arch}/prefill_logits"])

    def step(tok, c, index):
        lg, _, c = transformer.forward(params, cfg, tok, caches=c,
                                       cache_index=index)
        return lg, c

    caches = check_decode_steps(ref, arch, step, caches, parity.TOKENS)
    want = dict(leaves_with_paths(subtree(ref, f"{arch}/final_caches/")))
    have = dict(leaves_with_paths(caches))
    assert sorted(have) == sorted(want)
    for path, w in want.items():
        scale = max(float(np.abs(w[np.abs(w) < 1e29]).max(initial=0.0)), 1.0)
        close(have[path], w, atol=1e-5 * scale, msg=path)
    eng = ServeEngine(cfg, make_mesh((1, 1), ("data", "model"), device="cpu"),
                      batch=parity.BATCH, prompt_len=parity.TOKENS,
                      max_seq=parity.MAX_SEQ, params=params)
    toks, _ = eng.generate(ref[f"{arch}/tokens"], parity.DECODE + 1)
    np.testing.assert_array_equal(toks, ref[f"{arch}/greedy"])
