"""The attention-only families of the port against the JAX package: the
dense FFN (``models/mlp.py``) in its four architectures (olmo-1b,
minicpm-2b, nemotron-4-15b, deepseek-67b) and Moonshot-v1-16B-A3B with its
shared experts, all at reduced size, and the registry.

One JAX subprocess (``tests/_torch_parity_jax_families.py families``, ~35
s alone) draws each architecture's parameters and writes its forward
logits, a prefill plus greedy decode steps and one training step's loss
and gradients, without a mesh.  The port carries the parameters across
with ``params_from_jax`` and runs on the CPU, where every kernel takes its
plain version.

Tolerances (float32, sums in another order):

| compared value | tolerance |
|---|---|
| forward, prefill and decode logits | rtol 1e-4, atol 1e-5 |
| greedy tokens (port's ``ServeEngine`` on (1, 1)) | equal |
| training loss and metrics | rtol 1e-5 |
| gradients | rtol 1e-4, atol 1e-4 x the leaf's largest JAX gradient |
| parameter round trip | exact, every key |
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity_jax_families as parity
from repro_torch import configs
from repro_torch._tree import leaves_with_paths
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api as model_api
from repro_torch.models import transformer
from repro_torch.serve import ServeEngine
from repro_torch.train import grad as grad_util

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = [a for a in parity.ARCHS if a != "moonshot-v1-16b-a3b"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_families") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, "tests", "_torch_parity_jax_families.py"),
         "families", str(out)], capture_output=True, text=True, timeout=600,
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


def port_params(ref, arch):
    return model_api.params_from_jax(subtree(ref, f"{arch}/params/"), "cpu")


FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab_size", "head_dim", "norm", "activation", "rope_theta",
          "tie_embeddings", "embed_scale", "residual_scale", "logit_scale",
          "qk_norm", "padded_vocab")
LATER = ("jamba-v0.1-52b", "internvl2-26b", "whisper-base", "xlstm-125m")


def test_registry_resolves_the_attention_only_families():
    """The five architectures of this slice resolve to the JAX package's
    configs, field for field."""
    from repro.configs import get as jget
    for arch in parity.ARCHS:
        cfg = configs.get(arch)
        assert cfg.name == arch and arch in configs.list_archs()
        want = jget(arch)
        for field in FIELDS:
            assert getattr(cfg, field) == getattr(want, field), (arch, field)
        if want.moe is not None:
            import dataclasses
            assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(want.moe)
        assert configs.get_reduced(arch).d_model == 128
    with pytest.raises(KeyError):
        configs.get("no-such-arch")


def test_registry_resolves_the_state_space_audio_and_vision_families():
    """The four architectures of the state-space, audio and vision
    families (ported after this slice) resolve field for field as the JAX
    package's, every dataclass field included (``mamba`` and ``xlstm``
    compared as dicts), full and reduced; the port's registry holds
    exactly the JAX package's architectures."""
    import dataclasses

    from repro.configs import get as jget
    from repro.configs import get_reduced as jget_reduced
    from repro.configs import list_archs as jlist
    assert configs.list_archs() == jlist()
    for arch in LATER:
        for cfg, want in ((configs.get(arch), jget(arch)),
                          (configs.get_reduced(arch), jget_reduced(arch))):
            assert dataclasses.asdict(cfg) == dataclasses.asdict(want), arch
            for field in FIELDS:
                assert getattr(cfg, field) == getattr(want, field), (arch, field)
            for sub in ("mamba", "xlstm", "moe"):
                a, b = getattr(cfg, sub), getattr(want, sub)
                assert (a is None) == (b is None), (arch, sub)
                if a is not None:
                    assert dataclasses.asdict(a) == dataclasses.asdict(b)
                    assert type(a).__name__ == type(b).__name__


@pytest.mark.parametrize("arch", parity.ARCHS)
def test_params_round_trip_every_key(ref, arch):
    """``params_from_jax`` carries every key of the JAX tree across, and
    the port's own ``init_model`` draws exactly the same keys, shapes and
    dtypes (``mlp/*``, ``moe/sh_*``, no norm parameters under
    ``nonparametric_ln``)."""
    jtree = subtree(ref, f"{arch}/params/")
    got = port_params(ref, arch)
    want = dict(leaves_with_paths(jtree))
    have = dict(leaves_with_paths(got))
    assert sorted(have) == sorted(want)
    for path, v in want.items():
        assert np.array_equal(have[path].numpy(), v), path
    cfg = configs.get_reduced(arch)
    own, _ = model_api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    own = dict(leaves_with_paths(own))
    assert sorted(own) == sorted(want)
    for path, v in want.items():
        assert tuple(own[path].shape) == v.shape, path
    paths = " ".join(want)
    if cfg.moe is not None:
        assert "moe/sh_gate" in paths and "moe/sh_down" in paths
    elif cfg.activation == "swiglu":
        assert "mlp/w_gate" in paths and "mlp/w_up" in paths
    else:
        assert "mlp/w_in" in paths
    assert ("ln1" in paths) == (cfg.norm != "nonparametric_ln")


@pytest.mark.parametrize("arch", parity.ARCHS)
def test_forward_logits_match_jax(ref, arch):
    cfg = configs.get_reduced(arch)
    params = port_params(ref, arch)
    tokens = torch.from_numpy(ref[f"{arch}/tokens"])
    with torch.no_grad():
        logits, _, _ = transformer.forward(params, cfg, tokens)
    np.testing.assert_allclose(logits.numpy(), ref[f"{arch}/logits"],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", parity.ARCHS)
def test_prefill_and_decode_match_jax(ref, arch):
    """Prefill into caches of ``MAX_SEQ`` positions, then greedy decode
    steps: every step's logits against JAX's; then the port's
    ``ServeEngine`` on (1, 1) gives JAX's greedy tokens."""
    cfg = configs.get_reduced(arch)
    params = port_params(ref, arch)
    tokens = torch.from_numpy(ref[f"{arch}/tokens"])
    caches = transformer.init_caches(cfg, parity.BATCH, parity.MAX_SEQ,
                                     torch.float32)
    with torch.no_grad():
        logits, _, caches = transformer.forward(params, cfg, tokens,
                                                caches=caches, cache_index=0)
        np.testing.assert_allclose(logits.numpy(),
                                   ref[f"{arch}/prefill_logits"],
                                   rtol=1e-4, atol=1e-5)
        greedy = ref[f"{arch}/greedy"]
        for d in range(parity.DECODE):
            nxt = torch.from_numpy(greedy[:, d:d + 1])
            logits, _, caches = transformer.forward(
                params, cfg, nxt, caches=caches,
                cache_index=parity.TOKENS + d)
            np.testing.assert_allclose(logits.numpy(),
                                       ref[f"{arch}/decode{d}_logits"],
                                       rtol=1e-4, atol=1e-5, err_msg=str(d))
    eng = ServeEngine(cfg, make_mesh((1, 1), ("data", "model"), device="cpu"),
                      batch=parity.BATCH, prompt_len=parity.TOKENS,
                      max_seq=parity.MAX_SEQ, params=params)
    toks, _ = eng.generate(ref[f"{arch}/tokens"], parity.DECODE + 1)
    np.testing.assert_array_equal(toks, greedy)
    assert eng.moe_plan is None or cfg.moe is not None


@pytest.mark.parametrize("arch", parity.ARCHS)
def test_train_step_loss_and_grads_match_jax(ref, arch):
    cfg = configs.get_reduced(arch)
    params = port_params(ref, arch)
    batch = {"tokens": torch.from_numpy(ref[f"{arch}/tokens"])}

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
        # atol scaled to the leaf: the embedding table's gradient sums the
        # contributions of repeated tokens, which cancel in places
        np.testing.assert_allclose(have[path].numpy(), g, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g).max()),
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", DENSE)
def test_dense_launchers_run_without_a_moe_plan(arch):
    """A dense model passes through the bundles, the engine and the
    trainer with ``moe_plan`` None: no dummy plan is built."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps as steps_mod
    from repro_torch.train import Trainer, TrainerConfig

    cfg = configs.get_reduced(arch)
    mesh = make_mesh((1, 8), ("data", "model"), device="cpu")
    eng = ServeEngine(cfg, mesh, batch=2, prompt_len=8, max_seq=12)
    assert eng.moe_plan is None and eng.prefill_bundle.moe_plan is None
    toks, _ = eng.generate(np.zeros((2, 8), np.int32), 3)
    assert toks.shape == (2, 3)
    bundle = steps_mod.make_train_bundle(
        cfg, ShapeConfig("t", "train", 16, 2), mesh)
    assert bundle.moe_plan is None
    result = Trainer(bundle, TrainerConfig(n_steps=2, log_every=1)).run()
    assert result["ep_dispatch"] is None and result["final_step"] == 2
