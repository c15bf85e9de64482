"""The port's serving path (OLMoE-1B-7B reduced) against the JAX package.

One JAX subprocess (``tests/_torch_parity_jax_moe.py serve``, 8 host
devices) draws the reduced OLMoE's parameters with
``init_model(jax.random.key(0), cfg)`` and runs JAX's prefill bundle on a
(1, 8) mesh and its ``ServeEngine`` on a (1, 1) mesh.  The port carries the
parameters across with ``params_from_jax`` and runs on
``VirtualMesh(..., device="cpu")``, every kernel taking its plain version.

Tolerances: prefill logits and caches within ``rtol=1e-4, atol=1e-5``
(float32, sums in another order); greedy tokens equal.  The prefill token
counts are multiples of 8 ranks x 8 rows, so no EP rank carries padding and
the JAX package's routing is right there; generation is held against JAX's
(1, 1) mesh, whose gspmd dispatch has no padding either.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity_jax_moe as parity
from repro_torch import planstore
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api, moe, transformer
from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules
from repro_torch.serve import ServeEngine, sampler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_serve") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_parity_jax_moe.py"),
         "serve", str(out)], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def jax_tree(ref) -> dict:
    """The JAX parameter tree as nested dicts of numpy arrays."""
    tree: dict = {}
    for key, v in ref.items():
        if not key.startswith("params/"):
            continue
        node = tree
        *path, leaf = key[len("params/"):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def with_cf(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_params_from_jax_round_trips_every_key(jax_ref):
    """Every key and shape of the JAX tree arrives, values unchanged, and
    the port's own ``init_model`` draws a tree of the same keys and
    shapes."""
    tree = jax_tree(jax_ref)
    got = flat(api.params_from_jax(tree, "cpu"))
    want = flat(tree)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v)
    own, _ = api.init_model(get_reduced("olmoe-1b-7b"),
                            torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in flat(own).items()} == \
        {k: v.shape for k, v in want.items()}
    bf16 = flat(api.params_from_jax(tree, "cpu", dtype=torch.bfloat16))
    assert all(v.dtype == torch.bfloat16 for v in bf16.values())


@pytest.mark.parametrize("case", parity.PREFILL, ids=lambda c: "b{}xs{}-cf{:g}".format(*c))
def test_prefill_matches_jax(jax_ref, case):
    """The prefill bundle on VirtualMesh((1, 8)) against JAX's on a (1, 8)
    host mesh: last logits and both caches.  At capacity factor 0.5 (t_loc
    64, capacity 8, about 16 entries per expert) entries are dropped, and
    the two packages drop the same ones."""
    b, s, cf = case
    cfg = with_cf(get_reduced("olmoe-1b-7b"), cf)
    mesh = make_mesh((1, 8), ("data", "model"), device="cpu")
    bundle = steps.make_prefill_bundle(cfg, ShapeConfig("p", "prefill", s, b), mesh)
    assert bundle.moe_plan.ep_size == 8 and bundle.moe_plan.plan_backed
    params = api.params_from_jax(jax_tree(jax_ref), "cpu")
    tag = f"prefill/{b}x{s}"
    tokens = torch.from_numpy(jax_ref[f"{tag}/tokens"])
    with torch.no_grad(), moe.count_kept() as kept:
        logits, caches = bundle(params, tokens)
    entries = b * s * cfg.moe.top_k
    assert len(kept) == cfg.n_layers
    if cf < 1:
        assert all(n < entries for n in kept), kept
    np.testing.assert_allclose(logits.numpy(), jax_ref[f"{tag}/logits"],
                               rtol=1e-4, atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(caches[0][name].numpy(),
                                   jax_ref[f"{tag}/{name}"], rtol=1e-4, atol=1e-5)


def test_generate_matches_jax(jax_ref):
    """Greedy tokens of the port's ServeEngine on VirtualMesh((1, 8)) equal
    JAX's ServeEngine on a (1, 1) mesh, at a no-drop capacity factor."""
    b, s, n, max_seq = parity.GENERATE
    cfg = with_cf(get_reduced("olmoe-1b-7b"), 8.0)
    eng = ServeEngine(cfg, make_mesh((1, 8), ("data", "model"), device="cpu"),
                      batch=b, prompt_len=s, max_seq=max_seq,
                      params=api.params_from_jax(jax_tree(jax_ref), "cpu"))
    assert eng.moe_plan.ep_size == 8 and eng.moe_plan.tokens_per_shard == 8
    toks, stats = eng.generate(jax_ref["generate/prompts"], n)
    np.testing.assert_array_equal(toks, jax_ref["generate/tokens"])
    assert stats.tokens_generated == b * n


def test_decode_matches_forward():
    """The engine's cached decode loop gives the greedy tokens of uncached
    forward passes over the growing sequence (``tests/test_serve.py``'s
    test of the same name, for the port's OLMoE)."""
    cfg = with_cf(get_reduced("olmoe-1b-7b"), 8.0)
    mesh = make_mesh((1, 8), ("data", "model"), device="cpu")
    eng = ServeEngine(cfg, mesh, batch=2, prompt_len=16, max_seq=48, seed=0)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    toks, stats = eng.generate(prompts, n_tokens=6)

    seq = torch.from_numpy(prompts)
    with torch.no_grad(), axis_rules(DEFAULT_RULES, mesh):
        for _ in range(6):
            # moe_plan=None: apply_moe plans for each growing token count,
            # so the EP ranks carry padding from the second pass on.
            logits, _, _ = transformer.forward(eng.params, cfg, seq)
            nxt = sampler.greedy(logits[:, -1].float())
            seq = torch.cat([seq, nxt[:, None]], 1)
    np.testing.assert_array_equal(toks, seq[:, 16:].numpy())
    assert stats.tokens_generated == 12


def test_serve_cli_runs_on_the_cpu(capsys):
    stats = serve_cli.main(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                            "cpu", "--mesh", "1,8", "--batch", "2",
                            "--prompt-len", "16", "--tokens", "3"])
    assert stats.tokens_generated == 6 and stats.prefill_seconds > 0
    assert "generated (2, 3) on cpu" in capsys.readouterr().out


def test_engine_without_device_raises():
    """The engine runs on its mesh's device, CUDA by default: with no card
    it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_reduced("olmoe-1b-7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, make_mesh((1, 8), ("data", "model")), batch=2,
                    prompt_len=16, max_seq=24)


def test_engine_checks_lengths_and_unported_options(tmp_path):
    """Lengths are checked; ``plan_store`` is ported: it becomes the
    process's default plan store.  The train launcher's ``--chaos`` is
    ported too (``tests/test_torch_resilience.py``): it parses its spec as
    the JAX package's ``ChaosInjector.parse`` does, and a malformed spec
    raises."""
    cfg = get_reduced("olmoe-1b-7b")
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq"):
        ServeEngine(cfg, mesh, batch=1, prompt_len=32, max_seq=16)
    try:
        eng = ServeEngine(cfg, mesh, batch=1, prompt_len=8, max_seq=16,
                          plan_store=str(tmp_path / "store"))
        assert eng.plan_store is planstore.default_store()
        assert eng.plan_store.root == str(tmp_path / "store")
    finally:
        planstore.configure(None)
    eng = ServeEngine(cfg, mesh, batch=1, prompt_len=8, max_seq=16)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.generate(np.zeros((1, 8), np.int32), 9)
    from repro_torch.launch import train as train_launcher
    # The chaos spec is parsed as the JAX package's ChaosInjector.parse
    # parses it: "kill:1" is no k=v pair.
    with pytest.raises(ValueError, match="is not k=v"):
        train_launcher.main(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                             "cpu", "--chaos", "kill:1"])


def test_sampler():
    logits = torch.tensor([[0.0, 3.0, 1.0], [5.0, 0.0, 4.9]])
    assert sampler.greedy(logits).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(sampler.sample(logits, gen, temperature=0.0),
                       sampler.greedy(logits))
    draws = sampler.sample(logits.expand(64, 2, 3).reshape(128, 3), gen,
                           temperature=1.0, top_k=2)
    assert draws.dtype == torch.int32 and set(draws.tolist()) <= {0, 1, 2}
    assert (draws.view(64, 2)[:, 0] != 0).all()      # top-2 of row 0: 1, 2
