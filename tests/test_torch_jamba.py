"""The reduced Jamba-v0.1 (the hybrid family: 8 layers, 7 Mamba and 1
attention at slot 4, MoE on every other layer) of the port against the
JAX package: forward logits, prefill plus greedy decode with the final
Mamba state and KV cache, ``model_loss`` and its gradients (remat on), the
parameter round trip; then, port-only, its MoE layers served through the
persistent dispatch on ``(1, 8)``.

One JAX subprocess (``tests/_torch_parity_jax_ssm.py jamba``, ~40 s
alone) writes the references; tolerances are ``_torch_family_checks``'s.
"""

import numpy as np
import pytest

import _torch_family_checks as chk
from _torch_family_checks import t
from repro_torch import configs

ARCH = "jamba-v0.1-52b"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return chk.run_reference("jamba", tmp_path_factory.mktemp("jax_jamba") / "ref.npz")


def test_registry_layout():
    """Slot 4 of every 8 is attention, the rest Mamba; MoE on odd slots."""
    cfg = configs.get_reduced(ARCH)
    assert [cfg.layer_kind(i) for i in range(8)] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [cfg.is_moe_layer(i) for i in range(8)] == [False, True] * 4
    assert configs.get(ARCH).moe.dispatch == "persistent_a2a"


def test_params_round_trip_every_key(ref):
    chk.check_round_trip(ref, ARCH, ("mamba/a_log", "mamba/dt_bias",
                                     "mamba/conv_w", "moe/w_gate", "attn/wq",
                                     "mlp/w_gate"))


def test_forward_logits_match_jax(ref):
    chk.check_lm_forward(ref, ARCH)


def test_prefill_and_decode_match_jax(ref):
    chk.check_lm_prefill_decode(ref, ARCH)


def test_train_loss_and_grads_match_jax(ref):
    chk.check_loss_and_grads(ref, ARCH, {"tokens": t(ref[f"{ARCH}/tokens"])})


def test_serve_on_ep8_dispatches_through_the_plan():
    """``ServeEngine`` on ``(1, 8)`` (EP 8, one expert per virtual rank):
    each forward calls the K2 and K6 plain versions exactly twice per MoE
    layer (8 each) and nothing else; the tokens are in range."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import ServeEngine

    cfg = configs.get_reduced(ARCH)
    eng = ServeEngine(cfg, make_mesh((1, 8), ("data", "model"), device="cpu"),
                      batch=2, prompt_len=16, max_seq=24)
    assert eng.moe_plan is not None and eng.moe_plan.ep_size == 8
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    _build.reset_counts()
    toks, _ = eng.generate(prompts.astype(np.int32), 3)
    ran = {k: v for k, v in _build.counts().items()
           if v["launches"] or v["plain_calls"]}
    assert ran == {"a2a_fence": {"launches": 0, "plain_calls": 8 * 3},
                   "gather_matmul": {"launches": 0, "plain_calls": 8 * 3}}, ran
    assert toks.shape == (2, 3) and ((toks >= 0) & (toks < cfg.vocab_size)).all()
