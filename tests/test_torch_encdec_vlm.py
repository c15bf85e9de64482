"""The audio and vision families of the port against the JAX package:
cross-attention (``x_kv``, key positions, the static cache, bf16 queries
against float32 encoder states), ``sinusoidal_positions``, the reduced
Whisper-base (encoder, training logits, prefill plus greedy decode over
the primed cross caches, the engine, loss and gradients, and bf16 weights
with float32 frames) and the reduced InternVL2-26B (the projector, forward
logits with the projected patches, prefill plus decode through the serve
bundles, ``vlm_loss`` and its gradients); and the two behaviours of the
JAX engine that the port does not copy (ROADMAP.md queue 3).

One JAX subprocess (``tests/_torch_parity_jax_ssm.py encdec``, ~40 s
alone) writes the references.  Tolerances: ``_torch_family_checks``'s for
float32 (logits rtol 1e-4, atol 1e-5; attention outputs likewise); the
bf16 cross caches within 1e-2 x max|JAX| (one bf16 rounding of the same
float32 product), bf16 logits within 3e-2 x max|JAX| (bf16 products
rounded in another order).
"""

import numpy as np
import pytest
import torch

import _torch_family_checks as chk
import _torch_parity_jax_ssm as parity
from _torch_family_checks import t
from repro_torch import configs
from repro_torch.configs import ShapeConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention, embedding, transformer, vlm, whisper
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import grow_caches

WHISPER, VLM = parity.ARCHS_ENCDEC


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return chk.run_reference("encdec", tmp_path_factory.mktemp("jax_encdec") / "ref.npz")


def cpu_mesh():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


def test_sinusoidal_positions_match_jax(ref):
    chk.close(embedding.sinusoidal_positions(37, 24), ref["sinusoidal"],
              rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["x_kv", "kv_positions", "static", "bf16"])
def test_cross_attention_matches_jax(ref, case):
    """``x_kv`` (no rope on either side), ``kv_positions`` with a causal
    mask, the static cache (K/V read at positions 0..T-1, nothing
    written), and bf16 queries and weights against float32 encoder
    states (promoted, output in bf16)."""
    cr = parity.CROSS
    p = {k: t(v) for k, v in chk.subtree(ref, "cross/params/").items()}
    x, enc = t(ref["cross/x"]), t(ref["cross/enc"])
    pos = (torch.arange(cr["s"]) + 3)[None].expand(cr["b"], -1)
    kw = dict(n_heads=cr["heads"], n_kv=cr["kv"], head_dim=cr["dh"],
              positions=pos, causal=False, rope_theta=10000.0)
    with torch.no_grad():
        if case == "x_kv":
            y, _ = attention.apply_attention(p, x, x_kv=enc, **kw)
            want = ref["cross/y"]
        elif case == "kv_positions":
            y, _ = attention.apply_attention(
                p, x, x_kv=enc, kv_positions=t(ref["cross/kv_positions"]),
                **dict(kw, causal=True))
            want = ref["cross/y_kvpos"]
        elif case == "static":
            cache = {"k": t(ref["cross/ck"]), "v": t(ref["cross/cv"])}
            before = {k: v.clone() for k, v in cache.items()}
            y, out = attention.apply_attention(p, x, kv_cache=cache,
                                               cache_index=None, **kw)
            assert out is cache
            assert all(torch.equal(cache[k], before[k]) for k in cache)
            want = ref["cross/y_static"]
        else:
            pb = {k: v.to(torch.bfloat16) for k, v in p.items()}
            y, _ = attention.apply_attention(pb, x.to(torch.bfloat16), x_kv=enc, **kw)
            assert y.dtype == torch.bfloat16 and bool(ref["cross/y_bf16_dtype_is_bf16"])
            want = ref["cross/y_bf16"]
            chk.close(y, want, rtol=0, atol=3e-2 * float(np.abs(want).max()))
            return
    chk.close(y, want)


# ---------------------------------------------------------------------------
# Whisper-base (reduced)
# ---------------------------------------------------------------------------


def whisper_prefill(params, cfg, frames, tokens, dtype=torch.float32):
    """The prefill bundle's steps, keeping every position's logits."""
    enc = whisper.encode(params, cfg, frames, remat=False)
    caches = whisper.init_dec_caches(cfg, parity.BATCH, min(cfg.max_seq, 448),
                                     frames.shape[1], dtype)
    caches = whisper.prime_cross_caches(params, cfg, enc, caches)
    return whisper.decode(params, cfg, tokens, None, caches=caches,
                          cache_index=0, remat=False)


def test_whisper_params_round_trip_every_key(ref):
    chk.check_round_trip(ref, WHISPER, ("pos_embed", "enc/attn/wq",
                                        "dec/cross_attn/wk", "dec/ln_c/scale",
                                        "ln_enc_f/bias"))
    assert chk.port_params(ref, WHISPER)["enc"]["attn"]["wq"].shape[0] == 2


def test_whisper_encoder_and_training_logits_match_jax(ref):
    cfg = configs.get_reduced(WHISPER)
    params = chk.port_params(ref, WHISPER)
    with torch.no_grad():
        enc = whisper.encode(params, cfg, t(ref[f"{WHISPER}/frames"]))
        logits, caches = whisper.decode(params, cfg, t(ref[f"{WHISPER}/tokens"]), enc)
    assert caches is None
    chk.close(enc, ref[f"{WHISPER}/enc"])
    chk.close(logits, ref[f"{WHISPER}/logits"])


def test_whisper_prefill_and_decode_match_jax(ref):
    """Encode, prime the cross caches at the frames' length, decode the
    prompt, then greedy decode steps over the same cross caches; then the
    port's ``ServeEngine.generate(..., frames=)`` gives those tokens."""
    cfg = configs.get_reduced(WHISPER)
    params = chk.port_params(ref, WHISPER)
    frames, tokens = ref[f"{WHISPER}/frames"], ref[f"{WHISPER}/tokens"]
    with torch.no_grad():
        logits, caches = whisper_prefill(params, cfg, t(frames), t(tokens))
    chk.close(logits, ref[f"{WHISPER}/prefill_logits"])
    assert caches["ck"].shape[2] == parity.FRAMES

    def step(tok, c, index):
        return whisper.decode(params, cfg, tok, None, caches=c, cache_index=index)

    chk.check_decode_steps(ref, WHISPER, step, caches, parity.PROMPT)
    eng = ServeEngine(cfg, cpu_mesh(), batch=parity.BATCH,
                      prompt_len=parity.FRAMES, max_seq=parity.ENGINE_MAX_SEQ,
                      params=params)
    toks, _ = eng.generate(tokens, parity.DECODE + 1, frames=frames)
    np.testing.assert_array_equal(toks, ref[f"{WHISPER}/greedy"])


def test_whisper_engine_cross_cache_padding_fault_of_the_reference(ref):
    """The JAX engine grows its cross caches from the frames' length to
    ``max_seq`` with zero rows (``src/repro/serve/engine.py:135-150``,
    ``src/repro/launch/steps.py:258-262``) and decode attends over them
    unmasked (``src/repro/models/attention.py:234-237``): its decode logits
    and greedy tokens differ from ``whisper.decode`` over the cross caches
    prefill primed.  The port's engine keeps the encoder's length and
    gives the unpadded tokens (previous test)."""
    assert int(ref[f"{WHISPER}/engine_cross_len"]) == parity.ENGINE_MAX_SEQ > parity.FRAMES
    padded, want = ref[f"{WHISPER}/engine_decode0_logits"], ref[f"{WHISPER}/decode0_logits"]
    assert float(np.abs(padded - want).max()) > 0.1 * float(np.abs(want).max())
    assert not np.array_equal(ref[f"{WHISPER}/engine_greedy"], ref[f"{WHISPER}/greedy"])
    cfg = configs.get_reduced(WHISPER)
    eng = ServeEngine(cfg, cpu_mesh(), batch=parity.BATCH,
                      prompt_len=parity.FRAMES, max_seq=parity.ENGINE_MAX_SEQ,
                      params=chk.port_params(ref, WHISPER))
    with torch.no_grad():
        _, caches = eng.prefill_bundle(eng.params, t(ref[f"{WHISPER}/frames"]),
                                       t(ref[f"{WHISPER}/tokens"]))
    grown = grow_caches(caches, eng.max_seq)
    assert grown["ck"].shape[2] == parity.FRAMES
    assert grown["k"].shape[2] == min(cfg.max_seq, 448)


def test_whisper_loss_and_grads_match_jax(ref):
    chk.check_loss_and_grads(ref, WHISPER, {"frames": t(ref[f"{WHISPER}/frames"]),
                                            "tokens": t(ref[f"{WHISPER}/tokens"])})


def test_whisper_bf16_weights_with_float32_frames_match_jax(ref):
    """bf16 weights and caches, float32 frames: the encoder runs in
    float32 (JAX's promotion of the frames against the weights), the cross
    caches are its products rounded to bf16, the decoder runs in bf16."""
    cfg = configs.get_reduced(WHISPER)
    params = chk.model_api.params_from_jax(
        chk.subtree(ref, f"{WHISPER}/params/"), "cpu", torch.bfloat16)
    with torch.no_grad():
        enc = whisper.encode(params, cfg, t(ref[f"{WHISPER}/frames"]))
        assert enc.dtype == torch.float32
        logits, caches = whisper_prefill(params, cfg, t(ref[f"{WHISPER}/frames"]),
                                         t(ref[f"{WHISPER}/tokens"]), torch.bfloat16)
    assert logits.dtype == torch.bfloat16 and caches["ck"].dtype == torch.bfloat16
    want_ck = ref[f"{WHISPER}/bf16_ck"]
    chk.close(caches["ck"], want_ck, rtol=0, atol=1e-2 * float(np.abs(want_ck).max()))
    want = ref[f"{WHISPER}/bf16_prefill_logits"]
    chk.close(logits, want, rtol=0, atol=3e-2 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# InternVL2-26B (reduced)
# ---------------------------------------------------------------------------


def test_vlm_params_round_trip_every_key(ref):
    chk.check_round_trip(ref, VLM, ("projector/ln_scale", "projector/w1",
                                    "projector/w2", "attn/wq", "mlp/w_gate"))


def test_vlm_projector_and_forward_match_jax(ref):
    cfg = configs.get_reduced(VLM)
    params = chk.port_params(ref, VLM)
    with torch.no_grad():
        img = vlm.project_patches(params["projector"], t(ref[f"{VLM}/patches"]))
        logits, _, _ = transformer.forward(params, cfg, t(ref[f"{VLM}/tokens"]),
                                           extra_embeds=img)
    chk.close(img, ref[f"{VLM}/img"])
    chk.close(logits, ref[f"{VLM}/logits"])


def test_vlm_prefill_and_decode_bundles_match_jax(ref):
    """The prefill bundle takes ``(patches, tokens)`` (caches sized patches
    + text), then decode steps through the decode bundle along JAX's
    greedy tokens; the last-position prefill logits and every step's
    against JAX's."""
    cfg = configs.get_reduced(VLM)
    params = chk.port_params(ref, VLM)
    n_all = cfg.frontend_len + parity.TOKENS
    mesh = cpu_mesh()
    pre = steps_mod.make_prefill_bundle(
        cfg, ShapeConfig("p", "prefill", n_all, parity.BATCH), mesh)
    dec = steps_mod.make_decode_bundle(
        cfg, ShapeConfig("d", "decode", n_all + parity.DECODE + 1, parity.BATCH), mesh)
    with torch.no_grad():
        last, caches = pre(params, t(ref[f"{VLM}/patches"]), t(ref[f"{VLM}/tokens"]))
    chk.close(last, ref[f"{VLM}/prefill_logits"][:, -1])
    max_seq = n_all + parity.DECODE + 1
    caches = grow_caches(caches, max_seq)
    greedy = ref[f"{VLM}/greedy"]
    nxt = torch.argmax(last.float(), -1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(nxt.numpy(), greedy[:, :1])
    with torch.no_grad():
        for d in range(parity.DECODE):
            tok = t(greedy[:, d:d + 1])
            logits, _, _ = transformer.forward(params, cfg, tok, caches=caches,
                                               cache_index=n_all + d)
            chk.close(logits, ref[f"{VLM}/decode{d}_logits"], msg=str(d))
    with torch.no_grad():
        _, caches = pre(params, t(ref[f"{VLM}/patches"]), t(ref[f"{VLM}/tokens"]))
        caches = grow_caches(caches, max_seq)
        toks = []
        for d in range(parity.DECODE):
            nxt, caches = dec(params, caches, nxt, n_all + d)
            toks.append(nxt.numpy())
    np.testing.assert_array_equal(np.concatenate(toks, 1), greedy[:, 1:])


def test_vlm_engine_gap_of_the_reference(ref):
    """The JAX engine cannot serve vlm: ``generate`` passes only the
    prompts (``src/repro/serve/engine.py:91-96``), the prefill bundle
    wants ``(patches, tokens)`` (``src/repro/launch/steps.py:355-357``).
    The port keeps that gap (no engine feature): its engine raises too,
    and the bundles serve it (previous test)."""
    assert str(ref[f"{VLM}/engine_error"]).startswith("ValueError")
    cfg = configs.get_reduced(VLM)
    n_all = cfg.frontend_len + parity.TOKENS
    eng = ServeEngine(cfg, cpu_mesh(), batch=parity.BATCH, prompt_len=n_all,
                      max_seq=n_all + 4, params=chk.port_params(ref, VLM))
    with pytest.raises(ValueError):
        eng.generate(ref[f"{VLM}/tokens"], 2)


def test_vlm_loss_and_grads_match_jax(ref):
    chk.check_loss_and_grads(ref, VLM, {"patches": t(ref[f"{VLM}/patches"]),
                                        "tokens": t(ref[f"{VLM}/tokens"])})


def test_batch_specs_of_the_frontend_families():
    """``batch_spec`` as the JAX package's: Whisper's frames and
    ``min(max_seq, 448)`` tokens, InternVL2's patches and text tokens."""
    from repro_torch.models import api
    w, v = configs.get(WHISPER), configs.get(VLM)
    spec = api.batch_spec(w, 2, 1500)
    assert spec["frames"].shape == (2, 1500, 512) and spec["tokens"].shape == (2, 448)
    spec = api.batch_spec(v, 2, 4096)
    assert spec["patches"].shape == (2, 256, 3200) and spec["tokens"].shape == (2, 3840)
    assert spec["patches"].dtype == torch.bfloat16
