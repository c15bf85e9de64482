"""Reference outputs of the JAX package for the port's state-space, audio
and vision families.

    PYTHONPATH=src python tests/_torch_parity_jax_ssm.py MODE OUT.npz

Runs in a process of its own (8 host devices, fixed before JAX
initializes) and writes one ``.npz``.  MODE is one of:

  ssm     ``scan_utils`` (``chunked_mamba_scan`` and ``chunkwise_mlstm``
          across several chunks, their final states and the gradients of
          a cotangent-weighted sum; both decode steps), the Mamba, mLSTM
          and sLSTM blocks (prefill with ``return_cache``, then one decode
          step), and the reduced xLSTM-125m: forward logits, a prefill
          into caches of ``MAX_SEQ`` positions plus ``DECODE`` greedy
          decode steps, the final recurrent state, and ``model_loss`` with
          its gradients (remat on).  ``tests/test_torch_ssm.py`` reads it.
  jamba   the same for the reduced Jamba-v0.1 (8 layers: 7 Mamba, 1
          attention, 4 MoE).  ``tests/test_torch_jamba.py`` reads it.
  encdec  cross-attention (``x_kv``, the static cache, and bf16 queries
          against float32 encoder states), ``sinusoidal_positions``, and
          the reduced Whisper-base and InternVL2-26B (``ARCHS_ENCDEC``):
          Whisper's encoder output, training logits, prefill (encode,
          prime the cross caches, decode the prompt) plus greedy decode
          steps over the unpadded cross caches, its loss and gradients,
          and the JAX engine's behaviours: its decode logits over the
          cross caches it pads out to ``max_seq`` and its greedy tokens;
          InternVL2's forward logits with the projected patches, prefill
          plus decode steps, ``vlm_loss`` and its gradients, and the error
          the JAX engine raises when asked to serve it.  Whisper once more
          at bf16 with float32 frames (the JAX engine's promotion).
          ``tests/test_torch_encdec_vlm.py`` reads it.

The constants are plain data, so the test modules import them without
JAX.
"""

from __future__ import annotations

import json
import os
import sys

# scan_utils: [B, S, C] with N states at chunk Q (6 chunks); the strong
# decay case multiplies a_log so exp(delta * A) underflows to 0 in places.
MAMBA_SCAN = {"b": 2, "s": 96, "c": 12, "n": 8, "chunk": 16}
MLSTM_SCAN = {"b": 2, "s": 64, "h": 2, "dk": 8, "dv": 16, "chunk": 16}
# blocks: d_model, heads, prompt length (several chunks of BLOCK_CHUNK)
BLOCK = {"b": 2, "s": 48, "d": 32, "heads": 4, "chunk": 16,
         "d_state": 8, "d_conv": 4, "expand": 2}
ARCHS_SSM = ("xlstm-125m", "jamba-v0.1-52b")
ARCHS_ENCDEC = ("whisper-base", "internvl2-26b")
BATCH, TOKENS, MAX_SEQ, DECODE = 2, 16, 24, 3
# whisper: frames per example and prompt tokens (the serve launcher keeps 8)
FRAMES, PROMPT = 24, 8
ENGINE_MAX_SEQ = FRAMES + DECODE + 1 + 8
# cross-attention: queries, encoder length, width, heads
CROSS = {"b": 2, "s": 6, "t": 10, "d": 32, "heads": 4, "kv": 2, "dh": 8}


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = v


def _np(tree):
    import jax
    import numpy as np
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype.name == "bfloat16" else np.asarray(a), tree)


def mamba_scan_inputs(strong: bool):
    import numpy as np
    m = MAMBA_SCAN
    rng = np.random.default_rng(11 if strong else 10)
    f32 = np.float32
    delta = np.log1p(np.exp(rng.standard_normal((m["b"], m["s"], m["c"])))).astype(f32)
    a_log = np.log(np.broadcast_to(np.arange(1, m["n"] + 1, dtype=f32),
                                   (m["c"], m["n"]))).copy()
    if strong:
        a_log = (a_log + 4.0).astype(f32)
    b = rng.standard_normal((m["b"], m["s"], m["n"])).astype(f32)
    c = rng.standard_normal((m["b"], m["s"], m["n"])).astype(f32)
    x = rng.standard_normal((m["b"], m["s"], m["c"])).astype(f32)
    cot = rng.standard_normal((m["b"], m["s"], m["c"])).astype(f32)
    return {"delta": delta, "a_log": a_log, "b": b, "c": c, "x": x, "cot": cot}


def mlstm_scan_inputs():
    import numpy as np
    m = MLSTM_SCAN
    rng = np.random.default_rng(12)
    f32 = np.float32
    shp = (m["b"], m["s"], m["h"])
    out = {"q": rng.standard_normal(shp + (m["dk"],)).astype(f32),
           "k": rng.standard_normal(shp + (m["dk"],)).astype(f32),
           "v": rng.standard_normal(shp + (m["dv"],)).astype(f32),
           "log_i": rng.standard_normal(shp).astype(f32),
           # log sigmoid of a normal: the forget gate's log, <= 0
           "log_f": -np.log1p(np.exp(-rng.standard_normal(shp) - 2.0)).astype(f32),
           "cot": rng.standard_normal(shp + (m["dv"],)).astype(f32)}
    return out


def run_scans(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models import scan_utils as su

    for strong in (False, True):
        tag = "mamba_scan_strong" if strong else "mamba_scan"
        inp = mamba_scan_inputs(strong)
        for k, v in inp.items():
            out[f"{tag}/{k}"] = v
        args = tuple(jnp.asarray(inp[k]) for k in ("delta", "a_log", "b", "c", "x"))

        def f(*a):
            y, h = su.chunked_mamba_scan(*a, chunk=MAMBA_SCAN["chunk"],
                                         return_final_state=True)
            return jnp.sum(y * inp["cot"]) + jnp.sum(h), (y, h)

        (_, (y, h)), grads = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1, 2, 3, 4), has_aux=True))(*args)
        out[f"{tag}/y"], out[f"{tag}/h"] = np.asarray(y), np.asarray(h)
        for name, g in zip(("delta", "a_log", "b", "c", "x"), grads):
            out[f"{tag}/grad_{name}"] = np.asarray(g)

    inp = mlstm_scan_inputs()
    for k, v in inp.items():
        out[f"mlstm_scan/{k}"] = v
    names = ("q", "k", "v", "log_i", "log_f")
    args = tuple(jnp.asarray(inp[k]) for k in names)

    def g(*a):
        y, (c, n, m) = su.chunkwise_mlstm(*a, chunk=MLSTM_SCAN["chunk"],
                                          return_final_state=True)
        return jnp.sum(y * inp["cot"]) + jnp.sum(c) + jnp.sum(n), (y, c, n, m)

    (_, (y, c, n, m)), grads = jax.jit(jax.value_and_grad(
        g, argnums=(0, 1, 2, 3, 4), has_aux=True))(*args)
    for k, v in (("y", y), ("c", c), ("n", n), ("m", m)):
        out[f"mlstm_scan/{k}"] = np.asarray(v)
    for name, gr in zip(names, grads):
        out[f"mlstm_scan/grad_{name}"] = np.asarray(gr)

    # decode steps on random states
    rng = np.random.default_rng(13)
    f32 = np.float32
    b, c_, n_ = 2, 12, 8
    dec = {"h": rng.standard_normal((b, c_, n_)).astype(f32),
           "delta": np.abs(rng.standard_normal((b, c_))).astype(f32),
           "a_log": rng.standard_normal((c_, n_)).astype(f32),
           "b": rng.standard_normal((b, n_)).astype(f32),
           "c": rng.standard_normal((b, n_)).astype(f32),
           "x": rng.standard_normal((b, c_)).astype(f32)}
    h_new, y = su.mamba_decode_step(*(jnp.asarray(dec[k]) for k in
                                      ("h", "delta", "a_log", "b", "c", "x")))
    for k, v in dec.items():
        out[f"mamba_step/{k}"] = v
    out["mamba_step/h_new"], out["mamba_step/y"] = np.asarray(h_new), np.asarray(y)

    h_, dk, dv = 2, 8, 16
    st = {"c": rng.standard_normal((b, h_, dk, dv)).astype(f32),
          "n": rng.standard_normal((b, h_, dk)).astype(f32),
          "m": rng.standard_normal((b, h_)).astype(f32),
          "q": rng.standard_normal((b, h_, dk)).astype(f32),
          "k": rng.standard_normal((b, h_, dk)).astype(f32),
          "v": rng.standard_normal((b, h_, dv)).astype(f32),
          "log_i": rng.standard_normal((b, h_)).astype(f32),
          "log_f": -np.abs(rng.standard_normal((b, h_))).astype(f32)}
    for first in (False, True):
        tag = "mlstm_step_first" if first else "mlstm_step"
        m0 = np.full((b, h_), -1e30, f32) if first else st["m"]
        z = np.zeros_like
        state = ((z(st["c"]), z(st["n"]), m0) if first
                 else (st["c"], st["n"], st["m"]))
        (c1, n1, m1), y = su.mlstm_decode_step(
            tuple(jnp.asarray(s) for s in state),
            *(jnp.asarray(st[k]) for k in ("q", "k", "v", "log_i", "log_f")))
        for k, v in st.items():
            out[f"{tag}/{k}"] = v
        out[f"{tag}/m"] = m0
        if first:
            out[f"{tag}/c"], out[f"{tag}/n"] = z(st["c"]), z(st["n"])
        for k, v in (("c_new", c1), ("n_new", n1), ("m_new", m1), ("y", y)):
            out[f"{tag}/{k}"] = np.asarray(v)


def run_blocks(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models import mamba, xlstm
    from repro.parallel.sharding import ParamFactory

    bl = BLOCK
    rng = np.random.default_rng(14)
    x = rng.standard_normal((bl["b"], bl["s"], bl["d"])).astype(np.float32)
    x1 = rng.standard_normal((bl["b"], 1, bl["d"])).astype(np.float32)
    out["blocks/x"], out["blocks/x1"] = x, x1

    f = ParamFactory(jax.random.key(20), jnp.float32)
    mamba.init_mamba(f.scope("mamba"), bl["d"], bl["d_state"], bl["d_conv"],
                     bl["expand"], None)
    xlstm.init_mlstm(f.scope("mlstm"), bl["d"], bl["heads"], 4.0 / 3.0, 0.5)
    xlstm.init_slstm(f.scope("slstm"), bl["d"], bl["heads"])
    _flatten(_np(f.params), "blocks/params/", out)
    p = f.params

    y, cache = jax.jit(lambda pp, xx: mamba.apply_mamba(
        pp, xx, d_state=bl["d_state"], d_conv=bl["d_conv"], chunk=bl["chunk"],
        return_cache=True))(p["mamba"], jnp.asarray(x))
    y1, cache1 = jax.jit(lambda pp, cc, xx: mamba.mamba_decode_step(
        pp, cc, xx, d_state=bl["d_state"], d_conv=bl["d_conv"]))(
        p["mamba"], cache, jnp.asarray(x1))
    for k, v in (("y", y), ("y1", y1)):
        out[f"blocks/mamba/{k}"] = np.asarray(v)
    _flatten(_np(cache), "blocks/mamba/cache/", out)
    _flatten(_np(cache1), "blocks/mamba/cache1/", out)

    for kind, apply, step in (("mlstm", xlstm.apply_mlstm, xlstm.mlstm_decode_step),
                              ("slstm", xlstm.apply_slstm, xlstm.slstm_decode_step)):
        kw = {"chunk": bl["chunk"]} if kind == "mlstm" else {}
        y, cache = jax.jit(lambda pp, xx, apply=apply, kw=kw: apply(
            pp, xx, n_heads=bl["heads"], return_cache=True, **kw))(
            p[kind], jnp.asarray(x))
        y1, cache1 = jax.jit(lambda pp, cc, xx, step=step: step(
            pp, cc, xx, n_heads=bl["heads"]))(p[kind], cache, jnp.asarray(x1))
        out[f"blocks/{kind}/y"], out[f"blocks/{kind}/y1"] = np.asarray(y), np.asarray(y1)
        _flatten(_np(cache), f"blocks/{kind}/cache/", out)
        _flatten(_np(cache1), f"blocks/{kind}/cache1/", out)


def _decode_run(out, tag, step, params, first_logits, caches, index0):
    """Greedy decode ``DECODE`` steps: every step's logits and the tokens."""
    import jax.numpy as jnp
    import numpy as np
    nxt = jnp.argmax(first_logits[:, -1], -1).astype(jnp.int32)[:, None]
    toks = [np.asarray(nxt)]
    for d in range(DECODE):
        logits, caches = step(params, nxt, caches, jnp.int32(index0 + d))
        out[f"{tag}/decode{d}_logits"] = np.asarray(logits)
        nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(nxt))
    out[f"{tag}/greedy"] = np.concatenate(toks, axis=1)
    return caches


def _loss_and_grads(out, tag, cfg, params, batch):
    import jax
    import numpy as np
    from repro.models import api as model_api

    def loss_fn(p, b):
        return model_api.model_loss(p, cfg, b, remat=True)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, batch)
    out[f"{tag}/loss"] = np.asarray(loss)
    for k, v in metrics.items():
        out[f"{tag}/metrics/{k}"] = np.asarray(v)
    _flatten(_np(grads), f"{tag}/grads/", out)


def run_ssm_arch(out: dict, arch: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_reduced
    from repro.models import api as model_api
    from repro.models import transformer

    for i in (ARCHS_SSM.index(arch),):
        cfg = get_reduced(arch)
        params, _ = model_api.init_model(jax.random.key(30 + i), cfg)
        _flatten(_np(params), f"{arch}/params/", out)
        tokens = np.random.default_rng(30 + i).integers(
            0, cfg.vocab_size, (BATCH, TOKENS)).astype(np.int32)
        out[f"{arch}/tokens"] = tokens
        fwd = jax.jit(lambda p, t: transformer.forward(p, cfg, t, remat=False)[0])
        out[f"{arch}/logits"] = np.asarray(fwd(params, jnp.asarray(tokens)))
        fstep = jax.jit(lambda p, t, c, i0: transformer.forward(
            p, cfg, t, caches=c, cache_index=i0, remat=False))
        caches = transformer.init_caches(cfg, BATCH, MAX_SEQ, jnp.float32)
        logits, _, caches = fstep(params, jnp.asarray(tokens), caches, jnp.int32(0))
        out[f"{arch}/prefill_logits"] = np.asarray(logits)

        def step(p, t, c, i0):
            lg, _, c = fstep(p, t, c, i0)
            return lg, c

        caches = _decode_run(out, arch, step, params, logits, caches, TOKENS)
        _flatten(_np({str(s): c for s, c in enumerate(caches)}),
                 f"{arch}/final_caches/", out)
        _loss_and_grads(out, arch, cfg, params, {"tokens": jnp.asarray(tokens)})


def run_cross(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models import attention, embedding
    from repro.parallel.sharding import ParamFactory

    cr = CROSS
    f = ParamFactory(jax.random.key(40), jnp.float32)
    attention.init_attention(f.scope("attn"), cr["d"], cr["heads"], cr["kv"], cr["dh"])
    p = f.params["attn"]
    _flatten(_np(p), "cross/params/", out)
    rng = np.random.default_rng(40)
    x = rng.standard_normal((cr["b"], cr["s"], cr["d"])).astype(np.float32)
    enc = rng.standard_normal((cr["b"], cr["t"], cr["d"])).astype(np.float32)
    out["cross/x"], out["cross/enc"] = x, enc
    pos = jnp.broadcast_to(jnp.arange(cr["s"])[None] + 3, (cr["b"], cr["s"]))
    kw = dict(n_heads=cr["heads"], n_kv=cr["kv"], head_dim=cr["dh"],
              positions=pos, causal=False, rope_theta=10000.0)
    y, _ = attention.apply_attention(p, jnp.asarray(x), x_kv=jnp.asarray(enc), **kw)
    out["cross/y"] = np.asarray(y)
    kpos = jnp.asarray(rng.integers(0, 20, (cr["b"], cr["t"])).astype(np.int32))
    out["cross/kv_positions"] = np.asarray(kpos)
    y, _ = attention.apply_attention(p, jnp.asarray(x), x_kv=jnp.asarray(enc),
                                     kv_positions=kpos, **dict(kw, causal=True))
    out["cross/y_kvpos"] = np.asarray(y)
    k = jnp.einsum("btd,dnh->btnh", enc, p["wk"])
    v = jnp.einsum("btd,dnh->btnh", enc, p["wv"])
    out["cross/ck"], out["cross/cv"] = np.asarray(k), np.asarray(v)
    y, _ = attention.apply_attention(p, jnp.asarray(x), kv_cache={"k": k, "v": v},
                                     cache_index=None, **kw)
    out["cross/y_static"] = np.asarray(y)
    # bf16 queries and weights against float32 encoder states
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    y, _ = attention.apply_attention(pb, jnp.asarray(x).astype(jnp.bfloat16),
                                     x_kv=jnp.asarray(enc), **kw)
    out["cross/y_bf16"] = np.asarray(y.astype(jnp.float32))
    out["cross/y_bf16_dtype_is_bf16"] = np.asarray(y.dtype == jnp.bfloat16)
    out["sinusoidal"] = np.asarray(embedding.sinusoidal_positions(37, 24))


def whisper_inputs(cfg):
    import numpy as np
    rng = np.random.default_rng(50)
    frames = (rng.standard_normal((BATCH, FRAMES, cfg.d_model)) * 0.02).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    return frames, tokens


def run_whisper(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_reduced
    from repro.launch.mesh import make_mesh
    from repro.models import api as model_api
    from repro.models import whisper
    from repro.serve import ServeEngine

    arch = "whisper-base"
    cfg = get_reduced(arch)
    params, _ = model_api.init_model(jax.random.key(50), cfg)
    _flatten(_np(params), f"{arch}/params/", out)
    frames, tokens = whisper_inputs(cfg)
    out[f"{arch}/frames"], out[f"{arch}/tokens"] = frames, tokens
    enc = jax.jit(lambda p, fr: whisper.encode(p, cfg, fr, remat=False))(
        params, jnp.asarray(frames))
    out[f"{arch}/enc"] = np.asarray(enc)
    logits, _ = jax.jit(lambda p, t, e: whisper.decode(p, cfg, t, e, remat=False))(
        params, jnp.asarray(tokens), enc)
    out[f"{arch}/logits"] = np.asarray(logits)
    self_len = min(cfg.max_seq, 448)

    def prefill(p, fr, t, c_dtype=jnp.float32):
        e = whisper.encode(p, cfg, fr, remat=False)
        c = whisper.init_dec_caches(cfg, BATCH, self_len, fr.shape[1], c_dtype)
        c = whisper.prime_cross_caches(p, cfg, e, c)
        lg, c = whisper.decode(p, cfg, t, None, caches=c,
                               cache_index=jnp.int32(0), remat=False)
        return lg, c

    dstep = jax.jit(lambda p, t, c, i0: whisper.decode(
        p, cfg, t, None, caches=c, cache_index=i0, remat=False))
    lg, caches = jax.jit(prefill)(params, jnp.asarray(frames), jnp.asarray(tokens))
    out[f"{arch}/prefill_logits"] = np.asarray(lg)
    _decode_run(out, arch, dstep, params, lg, caches, PROMPT)

    # The JAX engine: cross caches grown to max_seq with zero rows (its
    # launcher's max_seq: frames + tokens + 8).
    mesh = make_mesh((1, 1), ("data", "model"))
    eng = ServeEngine(cfg, mesh, batch=BATCH, prompt_len=FRAMES,
                      max_seq=ENGINE_MAX_SEQ, params=params)
    grown = eng._grow_caches(caches)
    out[f"{arch}/engine_cross_len"] = np.asarray(grown["ck"].shape[2])
    nxt = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    lg_pad, _ = dstep(params, nxt, grown, jnp.int32(PROMPT))
    out[f"{arch}/engine_decode0_logits"] = np.asarray(lg_pad)
    toks, _ = eng.generate(tokens, DECODE + 1, frames=frames)
    out[f"{arch}/engine_greedy"] = np.asarray(toks)

    _loss_and_grads(out, arch, cfg, params,
                    {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)})

    # bf16 weights and caches, float32 frames (the engine's promotion)
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    lg16, c16 = jax.jit(lambda p, fr, t: prefill(p, fr, t, jnp.bfloat16))(
        p16, jnp.asarray(frames), jnp.asarray(tokens))
    out[f"{arch}/bf16_prefill_logits"] = np.asarray(lg16.astype(jnp.float32))
    out[f"{arch}/bf16_ck"] = np.asarray(c16["ck"].astype(jnp.float32))


def run_vlm(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_reduced
    from repro.launch.mesh import make_mesh
    from repro.models import api as model_api
    from repro.models import transformer, vlm
    from repro.serve import ServeEngine

    arch = "internvl2-26b"
    cfg = get_reduced(arch)
    params, _ = model_api.init_model(jax.random.key(60), cfg)
    _flatten(_np(params), f"{arch}/params/", out)
    rng = np.random.default_rng(60)
    patches = (rng.standard_normal((BATCH, cfg.frontend_len, cfg.frontend_dim))
               * 0.02).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, TOKENS)).astype(np.int32)
    out[f"{arch}/patches"], out[f"{arch}/tokens"] = patches, tokens
    img = vlm.project_patches(params["projector"], jnp.asarray(patches))
    out[f"{arch}/img"] = np.asarray(img)
    logits = jax.jit(lambda p, t, e: transformer.forward(
        p, cfg, t, extra_embeds=e, remat=False)[0])(params, jnp.asarray(tokens), img)
    out[f"{arch}/logits"] = np.asarray(logits)
    n_all = cfg.frontend_len + TOKENS
    fstep = jax.jit(lambda p, t, c, i0, e: transformer.forward(
        p, cfg, t, caches=c, cache_index=i0, extra_embeds=e, remat=False))
    caches = transformer.init_caches(cfg, BATCH, n_all + DECODE + 1, jnp.float32)
    lg, _, caches = fstep(params, jnp.asarray(tokens), caches, jnp.int32(0), img)
    out[f"{arch}/prefill_logits"] = np.asarray(lg)

    def step(p, t, c, i0):
        lg_, _, c = fstep(p, t, c, i0, None)
        return lg_, c

    _decode_run(out, arch, step, params, lg, caches, n_all)
    _loss_and_grads(out, arch, cfg, params,
                    {"patches": jnp.asarray(patches), "tokens": jnp.asarray(tokens)})

    eng = ServeEngine(cfg, make_mesh((1, 1), ("data", "model")), batch=BATCH,
                      prompt_len=n_all, max_seq=n_all + DECODE + 1,
                      params=params)
    try:
        eng.generate(tokens, DECODE + 1)
        out[f"{arch}/engine_error"] = np.asarray("")
    except Exception as e:          # the reference's engine gap, recorded
        out[f"{arch}/engine_error"] = np.asarray(f"{type(e).__name__}: {e}")


def run_ssm(out: dict) -> None:
    run_scans(out)
    run_blocks(out)
    run_ssm_arch(out, "xlstm-125m")


def run_jamba(out: dict) -> None:
    run_ssm_arch(out, "jamba-v0.1-52b")


def run_encdec(out: dict) -> None:
    run_cross(out)
    run_whisper(out)
    run_vlm(out)


def main(argv) -> None:
    mode, path = argv[1], argv[2]
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    out: dict = {}
    {"ssm": run_ssm, "jamba": run_jamba, "encdec": run_encdec}[mode](out)
    import numpy as np
    np.savez(path, **out)
    print(json.dumps({"written": path, "arrays": len(out)}))


if __name__ == "__main__":
    main(sys.argv)
