"""Batched serving engine: prefill -> decode with KV caches and recurrent
state (port of ``repro.serve.engine``, decoder-only and encoder-decoder
families).

The engine runs on its mesh's device: ``VirtualMesh`` defaults to the CUDA
device and raises without one, so the CPU must be asked for
(``make_mesh(..., device="cpu")``).  Its prefill and decode bundles each
build a plan-backed MoE dispatch plan at construction (INIT); every step
replays its embedded exchange.  The decode caches are written in place,
one row per step, the PyTorch counterpart of the JAX engine's donated
cache buffers.  With ``obs.spans.TRACER`` on, ``generate`` emits the JAX
engine's ``prefill`` and ``decode`` execute spans; ``metrics_text()`` is the
Prometheus snapshot.  ``plan_store=`` sets the process's default plan store
(``repro_torch.planstore``), so the bundles' MoE dispatch plans warm-start
from earlier serving processes.

The audio family (Whisper) takes ``generate(..., frames=)``: the prefill
encodes them and primes the cross caches at the frames' length, and decode
attends over exactly those keys.  (The JAX engine pads its cross caches
with zero rows out to ``max_seq``, which decode then attends over unmasked;
ROADMAP.md queue 3.)  Like the JAX engine, this one serves the vlm family
through its bundles only: ``generate`` passes no patches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..launch import steps as steps_mod
from ..models import api as model_api
from ..obs.spans import TRACER


@dataclasses.dataclass
class ServeStats:
    prefill_seconds: float
    decode_seconds_per_token: float
    tokens_generated: int


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Prefill + greedy decode for decoder-only and enc-dec families."""

    def __init__(self, cfg: ModelConfig, mesh, batch: int, prompt_len: int,
                 max_seq: int, params=None, seed: int = 0, plan_store=None):
        """``params``: a parameter tree (e.g. from ``params_from_jax``),
        moved to the mesh's device; None draws one from a generator seeded
        with ``seed`` on that device.

        ``plan_store`` (a directory path, a store URL — ``fsremote://…`` /
        ``tiered:local=…,remote=…``, see ``planstore.parse_store_url`` — or
        a ``repro_torch.planstore.PlanStore``) becomes the PROCESS-default
        plan store (a deliberate global side effect — it outlives this
        engine and is seen by every later ``exchange_init`` that passes
        ``store=None``; pass ``store=`` explicitly at call sites that must
        not share it).  With it set, the prefill and decode bundles' MoE
        dispatch plans load their tables and auto decisions from artifacts
        of earlier serving processes, on this mesh's device kind."""
        if prompt_len > max_seq:
            raise ValueError(
                f"prompt_len {prompt_len} exceeds max_seq {max_seq}: the "
                f"decode caches are sized max_seq, so the prefill prefix "
                f"would not fit")
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device
        self.batch = batch
        self.prompt_len = prompt_len
        self.max_seq = max_seq
        if plan_store is not None:
            from .. import planstore
            self.plan_store = planstore.configure(plan_store)
        else:
            self.plan_store = None
        shape_p = ShapeConfig("serve_prefill", "prefill", prompt_len, batch)
        shape_d = ShapeConfig("serve_decode", "decode", max_seq, batch)
        self.prefill_bundle = steps_mod.make_prefill_bundle(cfg, shape_p, mesh)
        self.decode_bundle = steps_mod.make_decode_bundle(cfg, shape_d, mesh)
        self.moe_plan = self.decode_bundle.moe_plan
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params, _ = model_api.init_model(cfg, gen, self.device)
        self.params = _to_device(params, self.device)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, n_tokens: int,
                 frames: Optional[np.ndarray] = None):
        """prompts: [B, prompt_len] int; frames (audio): [B, T, d_model],
        kept in their dtype.  Returns (tokens [B, n] int32, stats)."""
        prompt_len = int(prompts.shape[1])
        if prompt_len + n_tokens > self.max_seq:
            raise ValueError(
                f"prompt_len {prompt_len} + n_tokens {n_tokens} exceeds "
                f"max_seq {self.max_seq}: decode would write past the KV "
                f"caches — raise max_seq or generate fewer tokens")
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                                 device=self.device)
        _sync(self.device)
        t0 = time.perf_counter()
        if self.cfg.family == "audio":
            frames_t = torch.as_tensor(np.asarray(frames), device=self.device)
            logits, caches = self.prefill_bundle(self.params, frames_t, tokens)
        else:
            logits, caches = self.prefill_bundle(self.params, tokens)
        _sync(self.device)
        t_prefill = time.perf_counter() - t0
        if TRACER.enabled:
            TRACER.emit_span("prefill", "execute", t0, t0 + t_prefill,
                             {"batch": self.batch, "prompt_len": prompt_len})

        # Prefill caches are sized for the prompt; decode caches max_seq.
        caches = grow_caches(caches, self.max_seq)
        next_tok = torch.argmax(logits.float(), -1).to(torch.int32)[:, None]
        out = [next_tok.cpu().numpy()]
        t0 = time.perf_counter()
        for i in range(n_tokens - 1):
            next_tok, caches = self.decode_bundle(self.params, caches,
                                                  next_tok, prompt_len + i)
            out.append(next_tok.cpu().numpy())
        _sync(self.device)
        t1 = time.perf_counter()
        t_decode = (t1 - t0) / max(n_tokens - 1, 1)
        if TRACER.enabled:
            TRACER.emit_span("decode", "execute", t0, t1,
                             {"batch": self.batch, "tokens": n_tokens,
                              "seconds_per_token": t_decode})
        toks = np.concatenate(out, axis=1)
        return toks, ServeStats(t_prefill, t_decode, toks.size)

    def metrics_text(self) -> str:
        """Prometheus text snapshot of the process-global observability
        state as seen from this engine: INIT counters, epoch latency
        summaries and break-even residuals.  The ``--metrics-port``
        endpoint serves the same text."""
        from ..obs.metrics import render_metrics
        return render_metrics()



def grow_caches(prefill_caches, max_seq: int):
    """Prefill-sized caches as decode-sized ones: each attention ``k``/``v``
    copied into zeros of ``max_seq`` positions (axis 2); recurrent state
    (Mamba, mLSTM, sLSTM) and Whisper's caches carried whole (the
    self-attention ones already have the decoder's length, the cross ones
    keep the encoder's)."""
    if isinstance(prefill_caches, dict):          # whisper
        return prefill_caches
    grown = []
    for slot in prefill_caches:
        new = dict(slot)
        for name in ("k", "v"):
            if name not in slot:
                continue
            src = slot[name]
            shape = list(src.shape)
            if shape[2] > max_seq:
                raise ValueError(f"prefill cache shape {tuple(src.shape)} "
                                 f"exceeds max_seq {max_seq}")
            shape[2] = max_seq
            dst = src.new_zeros(shape)
            dst[:, :, :src.shape[2]] = src
            new[name] = dst
        grown.append(new)
    return grown
