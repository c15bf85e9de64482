"""Chunked linear-recurrence engines for the state-space and hybrid
architectures (port of ``repro.models.scan_utils``).

Mamba's selective SSM and xLSTM's mLSTM are both diagonal-decay linear
recurrences.  Both run chunked, as in the JAX package: a Python loop over
the ``S / Q`` chunks carries only the boundary state, with parallel work
inside each chunk.  Under autograd each chunk runs under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``), so its
``[B, Q, C, N]`` intermediates are recomputed in the backward.

Inside a Mamba chunk the JAX package combines with
``jax.lax.associative_scan``.  PyTorch has none; here the same combine runs
as a log-step (Hillis-Steele) doubling over the chunk's Q steps:
``ceil(log2 Q)`` passes, each combining every step with the one ``2^k``
before it.  The sums associate in another order than XLA's tree, so the
two agree to float32 rounding, not bit for bit.  No cumulative-product
form (``a_cum * cumsum(bx / a_cum)``) is used: strong decays underflow
``a_cum`` to 0.

The mLSTM stabiliser reduces with ``amax``, which splits the gradient among
tied maxima as JAX's ``max`` does; the ``-inf`` causal mask gives zero, not
NaN, gradients (``torch.where`` routes nothing to the masked entries).
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint as torch_checkpoint


def _chunks(t: torch.Tensor, nc: int, q: int):
    """``[B, S, ...]`` as ``nc`` views ``[B, q, ...]``."""
    return [t[:, i * q:(i + 1) * q] for i in range(nc)]


def _run(body, *args):
    if torch.is_grad_enabled():
        return torch_checkpoint.checkpoint(body, *args, use_reentrant=False)
    return body(*args)


def _doubling_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the combine ``(a1, b1), (a2, b2) ->
    (a1 a2, a2 b1 + b2)`` (earlier element first): ``(a_cum, h)`` with
    ``h[t] = a[t] h[t-1] + b[t]`` from ``h[-1] = 0``."""
    q = a.shape[1]
    off = 1
    while off < q:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        a = torch.cat([a[:, :off], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :off], a_cur * b_prev + b_cur], dim=1)
        off *= 2
    return a, b


def chunked_mamba_scan(
    delta: torch.Tensor,   # [B, S, C]  softplus'd step sizes
    a_log: torch.Tensor,   # [C, N]     log(-A) parameterization (A = -exp(a_log))
    b_mat: torch.Tensor,   # [B, S, N]
    c_mat: torch.Tensor,   # [B, S, N]
    x: torch.Tensor,       # [B, S, C]
    chunk: int = 64,
    return_final_state: bool = False,
):
    """Selective scan ``y[b,s,c] = sum_n C[b,s,n] h[b,s,c,n]``, chunked:
    ``h[t] = exp(delta[t] A) h[t-1] + delta[t] B[t] x[t]``."""
    bsz, s, c = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, s)
    assert s % q == 0, (s, q)
    nc = s // q
    neg_a = -torch.exp(a_log.float())                      # [C, N], < 0

    def body(h, d_c, b_c, c_c, x_c):
        d32 = d_c.float()
        a = torch.exp(d32[..., None] * neg_a)              # [B,q,C,N]
        bx = (d32 * x_c.float())[..., None] * b_c.float()[:, :, None, :]
        a_cum, h_intra = _doubling_scan(a, bx)
        h_all = h_intra + a_cum * h[:, None]               # [B,q,C,N]
        y_c = torch.einsum("bqcn,bqn->bqc", h_all, c_c.float())
        return h_all[:, -1], y_c.to(x.dtype)

    h = torch.zeros((bsz, c, n), dtype=torch.float32, device=x.device)
    ys = []
    for d_c, b_c, c_c, x_c in zip(*(_chunks(t, nc, q)
                                    for t in (delta, b_mat, c_mat, x))):
        h, y_c = _run(body, h, d_c, b_c, c_c, x_c)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)
    return (y, h) if return_final_state else y


def mamba_decode_step(
    h: torch.Tensor,       # [B, C, N] carried SSM state
    delta: torch.Tensor,   # [B, C]
    a_log: torch.Tensor,   # [C, N]
    b_vec: torch.Tensor,   # [B, N]
    c_vec: torch.Tensor,   # [B, N]
    x: torch.Tensor,       # [B, C]
) -> tuple[torch.Tensor, torch.Tensor]:
    neg_a = -torch.exp(a_log.float())
    d32 = delta.float()
    a = torch.exp(d32[..., None] * neg_a)                  # [B,C,N]
    bx = (d32 * x.float())[..., None] * b_vec.float()[:, None, :]
    h_new = a * h + bx
    y = torch.einsum("bcn,bn->bc", h_new, c_vec.float())
    return h_new, y.to(x.dtype)


def chunkwise_mlstm(
    q: torch.Tensor,       # [B, S, H, dk]
    k: torch.Tensor,       # [B, S, H, dk]
    v: torch.Tensor,       # [B, S, H, dv]
    log_i: torch.Tensor,   # [B, S, H] input-gate pre-activation (exp gating)
    log_f: torch.Tensor,   # [B, S, H] log forget gate (<= 0, e.g. logsigmoid)
    chunk: int = 128,
    return_final_state: bool = False,
):
    """Stabilized chunkwise mLSTM (xLSTM matrix memory).

        C_t = f_t C_{t-1} + i_t k_t v_t^T      n_t = f_t n_{t-1} + i_t k_t
        h_t = (q_t^T C_t) / max(|q_t^T n_t|, exp(-m_t))

    Carries (C~, n~, m) with C = C~ exp(m) so all exponents stay <= 0.
    Intra-chunk terms form a QxQ decayed score matrix per head.
    """
    bsz, s, h, dk = q.shape
    dv = v.shape[-1]
    qq = min(chunk, s)
    assert s % qq == 0
    nc = s // qq
    scale = dk ** -0.5
    t_idx = torch.arange(qq, device=q.device)
    causal = (t_idx[:, None] >= t_idx[None, :])[None, :, :, None]

    def body(c_state, n_state, m, qc, kc, vc, li, lf):
        lf32, li32 = lf.float(), li.float()
        fcum = torch.cumsum(lf32, dim=1)                        # [B,q,H]
        # intra logits L[t,j] = F_t - F_j + log_i_j  (j <= t)
        l_mat = fcum[:, :, None, :] - fcum[:, None, :, :] + li32[:, None, :, :]
        l_mat = torch.where(causal, l_mat, -torch.inf)
        # per-step stabilizer: d_t = max(m + F_t, max_j L[t,j])
        carry_scale = m[:, None, :] + fcum                      # [B,q,H]
        d = torch.maximum(carry_scale, l_mat.amax(dim=2))       # [B,q,H]
        s_mat = torch.einsum("bqhd,bjhd->bqjh", qc.float(), kc.float()) * scale
        w = s_mat * torch.exp(l_mat - d[:, :, None, :])
        w = torch.where(causal, w, 0.0)
        num = torch.einsum("bqjh,bjhe->bqhe", w, vc.float())
        den = w.sum(dim=2)                                      # [B,q,H]
        # inter-chunk contribution
        qc32 = qc.float() * scale
        carry_w = torch.exp(carry_scale - d)                    # [B,q,H]
        num = num + carry_w[..., None] * torch.einsum("bqhd,bhde->bqhe",
                                                      qc32, c_state)
        den = den + carry_w * torch.einsum("bqhd,bhd->bqh", qc32, n_state)
        y = num / torch.maximum(den.abs(), torch.exp(-d))[..., None]
        # update carried state (scale m_new)
        f_tot = fcum[:, -1, :]                                  # [B,H]
        state_logits = f_tot[:, None, :] - fcum + li32          # [B,q,H]
        m_new = torch.maximum(m + f_tot, state_logits.amax(dim=1))
        decay_old = torch.exp(m + f_tot - m_new)
        wk = torch.exp(state_logits - m_new[:, None, :])        # [B,q,H]
        k32, v32 = kc.float(), vc.float()
        c_new = decay_old[:, :, None, None] * c_state + torch.einsum(
            "bjh,bjhd,bjhe->bhde", wk, k32, v32)
        n_new = decay_old[:, :, None] * n_state + torch.einsum(
            "bjh,bjhd->bhd", wk, k32)
        return c_new, n_new, m_new, y.to(q.dtype)

    c_state = torch.zeros((bsz, h, dk, dv), dtype=torch.float32, device=q.device)
    n_state = torch.zeros((bsz, h, dk), dtype=torch.float32, device=q.device)
    m = torch.full((bsz, h), -1e30, dtype=torch.float32, device=q.device)
    ys = []
    for inputs in zip(*(_chunks(t, nc, qq) for t in (q, k, v, log_i, log_f))):
        c_state, n_state, m, y = _run(body, c_state, n_state, m, *inputs)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return (y, (c_state, n_state, m)) if return_final_state else y


def mlstm_decode_step(
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor],   # (C~, n~, m)
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,        # [B, H, dk/dv]
    log_i: torch.Tensor, log_f: torch.Tensor,                 # [B, H]
) -> tuple[tuple, torch.Tensor]:
    c_state, n_state, m = state
    scale = q.shape[-1] ** -0.5
    lf, li = log_f.float(), log_i.float()
    m_new = torch.maximum(lf + m, li)
    f_w = torch.exp(lf + m - m_new)
    i_w = torch.exp(li - m_new)
    k32, v32 = k.float(), v.float()
    c_new = f_w[..., None, None] * c_state + i_w[..., None, None] * (
        k32[..., :, None] * v32[..., None, :])
    n_new = f_w[..., None] * n_state + i_w[..., None] * k32
    q32 = q.float() * scale
    num = torch.einsum("bhd,bhde->bhe", q32, c_new)
    den = torch.einsum("bhd,bhd->bh", q32, n_new)
    y = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return (c_new, n_new, m_new), y.to(q.dtype)
