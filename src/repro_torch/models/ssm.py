"""The Mamba-2 (SSD, state-space duality) layer: the chunked training scan and
the one-token recurrent step (the port of ``repro.models.ssm``).

Faithful to "Transformers are SSMs" (arXiv:2405.21060) with ngroups=1:
in_proj → [z | x | B | C | dt], a causal depthwise conv on (x, B, C), the
scalar-A SSD in chunks (a quadratic term inside each chunk, a recurrence
over the chunks' states), a gated RMSNorm and out_proj. The dtype flow is
the reference's: the projections and the conv in the parameters' dtype, the
SSD in float32, its output cast back.

Two changes of form, not of value. The reference's three-operand einsums
are contracted pairwise, so no tensor ever holds a (Q × Q) pair of axes
together with the head dimension P (or N with P): ``dt·x`` is formed first
and each contraction is one batched matmul. The reference masks the
intra-chunk decay after ``exp`` (``where(mask, exp(li), 0)``, where ``li``
is positive above the diagonal); here the mask comes first, ``exp(where(mask,
li, −inf))``: the same values, and a backward pass free of ``inf · 0``.

The inter-chunk recurrence (the reference's ``lax.scan``) is its closed
form: the state before chunk c is Σ_{c' < c} exp(Σ_{c' < k < c} t_k)·s_{c'},
one (nc × nc) decay matrix a batch row and head times the chunks' states.
The segment sums are summed directly (a masked cumulative sum), never taken
as differences of cumulative sums, which would lose the exponent's low
bits deep into a long sequence.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import rms_norm, truncated_normal_init


def init_mamba2_params(gen: torch.Generator, cfg, dtype, device, lead: tuple = ()) -> dict:
    """One layer's parameters (the reference's tree), drawn from ``gen``;
    ``lead`` stacks them, e.g. ``(n_layers,)``."""
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = din + 2 * n
    d_proj = 2 * din + 2 * n + h
    conv_w = torch.empty((*lead, cfg.conv_width, conv_ch), dtype=torch.float32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": truncated_normal_init(gen, (*lead, d, d_proj), 1.0, dtype, device),
        "conv_w": (conv_w.normal_(0.0, 1.0, generator=gen) * 0.1).to(dtype),
        "conv_b": torch.zeros((*lead, conv_ch), **f32),
        "a_log": torch.log(torch.arange(1, h + 1, **f32)).expand(*lead, h).clone(),
        "dt_bias": torch.full((*lead, h), float(np.log(np.expm1(0.01))), **f32),  # softplus⁻¹(0.01)
        "d_skip": torch.ones((*lead, h), **f32),
        "norm": torch.zeros((*lead, din), **f32),
        "out_proj": truncated_normal_init(gen, (*lead, din, d), 1.0, dtype, device),
    }


def _split_proj(proj: torch.Tensor, cfg):
    din, n = cfg.d_inner, cfg.ssm_state
    return proj[..., :din], proj[..., din:2 * din + 2 * n], proj[..., 2 * din + 2 * n:]


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq, then SiLU. xbc (B, S, C); w (W, C).
    The W taps are added in the reference's order (``sum`` from tap 0)."""
    wdt, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, wdt - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(wdt))
    return F.silu(out + b.to(out.dtype))


def _segment_decay(t: torch.Tensor) -> torch.Tensor:
    """t (..., nc) → L (..., nc, nc) with L[c, c'] = exp(Σ_{k=c'+1}^{c} t_k)
    for c' ≤ c (1 on the diagonal) and 0 above it; the sums are accumulated
    over the segment itself."""
    nc = t.shape[-1]
    strict = torch.ones((nc, nc), dtype=torch.bool, device=t.device).tril(-1)
    seg = torch.cumsum(t[..., :, None].expand(*t.shape, nc).masked_fill(~strict, 0.0), dim=-2)
    lower = torch.ones((nc, nc), dtype=torch.bool, device=t.device).tril()
    return torch.exp(seg.masked_fill(~lower, -math.inf))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, chunk: int):
    """The SSD scan. x (B,S,H,P), dt (B,S,H), a (H,) < 0, b/c (B,S,N).
    Returns (y (B,S,H,P) in x's dtype, the final state (B,H,N,P) in float32)."""
    B, S, H, P = x.shape
    N = b_mat.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"the sequence length {S} is not a multiple of the SSD chunk {Q}")
    nc = S // Q
    f32 = torch.float32

    xr = x.reshape(B, nc, Q, H, P).to(f32)
    dtr = dt.reshape(B, nc, Q, H).to(f32)
    br = b_mat.reshape(B, nc, Q, N).to(f32)
    cr = c_mat.reshape(B, nc, Q, N).to(f32)

    da = dtr * a[None, None, None, :]                        # (B,nc,Q,H) ≤ 0
    cum = torch.cumsum(da, dim=2)                            # inclusive
    seg_total = cum[:, :, -1, :]                             # (B,nc,H)

    # --- intra-chunk: (Q × Q) masked matmuls a chunk and head ----------------
    scores = torch.einsum("bcin,bcjn->bcij", cr, br)         # (B,nc,Q,Q)
    cum_h = cum.transpose(2, 3)                              # (B,nc,H,Q)
    li = cum_h[..., :, None] - cum_h[..., None, :]           # cum_i − cum_j (B,nc,H,Q,Q)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    w_ij = scores[:, :, None] * torch.exp(li.masked_fill(~mask, -math.inf))
    dtx = dtr[..., None] * xr                                # (B,nc,Q,H,P)
    y_intra = torch.matmul(w_ij, dtx.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # --- chunk states: Σ_j B_j ⊗ (dt·decay-to-end·x)_j ------------------------
    dec_end = torch.exp(seg_total[:, :, None, :] - cum)     # (B,nc,Q,H)
    v = (dtr * dec_end)[..., None] * xr                      # (B,nc,Q,H,P)
    s_c = torch.matmul(br.transpose(2, 3), v.reshape(B, nc, Q, H * P))   # (B,nc,N,H·P)

    # --- inter-chunk recurrence, closed form ----------------------------------
    # Y[c] = Σ_{c' ≤ c} exp(Σ_{k=c'+1}^{c} t_k)·s_{c'} is the state after chunk
    # c: the state before chunk c is Y[c − 1] (zeros before chunk 0)
    decay = _segment_decay(seg_total.transpose(1, 2))        # (B,H,nc,nc)
    s_h = s_c.reshape(B, nc, N, H, P).permute(0, 3, 1, 2, 4).reshape(B, H, nc, N * P)
    after = torch.matmul(decay, s_h).reshape(B, H, nc, N, P)
    final = after[:, :, -1]                                  # (B,H,N,P)
    before = F.pad(after[:, :, :-1], (0, 0, 0, 0, 1, 0))    # (B,H,nc,N,P)

    y_inter = torch.einsum("bcin,bhcnp->bcihp", cr, before) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y.to(x.dtype), final


def mamba2_forward(params: dict, u: torch.Tensor, cfg, return_state: bool = False):
    """The layer: u (B, S, d_model) → (B, S, d_model) [, its recurrent state
    ``{"ssm": (B,H,N,P) float32, "conv": (B, W−1, C)}``]."""
    B, S, _ = u.shape
    din, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = u @ params["in_proj"]
    z, xbc_raw, dt = _split_proj(proj, cfg)
    xbc = causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs = xbc[..., :din].reshape(B, S, h, pdim)
    b_mat = xbc[..., din:din + n]
    c_mat = xbc[..., din + n:]
    dt = F.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y, final = ssd_chunked(xs, dt, a, b_mat, c_mat, cfg.ssm_chunk)
    y = y + params["d_skip"][None, None, :, None].to(y.dtype) * xs
    y = y.reshape(B, S, din)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.rms_eps)
    out = y @ params["out_proj"]
    if return_state:
        wdt = cfg.conv_width
        conv_state = F.pad(xbc_raw, (0, 0, max(0, wdt - 1 - S), 0))[:, -(wdt - 1):, :]
        return out, {"ssm": final, "conv": conv_state}
    return out


# ------------------------------------------------------------------ decode ---

def init_mamba2_state(cfg, batch: int, dtype, device, lead: tuple = ()) -> dict:
    """A zero recurrent state; ``lead`` stacks it, e.g. ``(n_layers,)``."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "ssm": torch.zeros((*lead, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, cfg.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def mamba2_decode_step(params: dict, u: torch.Tensor, state: dict, cfg):
    """One-token recurrent step. u (B, 1, d) → (y (B, 1, d), new state). The
    new conv window takes the promoted dtype of the state and the step's
    projection, as the reference's concatenation does."""
    B = u.shape[0]
    din, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = u[:, 0] @ params["in_proj"]                       # (B, d_proj)
    z, xbc, dt = _split_proj(proj, cfg)
    dtype = torch.promote_types(state["conv"].dtype, xbc.dtype)
    win = torch.cat([state["conv"].to(dtype), xbc[:, None, :].to(dtype)], dim=1)  # (B, W, C)
    conv_out = torch.sum(win * params["conv_w"][None].to(dtype), dim=1) \
        + params["conv_b"].to(dtype)
    conv_out = F.silu(conv_out)
    xs = conv_out[..., :din].reshape(B, h, pdim).float()
    b_mat = conv_out[..., din:din + n].float()
    c_mat = conv_out[..., din + n:].float()
    dtv = F.softplus(dt.float() + params["dt_bias"])        # (B, H)
    a = -torch.exp(params["a_log"])
    da = torch.exp(dtv * a[None, :])                         # (B, H)
    new_ssm = state["ssm"] * da[:, :, None, None] \
        + b_mat[:, None, :, None] * (dtv[..., None] * xs)[:, :, None, :]
    y = torch.einsum("bn,bhnp->bhp", c_mat, new_ssm)         # (B,H,P)
    y = y + params["d_skip"][None, :, None] * xs
    y = y.reshape(B, din).to(u.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.rms_eps)
    out = (y @ params["out_proj"])[:, None, :]
    return out, {"ssm": new_ssm, "conv": win[:, 1:]}
