"""Recurrent token mixers: Mamba2 (SSD) and RWKV6 (Finch), the port of
``repro/models/ssm.py``.

Prefill uses the CHUNKED parallel form: time is split into chunks; within
a chunk the recurrence is evaluated as dense products against a
lower-triangular decay matrix, and a loop over chunks carries the state.
Every exponent is a difference of cumulative log-decays with the later
index first, hence <= 0, so no intermediate can overflow; entries above
the diagonal are exp(-inf) = 0 exactly. Decode (t == 1) uses the O(1)
single-step update.

The functions are pure, as in the reference: each takes the layer's state
(or None) and returns the new one; ``models.model.forward`` writes it into
the cache in place.

State layouts (per layer):
  mamba2: {"conv": [B, conv_dim, K-1], "ssd": [B, H, hd, N]}
  rwkv6:  {"wkv": [B, H, dk, dv], "shift_tm": [B, D], "shift_cm": [B, D]}
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.dtensor import (
    is_dtensor, merge_heads, on_local_blocks, whole_heads,
)
from repro_torch.models.layers import apply_linear, rms_norm

F32 = torch.float32


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it (logaddexp)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Mamba2 (SSD with scalar-per-head decay)
# ---------------------------------------------------------------------------

def mamba2_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, prev):
    """Depthwise causal conv. x [B,T,C], w [C,K], prev [B,C,K-1] or None.

    Returns (y [B,T,C], new_prev [B,C,K-1]); y sums the K taps in f32,
    tap by tap.
    """
    b, t, c = x.shape
    k = w.shape[-1]
    xt = x.movedim(1, 2)  # [B, C, T]
    if prev is None:
        prev = torch.zeros((b, c, k - 1), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev.to(x.dtype), xt], dim=-1)  # [B, C, T+K-1]
    y = torch.zeros((b, c, t), dtype=F32, device=x.device)
    for i in range(k):
        wi = w[:, i][None, :, None].to(F32)
        y = y + xp[:, :, i:i + t].to(F32) * wi
    new_prev = xp[:, :, t:]
    return y.to(x.dtype).movedim(1, 2), new_prev


def ssd_chunked(xdt, bmat, cmat, loga, s0, chunk: int = 128):
    """Chunked SSD scan (scalar-per-head decay).

    xdt [B,T,H,P] (dt-premultiplied inputs), bmat/cmat [B,T,N],
    loga [B,T,H] (log decay, <= 0), s0 [B,H,P,N] f32.
    Returns (ys [B,T,H,P], s_final).
    """
    b, t, h, pd = xdt.shape
    c = min(chunk, t)
    if t % c:
        raise ValueError(f"length {t} is not a multiple of chunk {c}")
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                device=xdt.device))
    s = s0
    ys = []
    for c0 in range(0, t, c):
        xc, bc, cc, lc = (a[:, c0:c0 + c] for a in (xdt, bmat, cmat, loga))
        big_l = torch.cumsum(lc, dim=1)                  # [B,C,H] inclusive
        cb = torch.einsum("btn,bun->btu", cc, bc)        # [B,C,C]
        # [B,t,u,H] <= 0 for u <= t
        diff = big_l[:, :, None, :] - big_l[:, None, :, :]
        dec = torch.exp(torch.where(tri[None, :, :, None], diff,
                                    -torch.inf))
        scores = cb[:, :, :, None] * dec                 # [B,t,u,H]
        y_intra = torch.einsum("btuh,buhp->bthp", scores, xc)
        y_inter = torch.einsum("btn,bhpn->bthp", cc, s)
        y_inter = y_inter * torch.exp(big_l)[..., None]
        l_tot = big_l[:, -1]                             # [B,H]
        k_hat = torch.exp(l_tot[:, None] - big_l)        # [B,C,H] <=0 exps
        s = s * torch.exp(l_tot)[:, :, None, None] + torch.einsum(
            "buhp,bun,buh->bhpn", xc, bc, k_hat)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), s


def mamba2_block(p: dict, x: torch.Tensor, cfg, state=None):
    """Mamba2 mixer. x [B,T,D] -> (y [B,T,D], new_state)."""
    b, t, d = x.shape
    d_inner, n_heads, conv_dim = mamba2_dims(cfg)
    hd, n = cfg.ssm_head_dim, cfg.ssm_state

    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = apply_linear(p["in_proj"], xn)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, conv_dim, n_heads], dim=-1)
    prev = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv1d(xbc, p["conv_w"], prev)
    xbc = F.silu(xbc.to(F32)).to(x.dtype)
    xs, bmat, cmat = torch.split(xbc, [d_inner, n, n], dim=-1)

    dt_bias = p["dt_bias"].to(F32)
    dt = _softplus(dt.to(F32) + dt_bias)
    a = -torch.exp(p["a_log"].to(F32))                       # [H]
    loga = dt * a                                            # [B,T,H] <= 0

    xh = whole_heads(xs, n_heads).reshape(b, t, n_heads, hd).to(F32)
    bmat = bmat.to(F32)                                      # [B,T,N]
    cmat = cmat.to(F32)
    xdt = xh * dt[..., None]

    s0 = (state["ssd"].to(F32) if state is not None
          else torch.zeros((b, n_heads, hd, n), dtype=F32, device=x.device))
    if t == 1:
        upd = torch.einsum("bhp,bn->bhpn", xdt[:, 0], bmat[:, 0])
        s1 = s0 * torch.exp(loga[:, 0])[..., None, None] + upd
        ys = torch.einsum("bhpn,bn->bhp", s1, cmat[:, 0])[:, None]
    else:
        pad = (-t) % 128

        def scan(xdt, bmat, cmat, loga, s0):
            if not pad:
                return ssd_chunked(xdt, bmat, cmat, loga, s0)

            def padf(a):
                return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
            ys, s1 = ssd_chunked(padf(xdt), padf(bmat), padf(cmat),
                                 padf(loga), s0)
            return ys[:, :t], s1

        if is_dtensor(xdt):
            ys, s1 = on_local_blocks(
                scan, (xdt, bmat, cmat, loga, s0),
                ((0, 2), (0, None), (0, None), (0, 2), (0, 1)),
                ((0, 2), (0, 1)))
        else:
            ys, s1 = scan(xdt, bmat, cmat, loga, s0)

    ys = ys + xh * p["d_skip"].to(F32)[None, None, :, None]
    y = merge_heads(ys).to(x.dtype)
    y = y * F.silu(z.to(F32)).to(x.dtype)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    out = apply_linear(p["out_proj"], y)
    return out, {"conv": new_conv, "ssd": s1.to(F32)}


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent decay + token-shift ddlerp
# ---------------------------------------------------------------------------

def rwkv6_dims(cfg):
    n_heads = cfg.d_model // cfg.rwkv_head_dim
    return n_heads, cfg.rwkv_head_dim


def _on_local_rows(fn, rows, weights):
    """``fn(*rows, *weights)`` -> [B, T, D] (``rows`` [B, T, D] each), on
    each rank's own batch rows with the weights whole where the first
    row tensor is a DTensor (left to DTensor, the low-rank einsums may
    split the batch over the model axis that splits the weights' output
    dim too, which no product can take)."""
    if not is_dtensor(rows[0]):
        return fn(*rows, *weights)
    return on_local_blocks(
        lambda *a: (fn(*a),), (*rows, *weights),
        ((0, None),) * len(rows) + ((None, None),) * len(weights),
        ((0, None),))[0]


def _lerp(x, xprev, mu, lora_a, lora_b):
    diff = xprev - x
    xx = x + diff * mu
    adj = torch.tanh(torch.einsum("btd,dr->btr", xx.to(F32),
                                  lora_a.to(F32)))
    adj = torch.einsum("btr,rd->btd", adj, lora_b.to(F32))
    return x + diff * (mu + adj.to(x.dtype))


def _ddlerp(x, xprev, mu, lora_a, lora_b):
    """RWKV6 data-dependent lerp: x + (xprev - x) * (mu + lora(xx))."""
    return _on_local_rows(_lerp, (x, xprev), (mu, lora_a, lora_b))


def _decay(xw, w0, lora_a, lora_b):
    """The data-dependent decay exp(-exp(w0 + lora(xw))) in f32."""
    wlo = torch.tanh(torch.einsum("btd,dr->btr", xw.to(F32),
                                  lora_a.to(F32)))
    wlo = torch.einsum("btr,rd->btd", wlo, lora_b.to(F32))
    return torch.exp(-torch.exp(w0.to(F32)[None, None] + wlo))


def wkv6_chunked(r, k, v, logw, u, s0, chunk: int = 32):
    """Chunked WKV6 scan (per-channel decay, current-token bonus).

    r/k/v [B,T,H,K|V], logw [B,T,H,K] (<= 0), u [H,K] bonus, s0 [B,H,K,V].
    Recurrence: y_t = r_t·(S_{t-1} + D(u) k_t v_t^T); S_t = D(w_t) S_{t-1}
    + k_t v_t^T. Returns (ys [B,T,H,V], s_final).
    """
    b, t, h, dk = r.shape
    c = min(chunk, t)
    pad = (-t) % c
    if pad:  # logw=0 padding is state-neutral (decay 1, zero k/v/r)
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    tt = t + pad
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    s = s0
    ys = []
    for c0 in range(0, tt, c):
        rc, kc, vc, lc = (a[:, c0:c0 + c] for a in (r, k, v, logw))
        big_l = torch.cumsum(lc, dim=1)          # [B,C,H,K] inclusive
        l_prev = big_l - lc                      # exclusive (L_{t-1})
        # intra (u < t): sum_d r_t[d] k_u[d] exp(Lprev_t[d] - L_u[d])
        diff = l_prev[:, :, None] - big_l[:, None, :, :]     # [B,t,u,H,K]
        dec = torch.exp(torch.where(tri[None, :, :, None, None], diff,
                                    -torch.inf))
        rk = torch.einsum("bthk,buhk,btuhk->btuh", rc, kc, dec)
        y = torch.einsum("btuh,buhv->bthv", rk, vc)
        # bonus (u == t)
        y = y + torch.einsum("bthk,hk,bthk,bthv->bthv", rc, u, kc, vc)
        # inter-chunk: r_t decayed from chunk start against carried state
        y = y + torch.einsum("bthk,bhkv->bthv", rc * torch.exp(l_prev), s)
        # carry state to chunk end
        l_tot = big_l[:, -1]                     # [B,H,K]
        k_hat = kc * torch.exp(l_tot[:, None] - big_l)
        s = s * torch.exp(l_tot)[..., None] + torch.einsum(
            "bthk,bthv->bhkv", k_hat, vc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :t], s


def _shifted(xn, state, name):
    """The token-shift input: each token's predecessor, the first one's
    from ``state[name]`` (zeros without state)."""
    b, _, d = xn.shape
    if state is not None:
        first = state[name][:, None, :].to(xn.dtype)
    else:
        first = torch.zeros((b, 1, d), dtype=xn.dtype, device=xn.device)
    return torch.cat([first, xn[:, :-1]], dim=1)


def rwkv6_time_mix(p: dict, x: torch.Tensor, cfg, state=None):
    """RWKV6 time-mixing. x [B,T,D] -> (y, {"wkv", "shift_tm"})."""
    b, t, d = x.shape
    h, hd = rwkv6_dims(cfg)

    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    xprev = _shifted(xn, state, "shift_tm")

    xr = _ddlerp(xn, xprev, p["mu_r"], p["lora_r_a"], p["lora_r_b"])
    xk = _ddlerp(xn, xprev, p["mu_k"], p["lora_k_a"], p["lora_k_b"])
    xv = _ddlerp(xn, xprev, p["mu_v"], p["lora_v_a"], p["lora_v_b"])
    xw = _ddlerp(xn, xprev, p["mu_w"], p["lora_w_a"], p["lora_w_b"])
    xg = _ddlerp(xn, xprev, p["mu_g"], p["lora_g_a"], p["lora_g_b"])

    r = whole_heads(apply_linear(p["wr"], xr), h).reshape(b, t, h, hd)
    k = whole_heads(apply_linear(p["wk"], xk), h).reshape(b, t, h, hd)
    v = whole_heads(apply_linear(p["wv"], xv), h).reshape(b, t, h, hd)
    g = apply_linear(p["wg"], xg)

    # data-dependent decay (low-rank), in (0, 1)
    decay = _on_local_rows(_decay, (xw,), (p["w0"], p["w_lora_a"],
                                           p["w_lora_b"]))
    decay = whole_heads(decay, h).reshape(b, t, h, hd)

    u = p["u_bonus"].to(F32)                                 # [H, hd]
    rf, kf, vf = r.to(F32), k.to(F32), v.to(F32)

    s0 = (state["wkv"].to(F32) if state is not None
          else torch.zeros((b, h, hd, hd), dtype=F32, device=x.device))
    if t == 1:
        r1, k1, v1, w1 = (a.reshape(b, h, hd) for a in
                          (rf[:, 0], kf[:, 0], vf[:, 0], decay[:, 0]))
        kv = torch.einsum("bhk,bhv->bhkv", k1, v1)
        y = torch.einsum("bhk,bhkv->bhv", r1,
                         s0 + u[None, :, :, None] * kv)
        s1 = s0 * w1[..., None] + kv
        ys = y[:, None]
    else:
        logw = torch.log(torch.clamp(decay.to(F32), min=1e-30))
        if is_dtensor(rf):
            ys, s1 = on_local_blocks(
                wkv6_chunked, (rf, kf, vf, logw, u, s0),
                ((0, 2),) * 4 + ((None, 0), (0, 1)), ((0, 2), (0, 1)))
        else:
            ys, s1 = wkv6_chunked(rf, kf, vf, logw, u, s0)

    # per-head group norm, then silu(g) gate
    yn = rms_norm(ys.reshape(b, t, h, hd), p["gn"], cfg.norm_eps)
    yn = merge_heads(yn).to(x.dtype)
    yn = yn * F.silu(g.to(F32)).to(x.dtype)
    out = apply_linear(p["wo"], yn)
    return out, {"wkv": s1, "shift_tm": xn[:, -1].to(F32)}


def rwkv6_channel_mix(p: dict, x: torch.Tensor, cfg, state=None):
    """RWKV6 channel-mixing FFN with token shift."""
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    xprev = _shifted(xn, state, "shift_cm")
    xk = xn + (xprev - xn) * p["mu_ck"]
    xr = xn + (xprev - xn) * p["mu_cr"]
    kk = apply_linear(p["wk_c"], xk)
    kk = torch.square(torch.relu(kk.to(F32))).to(x.dtype)
    kv = apply_linear(p["wv_c"], kk)
    gate = torch.sigmoid(apply_linear(p["wr_c"], xr).to(F32)).to(x.dtype)
    return gate * kv, {"shift_cm": xn[:, -1].to(F32)}
