"""Plain reference of a Mamba2 stack (state-space duality,
arXiv:2405.21060), in fp32, one layer at a time over every sequence it is
given, in plain ``torch``. It imports nothing of the program under test and
takes its sizes from the configuration's keys.

Each layer: RMSNorm, the input projection to (z, x, B, C, dt), dt =
softplus(dt + dt_bias), A = -exp(A_log), the depthwise causal conv of
width ``d_conv`` over (x, B, C) from zero left context with SiLU, the
selective scan h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t
from the zero state (computed in chunks of 64 tokens in its matrix form),
the skip D x, the gated RMSNorm of y * silu(z), the output projection and
the residual. The head is the tied embedding after a final RMSNorm.
Where the port departs from the published model, the configuration's
file says so (``departures``); the reference computes what is served.
Sequences of unequal length are padded at their ends, which no earlier
position sees.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.common import Linear, exact_fp32, rmsnorm


def _ssd(x, dt, a, b, c, L=64):
    """x (B, T, H, P), dt (B, T, H), a (H,), b/c (B, T, G, N) fp32 ->
    y (B, T, H, P), from the zero state."""
    Bn, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    b = b.repeat_interleave(rep, dim=2)                           # (B, T, H, N)
    c = c.repeat_interleave(rep, dim=2)
    state = x.new_zeros((Bn, H, P, N))
    ys = []
    for t0 in range(0, T, L):
        t1 = min(t0 + L, T)
        xs, dts, bs, cs = x[:, t0:t1], dt[:, t0:t1], b[:, t0:t1], c[:, t0:t1]
        seg = torch.cumsum(dts * a, dim=1)                        # (B, l, H)
        diff = seg[:, :, None, :] - seg[:, None, :, :]            # (B, t, s, H)
        l = t1 - t0
        causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
        decay = torch.where(causal[None, :, :, None], torch.exp(diff.clamp(max=0)),
                            torch.zeros((), device=x.device))
        cb = torch.einsum("btHn,bsHn->btsH", cs, bs)
        y = torch.einsum("btsH,bsH,bsHp->btHp", cb * decay, dts, xs)
        y = y + torch.einsum("btHn,bHpn,btH->btHp", cs, state, torch.exp(seg))
        tail = torch.exp(seg[:, -1:, :] - seg)                    # (B, l, H)
        state = (state * torch.exp(seg[:, -1, :])[:, :, None, None]
                 + torch.einsum("bsH,bsH,bsHp,bsHn->bHpn", tail, dts, xs, bs))
        ys.append(y)
    return torch.cat(ys, dim=1)


def _layer(m, lin, p, h):
    Bn, T, d = h.shape
    di = m["expand"] * m["d_model"]
    ng, ns, hd = m["ngroups"], m["d_state"], m["headdim"]
    nh = di // hd
    zxbcdt = lin(h, p["in_proj"])
    z, xi = zxbcdt[..., :di], zxbcdt[..., di:2 * di]
    bc = zxbcdt[..., 2 * di:2 * di + 2 * ng * ns]
    dt = F.softplus(zxbcdt[..., 2 * di + 2 * ng * ns:] + p["dt_bias"].to(h.dtype))
    a = -torch.exp(p["a_log"].to(h.dtype))
    xbc = torch.cat([xi, bc], dim=-1)
    w, cw = p["conv_w"].to(h.dtype), p["conv_w"].shape[0]
    ext = torch.cat([xbc.new_zeros((Bn, cw - 1, xbc.shape[-1])), xbc], dim=1)
    conv = sum(ext[:, i:i + T] * w[i] for i in range(cw)) + p["conv_b"].to(h.dtype)
    xbc = F.silu(conv)
    xi, b, c = xbc[..., :di], xbc[..., di:di + ng * ns], xbc[..., di + ng * ns:]
    xh = xi.reshape(Bn, T, nh, hd)
    y = _ssd(xh, dt, a, b.reshape(Bn, T, ng, ns), c.reshape(Bn, T, ng, ns))
    y = y + xh * p["d_skip"].to(h.dtype)[None, None, :, None]
    y = rmsnorm(y.reshape(Bn, T, di) * F.silu(z), p["norm_g"], m["norm_epsilon"])
    return lin(y, p["out_proj"])


def logits(m: dict, w: dict, seqs: list, precision: str = "fp32") -> list:
    """Logits (n_i, V) at positions [score_from, T) of every sequence
    ``{"tokens": (T,) ints, "score_from": int}``, in ``precision``
    ("fp32"; "fp8" products: the control; "fp64")."""
    lin = Linear(precision)
    emb = w["embed"]["embedding"]
    dev, eps = emb.device, m["norm_epsilon"]
    with torch.no_grad(), exact_fp32():
        T = max(len(s["tokens"]) for s in seqs)
        toks = torch.zeros((len(seqs), T), dtype=torch.long)
        for i, s in enumerate(seqs):
            toks[i, :len(s["tokens"])] = torch.as_tensor(s["tokens"], dtype=torch.long)
        x = emb[toks.to(dev)].to(lin.dtype)
        for p in w["layers"]:
            x = x + _layer(m, lin, p["mixer"], rmsnorm(x, p["norm1"], eps))
        out = []
        for i, s in enumerate(seqs):
            hs = rmsnorm(x[i, s["score_from"]:len(s["tokens"])], w["final_norm"], eps)
            out.append(lin(hs, emb.t()))
        return out
