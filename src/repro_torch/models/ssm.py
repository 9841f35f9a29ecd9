"""State-space / linear-attention scan: the chunked kernel shared by
RWKV6 and Mamba2 in the reference.

Only the chunked scan (``chunked_linear_attention``) and its 2-D adapter
for the plan executor's ``ssm_scan`` host op (``scan_chunk_2d``) are
ported so far; the RWKV6 and Mamba2 blocks come with the SSM family.
The sequence is processed in chunks with an O(state) carry: the SSM
counterpart of the paper's paged streaming.  The reference scans the
chunks with ``lax.scan``; the port loops over them.
"""
from __future__ import annotations

import torch

# Per-token log-decay clamp: keeps exp(±Σ logw) inside fp32 range for the
# factored chunk products (chunk 16 × 5.0 = 80 < log(fp32_max) ≈ 88).
LOGW_MIN = -5.0
DEFAULT_CHUNK = 16


def chunked_linear_attention(r, k, v, logw, state, u=None,
                             chunk: int = DEFAULT_CHUNK,
                             inclusive: bool = False):
    """Chunkwise linear attention with per-(head, dim) decay.

    r, k, logw: (B, T, H, N); v: (B, T, H, M); state: (B, H, N, M).
    inclusive=False (RWKV): out_t reads S_{t-1}; the current token enters
      only through the ``u`` bonus diagonal.
    inclusive=True (Mamba2): out_t reads S_t (current token included,
      undecayed).
    Returns (out (B, T, H, M) in ``v.dtype``, final state fp32).
    """
    B, T, H, N = r.shape
    M = v.shape[-1]
    chunk = min(chunk, T)
    t_orig = T
    pad = (-T) % chunk
    if pad:
        # zero k/v and logw = 0 (decay 1) contribute nothing
        def zpad(a):
            z = a.new_zeros((B, pad) + tuple(a.shape[2:]))
            return torch.cat([a, z], dim=1)
        r, k, v, logw = zpad(r), zpad(k), zpad(v), zpad(logw)
        T = T + pad
    nc = T // chunk
    rc = r.reshape(B, nc, chunk, H, N).float()
    kc = k.reshape(B, nc, chunk, H, N).float()
    vc = v.reshape(B, nc, chunk, H, M).float()
    wc = logw.float().clamp(LOGW_MIN, 0.0).reshape(B, nc, chunk, H, N)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=r.device),
                      0 if inclusive else -1)
    eye = torch.eye(chunk, dtype=torch.float32, device=r.device)
    S = state.float()
    outs = []
    for c in range(nc):
        rb, kb, vb, wb = rc[:, c], kc[:, c], vc[:, c], wc[:, c]
        cum = torch.cumsum(wb, dim=1)           # inclusive log-decay sums
        total = cum[:, -1]                      # (B, H, N)
        r_exp = cum if inclusive else cum - wb
        inter = torch.einsum("bchn,bhnm->bchm", rb * torch.exp(r_exp), S)
        # midpoint-normalized factorization: both score factors stay
        # within exp(±(chunk/2)·|LOGW_MIN|)
        mid = cum[:, chunk // 2][:, None]
        r_mid = rb * torch.exp(r_exp - mid)
        k_dec = kb * torch.exp(mid - cum)
        scores = torch.einsum("bchn,bdhn->bhcd", r_mid, k_dec)
        scores = torch.where(mask[None, None], scores,
                             scores.new_zeros(()))
        if u is not None:                       # rwkv bonus, current token
            diag = torch.einsum("bchn,hn,bchn->bch", rb, u.float(), kb)
            scores = scores + torch.einsum("bch,ct->bhct", diag, eye)
        outs.append(inter + torch.einsum("bhcd,bdhm->bchm", scores, vb))
        # S' = diag(exp(total)) S + Σ_s (k_s exp(total - cum_s)) v_s
        k_fut = kb * torch.exp(total[:, None] - cum)
        S = torch.exp(total)[..., None] * S + torch.einsum(
            "bchn,bchm->bhnm", k_fut, vb)
    out = torch.stack(outs, dim=1).reshape(B, T, H, M)[:, :t_orig]
    return out.to(v.dtype), S


def scan_chunk_2d(r, k, v, logw, state, H, N, inclusive=True, u=None):
    """One scan chunk over 2-D operands: the adapter of the plan
    executor's ``ssm_scan`` host op (``core.plan.ssm_layer_plan``).

    r, k, logw: (L, H*N); v: (L, H*M); state: (H*N, M).  Runs
    ``chunked_linear_attention`` over one chunk at batch 1.  Returns
    (out (L, H*M), new state (H*N, M)), fp32.
    """
    L = r.shape[0]
    M = v.shape[1] // H
    r4 = r.float().reshape(1, L, H, N)
    k4 = k.float().reshape(1, L, H, N)
    v4 = v.float().reshape(1, L, H, M)
    w4 = logw.float().reshape(1, L, H, N)
    s4 = state.float().reshape(1, H, N, M)
    out, s = chunked_linear_attention(r4, k4, v4, w4, s4, u=u, chunk=L,
                                      inclusive=inclusive)
    return out.reshape(L, H * M), s.reshape(H * N, M)
