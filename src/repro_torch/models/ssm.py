"""State-space / linear-attention blocks: the RWKV6 (Finch) time and
channel mix and the Mamba2 block (zamba2), both over one chunked scan.

The sequence is processed in chunks with an O(state) carry
(``chunked_linear_attention``): the SSM counterpart of the paper's paged
streaming.  The reference scans the chunks with ``lax.scan``; the port
loops over them.  Decode is the exact single-step recurrence
(``linear_attention_step``).  ``scan_chunk_2d`` adapts one chunk for
the plan executor's ``ssm_scan`` host op.

RWKV6 time mix (per head h, head size N):
    out_t = r_t · (S_{t-1} + (u ⊙ k_t) v_tᵀ)
    S_t   = diag(w_t) S_{t-1} + k_t v_tᵀ          (w_t data-dependent)
Mamba2 (SSD, scalar-per-head decay):
    S_t = a_t S_{t-1} + dt_t · B_t x_tᵀ ;  y_t = C_t · S_t + D x_t

Every projection runs through the streaming GEMM (``layers._gemm``).
The token-shift lerps, ``sigmoid(mix)``, the gate and ``relu(·)²`` stay
in the activation dtype (bf16) and round after each op, as the
reference's ops do when XLA runs them one by one; the decay
``-exp(ww-projection + w_bias)``, the scan and the recurrence are fp32
(on the card with TF32 off, PyTorch's default: the chunk's midpoint
factors reach exp(±40)).  The scan's ops are plain PyTorch, as they
are plain XLA in the reference.

Mamba2 keeps the reference's dtypes: the projections, the causal
depthwise convolution (each tap's product and sum rounded), its SiLU,
``x · dt``, the skip ``D x`` and the gate ``out · silu(z)`` are bf16;
softplus(dt + ``dt_bias``), the decay ``-exp(A_log)``, the scan and
the gated RMSNorm (with its fp32 ``norm_scale``) are fp32.  B and C are
one group, broadcast to every head; the scan is the inclusive form of
``chunked_linear_attention``, and a decode step is the same forward
over one token (``mamba2_step``), as in the reference.

Training runs the same sequence forwards under autograd, each layer
from a zero state (``transformer.forward_train``), so the scan's torch
ops are differentiated by autograd as the reference's XLA ops are.

Tensor parallelism (the train step on a ``model`` of more than one
rank, ``sharding.tensor_parallel``): each layer reads its leaves as the
rank's blocks and learns from their shapes what the placements split
(``qkv``, ``heads`` and ``mlp`` over ``model``, each where it divides).

- RWKV6's time mix: the five lerps pass one ``copy_to_model`` (forward
  nothing; backward one all-reduce of their five gradients, so ``mix``'s
  gradient comes out whole); ``wr`` / ``wk`` / ``wv`` / ``wg`` / ``ww``
  column-parallel over the rank's d/m columns, which are its H/m heads
  where m divides H; ``w_bias`` / ``u`` its rows; the scan over those
  heads (the zero state sliced to them); ``wo`` row-parallel, ending in
  ``reduce_from_model`` (one all-reduce forward).  Where the columns
  split and the heads do not (a block cuts a head), r / k / v / w are
  gathered whole (``gather_from_model`` then ``copy_to_model``: an
  all-gather forward, an all-reduce of the whole gradient backward, of
  which the rank keeps its block) and ``u`` / ``w_bias`` pass the same
  ``copy_to_model``; each rank scans every head and feeds ``wo`` its own
  columns of the output.
- RWKV6's channel mix: ``lk`` / ``lr`` pass one ``copy_to_model``;
  ``wk`` column-parallel and ``wv`` row-parallel over the rank's d_ff/m
  columns, ending in ``reduce_from_model``; ``r = sigmoid(lr·wr)`` over
  the rank's d/m columns is gathered whole by ``gather_from_model``
  (one all-gather forward; backward the rank's slice, since what reads
  r, ``r * (k·wv)``, is alike on every rank).
- Mamba2: the rank's heads where m divides nh.  The fused ``in_proj``'s
  even column blocks do not follow its z / x / B / C / dt segments, so
  the product runs column-parallel from ``copy_to_model(x)`` and is
  gathered whole (``gather_from_model`` then ``copy_to_model``); so is
  ``conv_w``'s block.  The rank takes its heads' z, x and dt channels,
  B and C whole, and its conv taps; the conv and the scan run on those
  (B and C's conv on every rank); ``A_log`` / ``D`` / ``dt_bias`` are
  its rows.  The gated RMSNorm's mean over the whole d_in is the ranks'
  fp32 sums of squares summed both ways (``copy_to_model(
  reduce_from_model(s))``: forward the sum; backward the sum of every
  rank's gradient of it, each rank's normed values depending on it),
  divided by d_in.  ``norm_scale`` (whole) passes ``copy_to_model``
  before the rank slices it, so its gradient comes out whole on every
  rank (a whole leaf read in part gets its summed gradient in the
  layer, not in the step).  ``out_proj`` row-parallel over the rank's
  d_in/m rows, ending in ``reduce_from_model``.  Where ``out_proj``
  splits and the heads do not, every rank runs every head, the whole
  leaves pass ``copy_to_model`` (each rank's gradient of them a share),
  and ``out_proj`` reads the rank's rows of the gated output.

Forward a split layer rounds once more than one rank: each rank's
bf16 GEMM partial of the row-parallel output, summed in fp32 and
rounded once (``reduce_from_model``), and the fp32 sum of squares
summed in another order; its gradients are summed in fp32 and rounded
once to the leaf's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import tuning as TU
from repro_torch.models.params import PSpec
from repro_torch.sharding import tensor_parallel as TP

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


def linear_attention_step(r, k, v, logw, state, u=None,
                          inclusive: bool = False):
    """Exact single-token recurrence.  r, k, logw: (B, H, N); v:
    (B, H, M); state: (B, H, N, M) fp32.  Returns (out (B, H, M) in
    ``v.dtype``, new state fp32)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    kv = kf[..., :, None] * vf[..., None, :]
    decay = torch.exp(logw.float().clamp(LOGW_MIN, 0.0))[..., None]
    if inclusive:           # mamba2: update the state, then read it
        state = decay * state + kv
        out = torch.einsum("bhn,bhnm->bhm", rf, state)
    else:                   # rwkv: read S + u-bonus, then update
        read = state + u.float()[..., None] * kv if u is not None \
            else state
        out = torch.einsum("bhn,bhnm->bhm", rf, read)
        state = decay * state + kv
    return out.to(v.dtype), state


# ------------------------------------------------------------------
# RWKV6 block
# ------------------------------------------------------------------
def rwkv_pspecs(cfg: ModelConfig):
    d = cfg.d_model
    H = cfg.n_heads
    N = d // H
    return {
        "time": {
            "wr": PSpec((d, d), ("embed", "qkv")),
            "wk": PSpec((d, d), ("embed", "qkv")),
            "wv": PSpec((d, d), ("embed", "qkv")),
            "wg": PSpec((d, d), ("embed", "qkv")),
            "ww": PSpec((d, d), ("embed", "qkv"), scale=0.01),
            "w_bias": PSpec((H, N), ("heads", "head_dim"), "zeros"),
            "u": PSpec((H, N), ("heads", "head_dim"), "zeros"),
            "wo": PSpec((d, d), ("qkv", "embed")),
            "mix": PSpec((5, d), (None, "embed_act"), "zeros"),
        },
        "channel": {
            "wk": PSpec((d, cfg.d_ff), ("embed", "mlp")),
            "wv": PSpec((cfg.d_ff, d), ("mlp", "embed")),
            "wr": PSpec((d, d), ("embed", "qkv")),
            "mix": PSpec((2, d), (None, "embed_act"), "zeros"),
        },
    }


def _silu(x):
    """The reference's ``jax.nn.silu``, x * sigmoid(x), rounded after
    each op as ``layers.sigmoid_op_by_op`` is."""
    return x * L.sigmoid_op_by_op(x)


def _token_shift(x, last):
    """Shift right by one; ``last`` (B, d) is the previous sequence's
    tail."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _lerps(x, xs, mix):
    """The token-shift interpolations ``x + (xs - x) * sigmoid(mix)[i]``
    for every row i of ``mix``, in ``x.dtype``."""
    dx = xs - x
    return [x + dx * m for m in L.sigmoid_op_by_op(mix)]


def rwkv_time_mix(p, x, cfg: ModelConfig, state, chunk: int = 0):
    """x: (B, T, d); state: {"s": (B, H, N, N) fp32, "shift": (B, d)}.
    Returns (out (B, T, d), final state).  Where ``model`` splits the
    projections' columns (module docstring), over this rank's heads;
    the returned scan state is then theirs."""
    chunk = chunk or TU.get().ssm_chunk
    B, T, d = x.shape
    N = d // cfg.n_heads
    cols = p["wr"].shape[1]
    split = TP.parallel(cols, d)
    heads = TP.parallel(p["u"].shape[0], cfg.n_heads)
    lerps = _lerps(x, _token_shift(x, state["shift"]), p["mix"])
    lr, lk, lv, lg, lw = TP.copy_to_model(*lerps) if split else lerps
    r, k, v, w = (L._gemm(t, p[n]) for t, n in ((lr, "wr"), (lk, "wk"),
                                                (lv, "wv"), (lw, "ww")))
    g = _silu(L._gemm(lg, p["wg"]))
    u, w_bias, s0 = p["u"], p["w_bias"], state["s"]
    if heads:
        s0 = s0[:, slice(*TP.model_range(u.shape[0]))]
    elif split:     # column blocks that cut heads: every head, whole
        *rkvw, u, w_bias = TP.copy_to_model(
            *(TP.gather_from_model(t) for t in (r, k, v, w)), u, w_bias)
        r, k, v, w = rkvw
    H = u.shape[0]
    r, k, v = (t.reshape(B, T, H, N) for t in (r, k, v))
    logw = -torch.exp(w.reshape(B, T, H, N).float() + w_bias.float())
    out, s = chunked_linear_attention(r, k, v, logw, s0, u=u.float(),
                                      chunk=chunk)
    out = out.reshape(B, T, H * N)
    if split and not heads:
        out = out[..., slice(*TP.model_range(cols))]
    out = L._gemm(out * g, p["wo"])
    if split:
        out = TP.reduce_from_model(out)
    return out, {"s": s, "shift": x[:, -1]}


def rwkv_time_mix_step(p, x, cfg: ModelConfig, state):
    """x: (B, d), a single token.  Returns (out (B, d), new state)."""
    B, d = x.shape
    H = cfg.n_heads
    N = d // H
    lr, lk, lv, lg, lw = _lerps(x, state["shift"], p["mix"])
    r = L._gemm(lr, p["wr"]).reshape(B, H, N)
    k = L._gemm(lk, p["wk"]).reshape(B, H, N)
    v = L._gemm(lv, p["wv"]).reshape(B, H, N)
    g = _silu(L._gemm(lg, p["wg"]))
    logw = -torch.exp(L._gemm(lw, p["ww"]).float().reshape(B, H, N)
                      + p["w_bias"].float())
    out, s = linear_attention_step(r, k, v, logw, state["s"],
                                   u=p["u"].float())
    out = L._gemm(out.reshape(B, d) * g, p["wo"])
    return out, {"s": s, "shift": x}


def rwkv_channel_mix(p, x, state_shift, cfg: ModelConfig = None):
    """x: (B, T, d) with the previous tail ``state_shift`` (B, d), or a
    single token (B, d).  Returns (out, new shift).  With ``cfg``, over
    the rank's blocks of ``wk`` / ``wv`` and ``wr`` where ``model``
    splits them (module docstring)."""
    xs = _token_shift(x, state_shift) if x.ndim == 3 else state_shift
    lk, lr = _lerps(x, xs, p["mix"])
    mlp = cfg is not None and TP.parallel(p["wk"].shape[1], cfg.d_ff)
    gate = TP.parallel(p["wr"].shape[1], x.shape[-1])
    lk, lr = _copy_where((lk, lr), (mlp, gate))
    k = torch.relu(L._gemm(lk, p["wk"])) ** 2
    r = L.sigmoid_op_by_op(L._gemm(lr, p["wr"]))
    if gate:
        r = TP.gather_from_model(r)
    kv = L._gemm(k, p["wv"])
    if mlp:
        kv = TP.reduce_from_model(kv)
    new_shift = x[:, -1] if x.ndim == 3 else x
    return r * kv, new_shift


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device=None):
    """A zero state: the scan's ``s`` in fp32, the two token shifts in
    ``dtype``.  Training and serving pass the activations' dtype (bf16):
    an fp32 shift would promote every lerp of the token shift to fp32."""
    H = cfg.n_heads
    N = cfg.d_model // H
    return {
        "time": {"s": torch.zeros((batch, H, N, N), dtype=torch.float32,
                                  device=device),
                 "shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                      device=device)},
        "channel_shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                     device=device),
    }


def rwkv_state_axes(cfg: ModelConfig):
    """Logical axes of ``init_rwkv_state``'s tree, the reference's."""
    return {
        "time": {"s": ("cache_batch", "heads", "head_dim", "head_dim"),
                 "shift": ("cache_batch", "embed_act")},
        "channel_shift": ("cache_batch", "embed_act"),
    }


# ------------------------------------------------------------------
# Mamba2 block (zamba2)
# ------------------------------------------------------------------
def mamba2_pspecs(cfg: ModelConfig):
    d = cfg.d_model
    s = cfg.ssm
    d_in = s.expand * d
    nh = d_in // s.head_dim
    return {
        "in_proj": PSpec((d, 2 * d_in + 2 * s.d_state + nh),
                         ("embed", "qkv")),
        "conv_w": PSpec((s.d_conv, d_in + 2 * s.d_state), ("conv", "qkv")),
        "A_log": PSpec((nh,), ("heads",), "zeros"),
        "D": PSpec((nh,), ("heads",), "ones"),
        "dt_bias": PSpec((nh,), ("heads",), "zeros"),
        "out_proj": PSpec((d_in, d), ("qkv", "embed")),
        "norm_scale": PSpec((d_in,), ("embed_act",), "ones", dtype="float32"),
    }


def _mamba_split(cfg: ModelConfig):
    """(d_in, heads, d_state) of a Mamba2 layer."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, s.d_state


def _causal_conv(x, w, conv_state=None):
    """Depthwise causal convolution along T.  x: (B, T, C); w: (K, C);
    ``conv_state`` (B, K - 1, C), the previous inputs (zeros if None).
    Returns (out (B, T, C), the last K - 1 inputs as the new state)."""
    K, T = w.shape[0], x.shape[1]
    if conv_state is None:
        conv_state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = xp[:, :T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    return out, xp[:, -(K - 1):]


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def mamba2_forward(p, x, cfg: ModelConfig, state, chunk: int = DEFAULT_CHUNK):
    """x: (B, T, d); state: {"s": (B, nh, N, hd) fp32, "conv": (B, K - 1,
    d_in + 2N)}.  Returns (out (B, T, d), the final state).  Where
    ``model`` splits the leaves (module docstring), the scan runs over
    this rank's heads, and the returned state holds theirs (the conv
    state their x channels and B / C)."""
    B, T, d = x.shape
    d_in, nh, N = _mamba_split(cfg)
    hd = cfg.ssm.head_dim
    proj, conv_w = p["in_proj"], p["conv_w"]
    # a layer whose out-projection is row-parallel: each rank's gradient
    # of what it computes whole is a share, summed over ``model``
    share = TP.parallel(p["out_proj"].shape[0], d_in)
    heads = TP.parallel(p["A_log"].shape[0], nh)
    if TP.parallel(proj.shape[1], 2 * d_in + 2 * N + nh):
        zxbcdt = _whole(L._gemm(TP.copy_to_model(x), proj), share)
    else:
        zxbcdt = L._gemm(x, proj)
        if share:
            zxbcdt = TP.copy_to_model(zxbcdt)
    conv_split = TP.parallel(conv_w.shape[1], d_in + 2 * N)
    if conv_split:
        conv_w = _whole(conv_w, share)
    # with ``share``, the whole leaves (a rank reads them in part, or
    # through its share) pass ``copy_to_model``: their gradients summed
    a_log, D, dt_bias, scale, conv_w = _copy_where(
        [p["A_log"], p["D"], p["dt_bias"], p["norm_scale"], conv_w],
        [share and not s for s in (heads, heads, heads, False, conv_split)])
    h0, h1 = TP.model_range(a_log.shape[0]) if heads else (0, nh)
    lo, hi = h0 * hd, h1 * hd
    dl, s0, c0 = hi - lo, state["s"], state["conv"]
    if heads:       # the rank's heads' x channels, B and C whole
        keep = torch.cat([torch.arange(lo, hi, device=x.device),
                          torch.arange(d_in, d_in + 2 * N, device=x.device)])
        zxbcdt = torch.cat([zxbcdt[..., lo:hi],
                            zxbcdt[..., d_in + lo:d_in + hi],
                            zxbcdt[..., 2 * d_in:2 * d_in + 2 * N],
                            zxbcdt[..., 2 * d_in + 2 * N + h0:
                                   2 * d_in + 2 * N + h1]], dim=-1)
        conv_w, c0 = conv_w[:, keep], c0[..., keep]
        s0 = s0[:, h0:h1]
    nhl = h1 - h0
    z, xin, Bc, Cc, dt = torch.split(zxbcdt, [dl, dl, N, N, nhl], dim=-1)
    conv_out, conv_state = _causal_conv(torch.cat([xin, Bc, Cc], dim=-1),
                                        conv_w, c0)
    xin, Bc, Cc = torch.split(_silu(conv_out), [dl, N, N], dim=-1)
    dt = _softplus(dt.float() + dt_bias.float())               # (B, T, nh)
    a = -torch.exp(a_log.float())                               # (nh,)
    logw = (dt * a)[..., None].expand(B, T, nhl, N)
    xheads = xin.reshape(B, T, nhl, hd)
    xh = xheads * dt[..., None].to(xheads.dtype)
    # r = C (queries), k = B (keys): the state is (B, nh, N, hd)
    r = Cc[:, :, None, :].expand(B, T, nhl, N)
    k = Bc[:, :, None, :].expand(B, T, nhl, N)
    out, s = chunked_linear_attention(r, k, xh, logw, s0,
                                      chunk=chunk, inclusive=True)
    out = out + xheads * D.to(xheads.dtype)[:, None]
    out = out.reshape(B, T, dl)
    # gated RMSNorm over the whole d_in, then the out-projection
    of = out.float()
    if heads:       # the ranks' sums of squares, summed both ways
        var = TP.copy_to_model(TP.reduce_from_model(
            of.square().sum(-1, keepdim=True))) / d_in
    else:
        var = of.square().mean(-1, keepdim=True)
    out = (of * torch.rsqrt(var + 1e-5) * scale[lo:hi]).to(x.dtype)
    out = out * _silu(z)
    if share and not heads:
        out = out[..., slice(*TP.model_range(p["out_proj"].shape[0]))]
    out = L._gemm(out, p["out_proj"])
    if share:
        out = TP.reduce_from_model(out)
    return out, {"s": s, "conv": conv_state}


def _copy_where(xs, flags) -> list:
    """``xs`` with those whose flag is set through one ``copy_to_model``
    (their gradients summed over ``model`` in one all-reduce)."""
    at = [i for i, f in enumerate(flags) if f]
    xs = list(xs)
    if at:
        got = TP.copy_to_model(*(xs[i] for i in at))
        for i, g in zip(at, got if len(at) > 1 else (got,)):
            xs[i] = g
    return xs


def _whole(block, share: bool):
    """A rank's last-dim block gathered whole (``gather_from_model``);
    with ``share`` (the rank computes a share of what reads it) through
    ``copy_to_model`` too, so that its gradient, summed over ``model``,
    comes back sliced to the rank's block (module docstring)."""
    y = TP.gather_from_model(block)
    return TP.copy_to_model(y) if share else y


def mamba2_step(p, x, cfg: ModelConfig, state):
    """x: (B, d), a single token: ``mamba2_forward`` at chunk 1."""
    out, st = mamba2_forward(p, x[:, None], cfg, state, chunk=1)
    return out[:, 0], st


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None):
    """A zero state: the scan's ``s`` in fp32, the convolution's last
    K - 1 inputs in ``dtype``."""
    d_in, nh, N = _mamba_split(cfg)
    K = cfg.ssm.d_conv
    return {
        "s": torch.zeros((batch, nh, N, cfg.ssm.head_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, K - 1, d_in + 2 * N), dtype=dtype,
                            device=device),
    }


def mamba_state_axes(cfg: ModelConfig):
    """Logical axes of ``init_mamba_state``'s tree, the reference's."""
    return {"s": ("cache_batch", "heads", "state", "head_dim"),
            "conv": ("cache_batch", "conv", "qkv")}
