"""xLSTM blocks [arXiv:2405.04517]: the mLSTM (matrix memory, chunkwise
parallel form over a prompt, recurrent form per decoded token) and the
sLSTM (scalar memory, a sequential scan). The reference's
``src/repro/nn/xlstm.py``, function for function.

The mLSTM's chunkwise core goes through ``kernels/mlstm_chunk.py``
(the CUDA kernel for CUDA tensors, the plain version for CPU tensors),
which returns the final recurrent state with the outputs, so one call
serves the forward and the prefill. The recurrent decode step updates
the state in place (its C is dh x dh fp32 a head: no second copy per
step). The sLSTM is plain torch: its scan is a Python loop over time.
Training differentiates the mLSTM through the chunk kernel's
hand-written backward and the sLSTM's loop by autograd.

SCT applies to the surrounding up/down projections only (the recurrent
cell matrices are dynamics-coupled), as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_chunk import mlstm_chunk
from repro_torch.kernels.mlstm_ref import NEG_INIT
from repro_torch.nn.linear import apply_linear, init_linear
from repro_torch.nn.norms import apply_rmsnorm, init_rmsnorm


# ------------------------------------------------------------- mLSTM ----

def mlstm_dims(cfg):
    """(inner width di = 2 d_model, heads, mLSTM head width di // heads).
    The mLSTM's head width is not ``cfg.head_dim``: at xlstm-1.3b it is
    4096 / 4 = 1024."""
    di = 2 * cfg.d_model
    return di, cfg.n_heads, di // cfg.n_heads


def init_mlstm(cfg, *, generator, device, dtype=torch.float32):
    """mLSTM block, projection factor 2. cfg: d_model, n_heads, mlp_rank."""
    d = cfg.d_model
    di, h, _ = mlstm_dims(cfg)
    r = cfg.mlp_rank
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "up": init_linear(d, 2 * di, rank=r, **kw),
        "wq": init_linear(di, di, **kw),
        "wk": init_linear(di, di, **kw),
        "wv": init_linear(di, di, **kw),
        "wi": init_linear(di, h, bias=True, **kw),
        "wf": init_linear(di, h, bias=True, **kw),
        "wo_gate": init_linear(di, di, bias=True, **kw),
        "norm": init_rmsnorm(di, device=device, dtype=dtype),
        "down": init_linear(di, d, rank=r, **kw),
    }


def _mlstm_gates_qkv(p, xu, cfg):
    b, s, di = xu.shape
    h = cfg.n_heads
    dh = di // h
    q = apply_linear(p["wq"], xu).reshape(b, s, h, dh)
    k = apply_linear(p["wk"], xu).reshape(b, s, h, dh) / math.sqrt(dh)
    v = apply_linear(p["wv"], xu).reshape(b, s, h, dh)
    i_pre = apply_linear(p["wi"], xu).float()                   # (b, s, h)
    f_pre = apply_linear(p["wf"], xu).float()
    return q, k, v, i_pre, f_pre


def _fold(t):
    """(b, s, h, ...) -> (b * h, s, ...), contiguous: the kernel's layout."""
    b, s, h = t.shape[:3]
    return t.transpose(1, 2).reshape(b * h, s, *t.shape[3:]).contiguous()


def _mlstm_core(p, xu, cfg, state=None):
    """Chunkwise mLSTM over (b, s, di) gate inputs. Returns (y (b, s, h,
    dh) fp32, state {"C": (b, h, dh, dh), "n": (b, h, dh), "m": (b, h)})."""
    b, s, _ = xu.shape
    h = cfg.n_heads
    q, k, v, i_pre, f_pre = _mlstm_gates_qkv(p, xu, cfg)
    q, k, v = (t.float() for t in (q, k, v))
    dh = q.shape[-1]
    st = None
    if state is not None:
        st = (state["C"].reshape(b * h, dh, dh), state["n"].reshape(b * h, dh),
              state["m"].reshape(b * h))
    y, (C, n, m) = mlstm_chunk(_fold(q), _fold(k), _fold(v), _fold(i_pre), _fold(f_pre), st)
    y = y.reshape(b, h, s, dh).transpose(1, 2)
    return y, {"C": C.reshape(b, h, dh, dh), "n": n.reshape(b, h, dh), "m": m.reshape(b, h)}


def _mlstm_out(p, x, xu, z, y):
    b, s, _ = x.shape
    y = y.reshape(b, s, -1).to(x.dtype)
    o = torch.sigmoid(apply_linear(p["wo_gate"], xu))
    y = apply_rmsnorm(p["norm"], y * o) * F.silu(z)
    return apply_linear(p["down"], y)


def apply_mlstm_with_state(p, x, cfg, state=None):
    """Prefill: the chunkwise form over x (b, s, d); returns (out, the
    final recurrent state for the decode loop)."""
    xu, z = torch.chunk(apply_linear(p["up"], x), 2, dim=-1)      # (b, s, di) each
    y, new_state = _mlstm_core(p, xu, cfg, state=state)
    return _mlstm_out(p, x, xu, z, y), new_state


def apply_mlstm(p, x, cfg):
    """Training forward (exact chunkwise-parallel form). x: (b, s, d)."""
    return apply_mlstm_with_state(p, x, cfg)[0]


def mlstm_init_state(cfg, batch, *, device, dtype=torch.float32):
    _, h, dh = mlstm_dims(cfg)
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=dtype, device=device),
        "n": torch.zeros((batch, h, dh), dtype=dtype, device=device),
        "m": torch.full((batch, h), NEG_INIT, dtype=dtype, device=device),
    }


def apply_mlstm_decode(p, x, cfg, *, state):
    """Recurrent single-token step, O(1) in sequence length. Updates
    ``state``'s C, n and m in place and returns (out, state)."""
    b = x.shape[0]
    xu, z = torch.chunk(apply_linear(p["up"], x), 2, dim=-1)
    q, k, v, i_pre, f_pre = _mlstm_gates_qkv(p, xu, cfg)
    q, k, v = (t[:, 0].float() for t in (q, k, v))               # (b, h, dh)
    i_pre, f_pre = i_pre[:, 0], f_pre[:, 0]                       # (b, h)
    logf = F.logsigmoid(f_pre)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(logf + m, i_pre)
    f_sc = torch.exp(logf + m - m_new)[..., None]
    i_sc = torch.exp(i_pre - m_new)[..., None]
    kv = k[..., :, None] * v[..., None, :]
    C.mul_(f_sc[..., None]).add_(kv.mul_(i_sc[..., None]))
    n.mul_(f_sc).add_(i_sc * k)
    m.copy_(m_new)
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q, n)), torch.exp(-m_new))
    y = (num / den[..., None]).reshape(b, 1, -1).to(x.dtype)
    o = torch.sigmoid(apply_linear(p["wo_gate"], xu))
    y = apply_rmsnorm(p["norm"], y * o) * F.silu(z)
    return apply_linear(p["down"], y), state


# ------------------------------------------------------------- sLSTM ----

def init_slstm(cfg, *, generator, device, dtype=torch.float32):
    """sLSTM block: scalar memory with per-head recurrent mixing, plus a
    4/3-factor gated FFN (the paper's block design)."""
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    r = cfg.mlp_rank
    dff = int(4 * d / 3)
    kw = dict(generator=generator, device=device, dtype=dtype)
    wr = torch.randn((h, dh, 4 * dh), generator=generator, device=device,
                     dtype=torch.float32) * dh ** -0.5
    return {
        "wx": init_linear(d, 4 * d, bias=True, **kw),           # i, f, z, o pre-acts
        "wr": wr.to(dtype),
        "norm": init_rmsnorm(d, device=device, dtype=dtype),
        "ff_up": init_linear(d, 2 * dff, rank=r, **kw),
        "ff_down": init_linear(dff, d, rank=r, **kw),
    }


def _slstm_cell(p, cfg, xg, state):
    """One time step. xg: (b, 4d) input pre-activations; state {h, c, n,
    m} each (b, heads, d // heads). Returns the new state."""
    b = xg.shape[0]
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    # recurrent contribution: per-head h @ wr -> (b, heads, 4 dh), in the
    # state's dtype (fp32), as the reference casts wr
    rec = torch.einsum("bhd,hdg->bhg", state["h"], p["wr"].to(state["h"].dtype))
    pre = xg.reshape(b, nh, 4 * dh) + rec
    i_pre, f_pre, z_pre, o_pre = torch.chunk(pre.float(), 4, dim=-1)
    # stabilised exponential gating (per head dim)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    i_sc = torch.exp(i_pre - m_new)
    f_sc = torch.exp(logf + state["m"] - m_new)
    c = f_sc * state["c"] + i_sc * torch.tanh(z_pre)
    n = f_sc * state["n"] + i_sc
    hat = c / torch.clamp(n, min=1.0)
    h_new = torch.sigmoid(o_pre) * hat
    return {"h": h_new.to(state["h"].dtype), "c": c, "n": n, "m": m_new}


def slstm_init_state(cfg, batch, *, device, dtype=torch.float32):
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    shape = (batch, nh, dh)
    z = torch.zeros(shape, dtype=dtype, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(),
            "m": torch.full(shape, NEG_INIT, dtype=dtype, device=device)}


def _slstm_ffn(p, y):
    a, g = torch.chunk(apply_linear(p["ff_up"], y), 2, dim=-1)
    # jax.nn.gelu's default is the tanh approximation
    return apply_linear(p["ff_down"], F.gelu(a, approximate="tanh") * g)


def apply_slstm_with_state(p, x, cfg):
    """Prefill: the scan over x (b, s, d) from the empty state, once;
    returns (out, the final state). The reference runs the scan twice at
    prefill (once inside ``apply_slstm``, once for the state): the same
    numbers."""
    b, s, d = x.shape
    xg = apply_linear(p["wx"], x)                                # (b, s, 4d)
    state = slstm_init_state(cfg, b, device=x.device)
    hs = []
    for t in range(s):
        state = _slstm_cell(p, cfg, xg[:, t], state)
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    y = apply_rmsnorm(p["norm"], y)
    return _slstm_ffn(p, y), state


def apply_slstm(p, x, cfg):
    """Training forward: sequential scan over time. x: (b, s, d)."""
    return apply_slstm_with_state(p, x, cfg)[0]


def apply_slstm_decode(p, x, cfg, *, state):
    """One token: x (b, 1, d) -> (out, new state)."""
    xg = apply_linear(p["wx"], x)[:, 0]                          # (b, 4d)
    state = _slstm_cell(p, cfg, xg, state)
    y = state["h"].reshape(x.shape[0], 1, cfg.d_model).to(x.dtype)
    y = apply_rmsnorm(p["norm"], y)
    return _slstm_ffn(p, y), state
