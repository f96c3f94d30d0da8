"""Mamba selective-SSM mixer, the '7' in Jamba's 1:7 attention:mamba
interleave [arXiv:2403.19887]: the reference's ``src/repro/nn/mamba.py``,
function for function.

The prompt path's scan goes through ``kernels/mamba_scan.py`` (the CUDA
kernel for CUDA tensors, the plain version for CPU tensors), which
carries the state in fp32 as the JAX package's Pallas kernel does and
returns the final state, so one call serves the forward and the prefill;
under autograd its backward is the hand-written backward kernel, and the
rest of the mixer (conv taps, softplus, the split views of ``x_proj``)
trains by autograd over plain ops.
The reference's model runs the scan's jnp twin, which carries h in the
compute dtype: the two agree in fp32 (``kernels/mamba_ref.py``). Decode
is one plain step per token over a (conv tail, ssm state) the serving
state keeps in bf16, as in the reference (which has no kernel for it).

The in/out projections are spectral only with ``cfg.sct.spectral_mamba``
(dense in the paper-faithful mode), as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.nn.linear import apply_linear, init_linear

STATE_DTYPE = torch.bfloat16     # the serving state's dtype, whatever cfg.dtype is


def mamba_dims(cfg):
    """(inner width di, d_state, d_conv, dt_rank)."""
    return (cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state, cfg.mamba_d_conv,
            cfg.mamba_dt_rank)


def init_mamba(cfg, *, generator, device, dtype=torch.float32):
    """cfg needs: d_model, mamba_expand, mamba_d_state, mamba_d_conv,
    mamba_dt_rank, mamba_rank."""
    d = cfg.d_model
    di, ds, dc, dtr = mamba_dims(cfg)
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "in_proj": init_linear(d, 2 * di, rank=cfg.mamba_rank, **kw),
        "conv_w": (torch.randn((dc, di), generator=generator, device=device,
                               dtype=torch.float32) * dc ** -0.5).to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": init_linear(di, dtr + 2 * ds, **kw),
        "dt_proj": init_linear(dtr, di, bias=True, **kw),
        "A_log": torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=device)
                           ).repeat(di, 1).to(dtype),
        "D": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": init_linear(di, d, rank=cfg.mamba_rank, **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (b, s, di); depthwise causal conv, kernel (dc, di): the taps
    unrolled, sum_j w[j] * x[t - dc + 1 + j]."""
    dc, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, dc - 1, 0))
    out = sum(pad[:, j:j + s, :] * w[j].to(x.dtype) for j in range(dc))
    return out + b.to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log(1 + exp(x)) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_scan(u, dt, B, C, A, D):
    """Selective scan from the zero state. u, dt: (b, s, di); B, C: (b, s,
    ds); A: (di, ds). Returns (y (b, s, di) in u.dtype, the final state
    (b, di, ds) fp32)."""
    return mamba_scan(u, dt, B, C, A, D)


def _mamba_pre(p, x, cfg):
    di = mamba_dims(cfg)[0]
    xz = apply_linear(p["in_proj"], x)
    return xz[..., :di], xz[..., di:]


def _mamba_ssm_params(p, xi, cfg):
    _, ds, _, dtr = mamba_dims(cfg)
    proj = apply_linear(p["x_proj"], xi)
    dt_in, B, C = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = _softplus(apply_linear(p["dt_proj"], dt_in))
    A = -torch.exp(p["A_log"].float()).to(xi.dtype)
    return dt, B, C, A


def apply_mamba(p, x, cfg, *, return_state: bool = False):
    """Training / prefill forward. x: (b, s, d). With return_state=True
    also returns the exact decode state: the conv tail (the last d_conv -
    1 rows of the pre-conv ``xi``, zero rows before the first token of a
    shorter prompt) and the final SSM state (fp32)."""
    xi, z = _mamba_pre(p, x, cfg)
    xi_c = F.silu(_causal_conv(xi, p["conv_w"], p["conv_b"]))
    dt, B, C, A = _mamba_ssm_params(p, xi_c, cfg)
    y, hT = _ssm_scan(xi_c, dt, B, C, A, p["D"])
    out = apply_linear(p["out_proj"], y * F.silu(z))
    if return_state:
        tail = cfg.mamba_d_conv - 1
        xp = F.pad(xi, (0, 0, max(0, tail - xi.shape[1]), 0))
        conv = xp[:, xp.shape[1] - tail:]
        return out, {"conv": conv, "ssm": hT}
    return out


def mamba_init_state(cfg, batch: int, *, device, dtype=STATE_DTYPE):
    di, ds, dc, _ = mamba_dims(cfg)
    return {"conv": torch.zeros((batch, dc - 1, di), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, di, ds), dtype=dtype, device=device)}


def apply_mamba_decode(p, x, cfg, *, state):
    """One-token step. x: (b, 1, d); state {"conv": (b, dc - 1, di), "ssm":
    (b, di, ds)}. The update runs in the compute dtype; the new state
    comes back in the state's dtype. Returns (out, new_state)."""
    xi, z = _mamba_pre(p, x, cfg)                                       # (b, 1, di)
    conv_in = torch.cat([state["conv"].to(xi.dtype), xi], dim=1)        # (b, dc, di)
    xi_c = (torch.einsum("bcd,cd->bd", conv_in, p["conv_w"].to(xi.dtype))[:, None, :]
            + p["conv_b"].to(xi.dtype))
    xi_c = F.silu(xi_c)
    dt, B, C, A = _mamba_ssm_params(p, xi_c, cfg)
    dA = torch.exp(dt[:, 0, :, None] * A[None])                         # (b, di, ds)
    dBu = dt[:, 0, :, None] * B[:, 0, None, :] * xi_c[:, 0, :, None]
    h = dA * state["ssm"].to(dA.dtype) + dBu
    y = torch.einsum("bds,bs->bd", h, C[:, 0])[:, None, :]
    y = (y + xi_c * p["D"].to(xi_c.dtype)) * F.silu(z)
    out = apply_linear(p["out_proj"], y)
    return out, {"conv": conv_in[:, 1:, :].to(state["conv"].dtype),
                 "ssm": h.to(state["ssm"].dtype)}
