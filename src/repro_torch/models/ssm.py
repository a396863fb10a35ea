"""Recurrent sequence mixers: xLSTM (mLSTM + sLSTM) and RG-LRU (Griffin).

The JAX package's formulations, in PyTorch:

* **mLSTM** in chunkwise-parallel form: within a chunk of L tokens the
  gram and decay matrices are dense ``[L, L]`` products; across chunks a
  loop carries the ``(C, n, m)`` matrix-memory state.  ``T`` must be a
  multiple of ``L = min(chunk, T)``, the reference's assertion (a 384-token
  extend with the default chunk of 256 raises there and here).
  ``mlstm_recurrent_ref`` is the sequential recurrence, used for decode
  steps and as the oracle of the chunked form.
* **sLSTM** has a true nonlinear recurrence (``h_{t-1}`` enters the gate
  pre-activations through a per-head block-diagonal matrix), so it is a
  loop over time.
* **RG-LRU** is a gated LINEAR recurrence ``h_t = a_t h_{t-1} + b_t``,
  solved by a log-depth scan (``ceil(log2 T)`` doubling steps over the
  whole sequence) instead of a loop over tokens, after a width-4 causal
  depthwise convolution whose last three inputs are carried as state.

Every mixer takes and returns an explicit state dict, batched on axis 0,
with every leaf in f32 whatever the model dtype (the reference's state
dtypes): mLSTM ``C [B, H, dh, dh]``, ``n [B, H, dh]``, ``m [B, H]``
(``m`` starts at ``LOG_EPS``); sLSTM ``c, n, h, m [B, D]`` (``n`` starts
at 1e-6, ``m`` at ``LOG_EPS``); RG-LRU ``h [B, d_rnn]``, ``conv [B, 3,
d_rnn]``.  No mixer updates a state in place: each returns new tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import ACTS, _dense_init

LOG_EPS = -30.0
State = Dict[str, torch.Tensor]
f32 = torch.float32


# ===========================================================================
# mLSTM
# ===========================================================================

def init_mlstm(gen: torch.Generator, d: int, heads: int, dtype) -> State:
    dev = gen.device
    return {
        "wq": _dense_init(gen, (d, d), d, dtype),
        "wk": _dense_init(gen, (d, d), d, dtype),
        "wv": _dense_init(gen, (d, d), d, dtype),
        "wi": _dense_init(gen, (d, heads), d, f32),
        "wf": _dense_init(gen, (d, heads), d, f32),
        "wo": _dense_init(gen, (d, d), d, dtype),
        "wz": _dense_init(gen, (d, d), d, dtype),     # gate branch
        "wd": _dense_init(gen, (d, d), d, dtype),     # down projection
        "bf": torch.full((heads,), 2.0, dtype=f32, device=dev),
        "bi": torch.zeros((heads,), dtype=f32, device=dev),
    }


def spec_mlstm() -> Dict[str, tuple]:
    return {
        "wq": (None, "tp"), "wk": (None, "tp"), "wv": (None, "tp"),
        "wi": (None, None), "wf": (None, None),
        "wo": (None, "tp"), "wz": (None, "tp"), "wd": ("tp", None),
        "bf": (None,), "bi": (None,),
    }


def spec_mlstm_state() -> Dict[str, tuple]:
    # dv (C dim 2) sharded over model: heads (4) < tp, so shard inner dim
    return {"C": ("dp", None, "tp", None), "n": ("dp", None, "tp"),
            "m": ("dp", None)}


def mlstm_state_shape(batch: int, heads: int, dh: int
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    return {"C": ((batch, heads, dh, dh), f32), "n": ((batch, heads, dh), f32),
            "m": ((batch, heads), f32)}


def init_mlstm_state(batch: int, heads: int, dh: int, device) -> State:
    st = {k: torch.zeros(s, dtype=dt, device=device)
          for k, (s, dt) in mlstm_state_shape(batch, heads, dh).items()}
    st["m"].fill_(LOG_EPS)
    return st


def _mlstm_gates(p: State, x: torch.Tensor):
    """x [B, T, D] -> (q, k, v [B, T, H, dh]; li, lf [B, T, H] log gates in
    f32; o, z [B, T, D])."""
    B, T, D = x.shape
    H = p["wi"].shape[1]
    dh = D // H
    q = (x @ p["wq"]).reshape(B, T, H, dh)
    k = (x @ p["wk"]).reshape(B, T, H, dh) * (dh ** -0.5)
    v = (x @ p["wv"]).reshape(B, T, H, dh)
    xf = x.float()
    li = xf @ p["wi"] + p["bi"]                        # input gate pre-act
    lf = F.logsigmoid(xf @ p["wf"] + p["bf"])
    o = torch.sigmoid(x @ p["wo"])
    z = F.silu(x @ p["wz"])
    return q, k, v, li, lf, o, z


def mlstm_chunk(q, k, v, li, lf, state: State, chunk: int
                ) -> Tuple[torch.Tensor, State]:
    """Chunkwise-parallel mLSTM core.

    q/k/v [B, T, H, dh]; li/lf [B, T, H].  Returns (h [B, T, H, dh] f32,
    new state).  ``T`` must be a multiple of ``min(chunk, T)``."""
    B, T, H, dh = q.shape
    L = min(chunk, T)
    assert T % L == 0, (T, L)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for c0 in range(0, T, L):
        qf = q[:, c0:c0 + L].float()
        kf = k[:, c0:c0 + L].float()
        vf = v[:, c0:c0 + L].float()
        lib, lfb = li[:, c0:c0 + L], lf[:, c0:c0 + L]
        a = torch.cumsum(lfb, dim=1)                     # [B, L, H] inclusive
        A = a[:, -1]                                     # [B, H]
        # intra-chunk log weights S[b, h, i, j] = a_i - a_j + li_j (j <= i)
        S = a[:, :, None, :] - a[:, None, :, :] + lib[:, None, :, :]
        S = S.permute(0, 3, 1, 2)                        # [B, H, i, j]
        S = torch.where(tri, S, -math.inf)
        inter = m[:, :, None] + a.transpose(1, 2)        # [B, H, i]
        m_i = torch.maximum(S.amax(dim=-1), inter)
        m_i = torch.clamp(m_i, min=LOG_EPS)
        w_intra = torch.exp(S - m_i[..., None])          # [B, H, i, j]
        w_inter = torch.exp(inter - m_i)                 # [B, H, i]
        gram = torch.einsum("blhd,bjhd->bhlj", qf, kf)
        num = torch.einsum("bhij,bjhd->bihd", w_intra * gram, vf) \
            + torch.einsum("bhi,bhde,bihe->bihd", w_inter, C, qf)
        nvec = torch.einsum("bhij,bjhd->bihd", w_intra, kf) \
            + w_inter[..., None].transpose(1, 2) * n[:, None]
        qn = torch.einsum("bihd,bihd->bih", nvec, qf)    # [B, i, H]
        denom = torch.maximum(qn.abs(), torch.exp(-m_i).transpose(1, 2))
        hs.append(num / denom[..., None])                # [B, L, H, dh]

        # end-of-chunk state
        wj = (A[:, None] - a) + lib                      # [B, L, H]
        m_new = torch.maximum(m + A, wj.amax(dim=1))
        m_new = torch.clamp(m_new, min=LOG_EPS)
        carryw = torch.exp(m + A - m_new)                # [B, H]
        inpw = torch.exp(wj - m_new[:, None])            # [B, L, H]
        C = carryw[..., None, None] * C + \
            torch.einsum("blh,blhd,blhe->bhde", inpw, vf, kf)
        n = carryw[..., None] * n + torch.einsum("blh,blhd->bhd", inpw, kf)
        m = m_new
    return torch.cat(hs, dim=1), {"C": C, "n": n, "m": m}


def mlstm_recurrent_ref(q, k, v, li, lf, state: State
                        ) -> Tuple[torch.Tensor, State]:
    """Sequential recurrence, one token at a time (decode; the oracle of
    ``mlstm_chunk``).  Returns (h [B, T, H, dh] f32, new state)."""
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt = q[:, t].float(), k[:, t].float(), v[:, t].float()
        lit, lft = li[:, t], lf[:, t]                    # [B, H]
        m_new = torch.clamp(torch.maximum(lft + m, lit), min=LOG_EPS)
        fw = torch.exp(lft + m - m_new)
        iw = torch.exp(lit - m_new)
        C = fw[..., None, None] * C + iw[..., None, None] * \
            torch.einsum("bhd,bhe->bhde", vt, kt)
        n = fw[..., None] * n + iw[..., None] * kt
        qn = torch.einsum("bhd,bhd->bh", n, qt)
        denom = torch.maximum(qn.abs(), torch.exp(-m_new))
        hs.append(torch.einsum("bhde,bhe->bhd", C, qt) / denom[..., None])
        m = m_new
    return torch.stack(hs, dim=1), {"C": C, "n": n, "m": m}


def mlstm_apply(p: State, x: torch.Tensor, *, state: Optional[State] = None,
                mode: str = "full", chunk: int = 256, heads: int = 4
                ) -> Tuple[torch.Tensor, State]:
    """Full mLSTM block: gates, core, output gating, down projection.

    mode "full": x [B, T, D]; "step": the recurrence (decode).  Returns
    (y [B, T, D], new state)."""
    B, T, D = x.shape
    if state is None:
        state = init_mlstm_state(B, heads, D // heads, x.device)
    q, k, v, li, lf, o, z = _mlstm_gates(p, x)
    if mode == "step":
        h, new_state = mlstm_recurrent_ref(q, k, v, li, lf, state)
    else:
        h, new_state = mlstm_chunk(q, k, v, li, lf, state, chunk)
    h = h.reshape(B, T, D).to(x.dtype) * o
    return (h * z) @ p["wd"], new_state


# ===========================================================================
# sLSTM
# ===========================================================================

def init_slstm(gen: torch.Generator, d: int, heads: int, dtype) -> State:
    dh = d // heads
    dev = gen.device
    w = _dense_init(gen, (d, 4 * d), d, dtype)
    r = torch.randn((4, heads, dh, dh), generator=gen, device=dev,
                    dtype=f32) * (1.0 / math.sqrt(dh))
    b = torch.zeros((4 * d,), dtype=f32, device=dev)
    b[2 * d:3 * d] = 2.0                              # forget bias
    return {
        "w": w,                          # x -> (z, i, f, o) pre-activations
        "r": r,                          # recurrent, block-diagonal per head
        "b": b,
        "wo": _dense_init(gen, (d, d), d, dtype),
        "wd": _dense_init(gen, (d, d), d, dtype),
    }


def spec_slstm() -> Dict[str, tuple]:
    return {"w": (None, "tp"), "r": (None, None, None, None), "b": (None,),
            "wo": (None, "tp"), "wd": ("tp", None)}


def spec_slstm_state() -> Dict[str, tuple]:
    return {k: ("dp", "tp") for k in ("c", "n", "h", "m")}


def slstm_state_shape(batch: int, d: int
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    return {k: ((batch, d), f32) for k in ("c", "n", "h", "m")}


def init_slstm_state(batch: int, d: int, device) -> State:
    return {
        "c": torch.zeros((batch, d), dtype=f32, device=device),
        "n": torch.full((batch, d), 1e-6, dtype=f32, device=device),
        "h": torch.zeros((batch, d), dtype=f32, device=device),
        "m": torch.full((batch, d), LOG_EPS, dtype=f32, device=device),
    }


def slstm_apply(p: State, x: torch.Tensor, *, state: Optional[State] = None,
                heads: int = 4) -> Tuple[torch.Tensor, State]:
    """sLSTM block over x [B, T, D], sequential over T (a true
    recurrence); decode is T = 1."""
    B, T, D = x.shape
    dh = D // heads
    if state is None:
        state = init_slstm_state(B, D, x.device)
    pre = ((x @ p["w"]).float() + p["b"]).reshape(B, T, 4, D)
    r = p["r"]                                        # [4, H, dh, dh]
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for t in range(T):
        rec = torch.einsum("bhd,ghde->bghe", h.reshape(B, heads, dh),
                           r).reshape(B, 4, D)
        g = pre[:, t] + rec
        z = torch.tanh(g[:, 0])
        lf = F.logsigmoid(g[:, 2])
        o = torch.sigmoid(g[:, 3])
        ip = g[:, 1]
        m_new = torch.clamp(torch.maximum(lf + m, ip), min=LOG_EPS)
        fw = torch.exp(lf + m - m_new)
        iw = torch.exp(ip - m_new)
        c = fw * c + iw * z
        n = fw * n + iw
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)            # [B, T, D]
    y = torch.sigmoid(x @ p["wo"]) * y
    return y @ p["wd"], {"c": c, "n": n, "h": h, "m": m}


# ===========================================================================
# RG-LRU (Griffin / RecurrentGemma recurrent block)
# ===========================================================================

RGLRU_C = 8.0
CONV_WIDTH = 4


def init_rglru(gen: torch.Generator, d: int, d_rnn: int, dtype) -> State:
    dev = gen.device
    # Lambda so that a = exp(-8 softplus(lam) r) spans slow and fast decay
    u = torch.rand((d_rnn,), generator=gen, device=dev, dtype=f32) \
        * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))   # softplus^-1
    return {
        "w_in": _dense_init(gen, (d, d_rnn), d, dtype),
        "w_gate": _dense_init(gen, (d, d_rnn), d, dtype),
        "conv": (torch.randn((CONV_WIDTH, d_rnn), generator=gen, device=dev,
                             dtype=f32) * 0.1).to(dtype),
        "conv_b": torch.zeros((d_rnn,), dtype=dtype, device=dev),
        "w_r": _dense_init(gen, (d_rnn, d_rnn), d_rnn, dtype),
        "w_i": _dense_init(gen, (d_rnn, d_rnn), d_rnn, dtype),
        "b_r": torch.zeros((d_rnn,), dtype=f32, device=dev),
        "b_i": torch.zeros((d_rnn,), dtype=f32, device=dev),
        "lam": lam,
        "w_out": _dense_init(gen, (d_rnn, d), d_rnn, dtype),
    }


def spec_rglru() -> Dict[str, tuple]:
    return {
        "w_in": (None, "tp"), "w_gate": (None, "tp"),
        "conv": (None, "tp"), "conv_b": ("tp",),
        "w_r": (None, "tp"), "w_i": (None, "tp"),
        "b_r": ("tp",), "b_i": ("tp",), "lam": ("tp",),
        "w_out": ("tp", None),
    }


def spec_rglru_state() -> Dict[str, tuple]:
    return {"h": ("dp", "tp"), "conv": ("dp", None, "tp")}


def rglru_state_shape(batch: int, d_rnn: int
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    return {"h": ((batch, d_rnn), f32),
            "conv": ((batch, CONV_WIDTH - 1, d_rnn), f32)}


def init_rglru_state(batch: int, d_rnn: int, device) -> State:
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in rglru_state_shape(batch, d_rnn).items()}


def _causal_conv(xi: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, conv_state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution of width 4 over xi [B, T, d_rnn], the
    last three inputs of the previous call in ``conv_state``.  Returns
    (f32 output, new state)."""
    T = xi.shape[1]
    hist = torch.cat([conv_state, xi.float()], dim=1)
    out = torch.zeros_like(hist[:, :T])
    for w in range(CONV_WIDTH):
        out = out + hist[:, w:w + T] * conv_w[w].float()
    return out + conv_b.float(), hist[:, -(CONV_WIDTH - 1):]


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 with h_{-1} = 0, by doubling:
    after the step of offset ``s`` each (a_t, b_t) composes the elements
    ``(t - 2s, t]``; ``ceil(log2 T)`` steps in all."""
    T = a.shape[1]
    s = 1
    while s < T:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def rglru_apply(p: State, x: torch.Tensor, *, state: Optional[State] = None
                ) -> Tuple[torch.Tensor, State]:
    """Griffin recurrent block: x [B, T, D] -> (y [B, T, D], new state);
    a decode step is T = 1."""
    B, T, D = x.shape
    dr = p["w_in"].shape[1]
    if state is None:
        state = init_rglru_state(B, dr, x.device)
    gate = ACTS["gelu"]((x @ p["w_gate"]).float())
    xi, conv_state = _causal_conv(x @ p["w_in"], p["conv"], p["conv_b"],
                                  state["conv"])
    r = torch.sigmoid(xi @ p["w_r"].float() + p["b_r"])
    i = torch.sigmoid(xi @ p["w_i"].float() + p["b_i"])
    log_a = -RGLRU_C * F.softplus(p["lam"]) * r        # [B, T, dr]
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * xi)
    if T == 1:
        h = a[:, 0] * state["h"] + gated[:, 0]
        hs = h[:, None]
    else:
        # the carried state folds into the first step
        b0 = torch.cat([gated[:, :1] + a[:, :1] * state["h"][:, None],
                        gated[:, 1:]], dim=1)
        hs = linear_scan(a, b0)
        h = hs[:, -1]
    y = (hs * gate).to(x.dtype) @ p["w_out"]
    return y, {"h": h, "conv": conv_state}
