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

Tensor parallelism (``mesh`` with a ``model`` axis of ``tp > 1``; the
parameters and the state this rank's shards of ``spec_*`` and
``spec_*_state``, as ``convert.shard_params`` cuts them), what GSPMD
makes of the reference's specs, in every mode (train, prefill, extend,
decode), through ``distributed.collectives``' differentiable exchanges:

* **mLSTM**: ``wq/wk/wv/wo/wz`` hold the rank's ``D / tp`` columns,
  ``wd`` its rows, ``wi/wf`` are whole; the state holds rows
  ``[j w, (j + 1) w)`` (``w = dh / tp``) of every head's ``C`` (its
  ``dv``) and the same entries of ``n`` (its ``dk``).  A head spans
  ranks (xlstm-350m: 4 heads of 256 over 16 ranks), so q, k and v are
  GATHERED over ``model`` (``gather_to_model``): the gram ``q k^T`` of a
  chunk is computed whole on every rank, the rank's rows of ``C`` and
  ``h`` from its slice of v; ``q . n`` is a sum over ``dk``, which the
  ranks hold in parts, so the partial sums are ALL-REDUCED over
  ``model``; the rank's rows of h are gathered again and the rank keeps
  its columns for the output gate and ``wd``'s row-parallel product
  (``reduce_from_model``).
* **sLSTM**: ``w`` holds the rank's ``4 D / tp`` columns of the four
  gates' pre-activations, which are gathered once a call (each rank then
  keeps its ``D / tp`` columns of every gate); ``r`` and ``b`` are
  whole; ``c, n, h, m`` hold the rank's ``D / tp`` columns.  The
  recurrent term needs the whole head of ``h``: where ``tp`` divides the
  heads a rank holds whole heads and the loop runs without a collective,
  else each token GATHERS ``h`` over ``model`` (one collective a token,
  the cost of the reference's layout; the backward reduce-scatters its
  gradient, one a token).  The loop is ``_SLSTMScan``: a forward over the
  tokens that keeps each token's inputs, and a backward over them in
  reverse that recomputes one token's cell at a time under autograd.
* **RG-LRU**: ``w_in, w_gate, conv, conv_b, b_r, b_i, lam`` and the state
  ``h, conv`` hold the rank's ``d_rnn / tp`` columns; ``w_r``/``w_i`` are
  column shards over the whole ``xi``, which is gathered; ``w_out`` is
  row-parallel (``reduce_from_model``).

On ``meta`` tensors (the dry-run) the sLSTM's loops run one token and,
where autograd records nothing, the mLSTM's loop one chunk, each counted
as many times as the loop is long (``kernels.meta.steps``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.collectives import (all_gather, copy_to_model,
                                       gather_to_model, reduce_from_model,
                                       reduce_scatter)
from ..distributed.compat import axis_group, axis_index, axis_names, \
    axis_size
from ..kernels import meta as kmeta
from .layers import ACTS, _dense_init

LOG_EPS = -30.0
State = Dict[str, torch.Tensor]
f32 = torch.float32


def _tp_size(mesh) -> int:
    """The ``model`` axis's size, 1 without a mesh or such an axis."""
    if mesh is None or "model" not in axis_names(mesh):
        return 1
    return axis_size(mesh, "model")


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


def mlstm_state_shape(batch: int, heads: int, dh: int, tp: int = 1
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The state's leaves, ``C``'s rows and ``n`` cut over ``tp`` ranks
    (``spec_mlstm_state``)."""
    return {"C": ((batch, heads, dh // tp, dh), f32),
            "n": ((batch, heads, dh // tp), f32),
            "m": ((batch, heads), f32)}


def init_mlstm_state(batch: int, heads: int, dh: int, device,
                     tp: int = 1) -> State:
    st = {k: torch.zeros(s, dtype=dt, device=device)
          for k, (s, dt) in mlstm_state_shape(batch, heads, dh, tp).items()}
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


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def mlstm_chunk(q, k, v, li, lf, state: State, chunk: int, *,
                dk: slice = slice(None), qn_sum=_identity
                ) -> Tuple[torch.Tensor, State]:
    """Chunkwise-parallel mLSTM core.

    q/k [B, T, H, dh]; v [B, T, H, dv] (the rows of ``C`` the state
    holds); li/lf [B, T, H].  ``n`` holds the entries ``dk`` of its last
    dimension and ``qn_sum`` completes the partial ``q . n`` (the
    tensor-parallel form's all-reduce).  Returns (h [B, T, H, dv] f32,
    new state).  ``T`` must be a multiple of ``min(chunk, T)``."""
    B, T, H, dh = q.shape
    L = min(chunk, T)
    assert T % L == 0, (T, L)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    # folded on ``meta`` (the dry-run) where autograd records nothing:
    # every chunk is the same ops at the same shapes
    with kmeta.steps(T // L, q, fold=not torch.is_grad_enabled()) as idx:
        for c0 in (i * L for i in idx):
            qf = q[:, c0:c0 + L].float()
            kf = k[:, c0:c0 + L].float()
            vf = v[:, c0:c0 + L].float()
            lib, lfb = li[:, c0:c0 + L], lf[:, c0:c0 + L]
            a = torch.cumsum(lfb, dim=1)                  # [B, L, H] inclusive
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
            nvec = torch.einsum("bhij,bjhd->bihd", w_intra, kf[..., dk]) \
                + w_inter[..., None].transpose(1, 2) * n[:, None]
            qn = qn_sum(torch.einsum("bihd,bihd->bih", nvec,
                                     qf[..., dk]))           # [B, i, H]
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
            n = carryw[..., None] * n + torch.einsum("blh,blhd->bhd", inpw,
                                                     kf[..., dk])
            m = m_new
    if len(hs) < T // L:
        # folded: the other chunks' h, allocated as the loop allocates
        # them (nothing computed, nothing counted)
        hs += [torch.empty_like(hs[0]) for _ in range(T // L - 1)]
    return torch.cat(hs, dim=1), {"C": C, "n": n, "m": m}


def mlstm_recurrent_ref(q, k, v, li, lf, state: State, *,
                        dk: slice = slice(None), qn_sum=_identity
                        ) -> Tuple[torch.Tensor, State]:
    """Sequential recurrence, one token at a time (decode; the oracle of
    ``mlstm_chunk``, whose ``dk``/``qn_sum`` it takes).  Returns (h [B,
    T, H, dv] f32, new state)."""
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
        n = fw[..., None] * n + iw[..., None] * kt[..., dk]
        qn = qn_sum(torch.einsum("bhd,bhd->bh", n, qt[..., dk]))
        denom = torch.maximum(qn.abs(), torch.exp(-m_new))
        hs.append(torch.einsum("bhde,bhe->bhd", C, qt) / denom[..., None])
        m = m_new
    return torch.stack(hs, dim=1), {"C": C, "n": n, "m": m}


def mlstm_apply(p: State, x: torch.Tensor, *, state: Optional[State] = None,
                mode: str = "full", chunk: int = 256, heads: int = 4,
                mesh=None) -> Tuple[torch.Tensor, State]:
    """Full mLSTM block: gates, core, output gating, down projection.

    mode "full": x [B, T, D]; "step": the recurrence (decode).  Returns
    (y [B, T, D], new state); tensor-parallel over ``mesh``'s ``model``
    axis (module docstring)."""
    B, T, D = x.shape
    if _tp_size(mesh) > 1:
        return _mlstm_apply_tp(p, x, state, mode, chunk, heads, mesh)
    if state is None:
        state = init_mlstm_state(B, heads, D // heads, x.device)
    q, k, v, li, lf, o, z = _mlstm_gates(p, x)
    if mode == "step":
        h, new_state = mlstm_recurrent_ref(q, k, v, li, lf, state)
    else:
        h, new_state = mlstm_chunk(q, k, v, li, lf, state, chunk)
    h = h.reshape(B, T, D).to(x.dtype) * o
    return (h * z) @ p["wd"], new_state


def _mlstm_apply_tp(p: State, x: torch.Tensor, state: Optional[State],
                    mode: str, chunk: int, heads: int, mesh
                    ) -> Tuple[torch.Tensor, State]:
    """``mlstm_apply`` over this rank's shards (module docstring)."""
    B, T, D = x.shape
    tp, j = axis_size(mesh, "model"), axis_index(mesh, "model")
    dh = D // heads
    w = dh // tp
    assert w * tp == dh, (dh, tp)
    own = slice(j * w, (j + 1) * w)
    if state is None:
        state = init_mlstm_state(B, heads, dh, x.device, tp)
    xl = copy_to_model(x, mesh)

    def whole(wt):
        return gather_to_model(xl @ wt, mesh, -1).reshape(B, T, heads, dh)

    q = whole(p["wq"])
    k = whole(p["wk"]) * (dh ** -0.5)
    v = whole(p["wv"])
    xf = x.float()
    li = copy_to_model(xf @ p["wi"] + p["bi"], mesh)
    lf = copy_to_model(F.logsigmoid(xf @ p["wf"] + p["bf"]), mesh)
    o = torch.sigmoid(xl @ p["wo"])
    z = F.silu(xl @ p["wz"])

    def qn_sum(t):
        return copy_to_model(reduce_from_model(t, mesh), mesh)

    if mode == "step":
        h, new_state = mlstm_recurrent_ref(q, k, v[..., own], li, lf, state,
                                           dk=own, qn_sum=qn_sum)
    else:
        h, new_state = mlstm_chunk(q, k, v[..., own], li, lf, state, chunk,
                                   dk=own, qn_sum=qn_sum)
    # every head's rows ``own`` -> the whole heads, of which the rank
    # keeps its columns of D
    h = gather_to_model(h, mesh, -1).reshape(B, T, D)
    cols = slice(j * (D // tp), (j + 1) * (D // tp))
    h = h[..., cols].to(x.dtype) * o
    return reduce_from_model((h * z) @ p["wd"], mesh), new_state


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


class _SLSTMLayout:
    """Where a rank's ``D / tp`` columns of the sLSTM state sit among the
    heads, and how the recurrent term reaches them (module docstring):
    with ``tp`` dividing the heads the rank holds whole heads; with
    ``tp`` a multiple of them a head spans ranks and each token gathers
    ``h``.  Without a mesh one rank holds everything."""

    def __init__(self, d: int, heads: int, mesh):
        tp = _tp_size(mesh)
        j = axis_index(mesh, "model") if tp > 1 else 0
        self.d, self.dh = d, d // heads
        self.width = d // tp
        self.cols = slice(j * self.width, (j + 1) * self.width)
        self.group = axis_group(mesh, "model") if tp > 1 else None
        self.gather = tp > heads
        if self.gather:
            assert tp % heads == 0, (tp, heads)
            hj, e0 = divmod(j * self.width, self.dh)
            self.heads = slice(hj, hj + 1)
            self.head_cols = slice(e0, e0 + self.width)
            self.in_cols = slice(hj * self.dh, (hj + 1) * self.dh)
        else:
            assert heads % tp == 0, (heads, tp)
            hp = heads // tp
            self.heads = slice(j * hp, (j + 1) * hp)
            self.head_cols = slice(None)

    def r_block(self, r: torch.Tensor) -> torch.Tensor:
        """The recurrent weights into this rank's columns [4, hp, dh,
        e]."""
        return r[:, self.heads, :, self.head_cols]

    def rec_input(self, h: torch.Tensor) -> torch.Tensor:
        """The rank's ``h`` [B, width] -> its heads' whole ``h`` [B, hp,
        dh] (gathered over ``model`` when a head spans ranks)."""
        if self.gather:
            h = all_gather(h, self.group, -1)[:, self.in_cols]
        return h.reshape(h.shape[0], -1, self.dh)

    def rec_input_grad(self, g: torch.Tensor) -> torch.Tensor:
        """The adjoint of ``rec_input``: [B, hp, dh] -> [B, width]."""
        g = g.reshape(g.shape[0], -1)
        if self.gather:
            full = g.new_zeros((g.shape[0], self.d))
            full[:, self.in_cols] = g
            g = reduce_scatter(full, self.group, -1)
        return g

    def rec(self, h_in: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """The recurrent term into the rank's columns [B, 4, width]."""
        return torch.einsum("bhd,ghde->bghe", h_in, r).reshape(
            h_in.shape[0], 4, self.width)


def _slstm_cell(g: torch.Tensor, c, n, m):
    """One token: gate pre-activations g [B, 4, width] (input plus
    recurrent) and the state -> the new (c, n, h, m)."""
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
    return c, n, h, m_new


def _slstm_forward(pre: torch.Tensor, r: torch.Tensor, state, lay,
                   save: bool):
    """The loop over tokens: pre [B, T, 4, width] f32 and the rank's
    block of ``r`` -> (each token's h [T, B, width], the last (c, n, h,
    m), and with ``save`` each token's inputs: its ``rec_input`` and the
    c, n, m it started from)."""
    B, T = pre.shape[:2]
    c, n, h, m = state
    hs = pre.new_empty((T, B, lay.width))
    saved = None
    if save:
        saved = (pre.new_empty((T, B, r.shape[1], lay.dh)),
                 *(pre.new_empty((T, B, lay.width)) for _ in range(3)))
    with kmeta.steps(T, pre) as ts:
        for t in ts:
            h_in = lay.rec_input(h)
            if save:
                for buf, val in zip(saved, (h_in, c, n, m)):
                    buf[t] = val
            c, n, h, m = _slstm_cell(pre[:, t] + lay.rec(h_in, r), c, n, m)
            hs[t] = h
    return hs, (c, n, h, m), saved


class _SLSTMScan(torch.autograd.Function):
    """``_slstm_forward`` with a backward through time: token by token in
    reverse, the cell recomputed from the token's saved inputs under
    autograd, its gradients carried to the token before it (through
    ``rec_input_grad``: a reduce-scatter a token where a head spans
    ranks).  Returns (hs, c, n, h, m)."""

    @staticmethod
    def forward(ctx, pre, r, c, n, h, m, lay):
        hs, last, saved = _slstm_forward(pre, r, (c, n, h, m), lay, True)
        ctx.lay = lay
        ctx.save_for_backward(pre, r, *saved)
        return (hs, *last)

    @staticmethod
    def backward(ctx, d_hs, dc, dn, dh, dm):
        pre, r, hin_buf, c_buf, n_buf, m_buf = ctx.saved_tensors
        lay = ctx.lay
        carry = [torch.zeros_like(c_buf[0]) if g is None else g
                 for g in (dc, dn, dh, dm)]
        if d_hs is None:
            d_hs = torch.zeros_like(c_buf)
        d_pre = torch.empty_like(pre)
        d_r = torch.zeros_like(r)
        with kmeta.steps(pre.shape[1], pre) as ts:
            for t in reversed(ts):
                with torch.enable_grad():
                    ins = [a.detach().requires_grad_(True) for a in (
                        pre[:, t], r, hin_buf[t], c_buf[t], n_buf[t],
                        m_buf[t])]
                    pt, rr, h_in, c, n, m = ins
                    outs = _slstm_cell(pt + lay.rec(h_in, rr), c, n, m)
                    dc, dn, dh, dm = carry
                    g = torch.autograd.grad(outs, ins,
                                            (dc, dn, dh + d_hs[t], dm))
                d_pre[:, t] = g[0]
                d_r += g[1]
                carry = [g[3], g[4], lay.rec_input_grad(g[2]), g[5]]
        return (d_pre, d_r, *carry, None)


def slstm_apply(p: State, x: torch.Tensor, *, state: Optional[State] = None,
                heads: int = 4, mesh=None) -> Tuple[torch.Tensor, State]:
    """sLSTM block over x [B, T, D], sequential over T (a true
    recurrence); decode is T = 1.  Tensor-parallel over ``mesh``'s
    ``model`` axis (module docstring)."""
    B, T, D = x.shape
    tp = _tp_size(mesh) > 1
    lay = _SLSTMLayout(D, heads, mesh if tp else None)
    if state is None:
        state = init_slstm_state(B, lay.width, x.device)
    if tp:
        xl = copy_to_model(x, mesh)
        pre = gather_to_model(xl @ p["w"], mesh, -1).reshape(
            B, T, 4, D)[..., lay.cols].float() \
            + copy_to_model(p["b"], mesh).reshape(4, D)[:, lay.cols]
        r = lay.r_block(copy_to_model(p["r"], mesh))
    else:
        xl = x
        pre = ((x @ p["w"]).float() + p["b"]).reshape(B, T, 4, D)
        r = lay.r_block(p["r"])
    st = (state["c"], state["n"], state["h"], state["m"])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (pre, r) + st):
        hs, *last = _SLSTMScan.apply(pre, r, *st, lay)
    else:
        hs, last, _ = _slstm_forward(pre, r, st, lay, False)
    c, n, h, m = last
    y = torch.sigmoid(xl @ p["wo"]) * hs.transpose(0, 1).to(x.dtype)
    y = y @ p["wd"]
    if tp:
        y = reduce_from_model(y, mesh)
    return y, {"c": c, "n": n, "h": h, "m": m}


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


def rglru_apply(p: State, x: torch.Tensor, *, state: Optional[State] = None,
                mesh=None) -> Tuple[torch.Tensor, State]:
    """Griffin recurrent block: x [B, T, D] -> (y [B, T, D], new state);
    a decode step is T = 1.  Tensor-parallel over ``mesh``'s ``model``
    axis (module docstring)."""
    B, T, D = x.shape
    tp = _tp_size(mesh) > 1
    x_in = copy_to_model(x, mesh) if tp else x
    dr = p["w_in"].shape[1]               # this rank's columns under TP
    if state is None:
        state = init_rglru_state(B, dr, x.device)
    gate = ACTS["gelu"]((x_in @ p["w_gate"]).float())
    xi, conv_state = _causal_conv(x_in @ p["w_in"], p["conv"], p["conv_b"],
                                  state["conv"])
    xr = gather_to_model(xi, mesh, -1) if tp else xi
    r = torch.sigmoid(xr @ p["w_r"].float() + p["b_r"])
    i = torch.sigmoid(xr @ p["w_i"].float() + p["b_i"])
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
    if tp:
        y = reduce_from_model(y, mesh)
    return y, {"h": h, "conv": conv_state}
