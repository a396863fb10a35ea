"""Three-term roofline of the dry-run's cells on NVIDIA cards, and the
device roof helpers that serving telemetry uses.

Terms per (arch x shape x mesh), seconds a step on one card:

    compute    = FLOPs a card    / dense tensor-core peak (f32 products
                                   over the f32 peak)
    memory     = bytes a card    / HBM bandwidth  (min of the analytic
                                   floor and the eager count)
    collective = sum over mesh axes of collective bytes on that axis
                 / that axis's link rate (NVLink within a pod, the
                 inter-node network for ``pod``)

The counts come from ``launch.dryrun``, which runs each cell's step
eagerly on ``meta`` stand-ins at one rank's shapes: every aten op's
FLOPs (``torch.utils.flop_counter``'s formulas) and operand and result
bytes, each hand-written kernel's own ``work``, and the ``c10d``
collectives with their process group's mesh axis.  Each rank runs the
same program, so these are per-card numbers.

The card's peaks come from one place: ``card_peaks`` reads the device
memory bandwidth from the card (``device_peak_bandwidth``) and the rest
from ``CARD_PEAKS``, keyed by ``torch.cuda.get_device_name``.
``analyze`` and ``main`` take the peaks as an argument, so they run
without a card.

MODEL_FLOPS uses the paper-standard 6*N_active*D (train) or 2*N_active*D
(serve) with N from the LOGICAL architecture (unpadded): the ratio
MODEL_FLOPS / counted FLOPs exposes padding, recomputation and
redundancy.
"""
from __future__ import annotations

import argparse
import functools
import json
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from ..config import ATTN_FULL, ATTN_LOCAL, ENC_ATTN, resolve, shape_config
from ..configs import cut_layers, get_config
from ..kernels.flash_attention import tile


@dataclass(frozen=True)
class Peaks:
    """One card's peak rates (dense, without sparsity)."""
    bf16_flops: float                # tensor cores, bf16 and fp16
    f32_flops: float                 # outside the tensor cores
    hbm_bytes_per_s: float
    nvlink_bytes_per_s: float        # each direction, to any card of the pod
    inter_node_bytes_per_s: float    # each direction, the hop between pods

    def link(self, axis: str) -> float:
        """Bytes/s of the links a mesh axis's collectives cross."""
        return self.inter_node_bytes_per_s if axis == "pod" \
            else self.nvlink_bytes_per_s


# name -> (bf16 FLOP/s, f32 FLOP/s, NVLink B/s a direction, inter-node B/s
# a direction).  NVIDIA's H100 data sheet (the SXM part, dense
# rates): 989 TFLOP/s bf16, 67 TFLOP/s f32, NVLink 4 at 900 GB/s both
# ways; a pod is a DGX H100 SuperPOD's NVLink Switch System (256 cards,
# each at its full NVLink rate to any other), and the hop between pods is
# the card's own ConnectX-7 port, NDR InfiniBand at 400 Gb/s.
CARD_PEAKS: Dict[str, tuple] = {
    "NVIDIA H100 80GB HBM3": (989e12, 67e12, 450e9, 50e9),
}


@functools.lru_cache(maxsize=None)
def device_peak_bandwidth(index: int = 0) -> Optional[float]:
    """Peak device-memory bandwidth of CUDA device ``index`` in bytes/s
    (``2 * memory_clock_rate * memory_bus_width / 8``: double data rate,
    bus width in bits), or ``None`` when no CUDA device is present."""
    if not torch.cuda.is_available():
        return None
    props = torch.cuda.get_device_properties(index)
    clock_khz = getattr(props, "memory_clock_rate", None)
    bus_bits = getattr(props, "memory_bus_width", None)
    if not clock_khz or not bus_bits:
        return None
    return 2.0 * clock_khz * 1e3 * bus_bits / 8.0


def peaks_for(name: str, hbm_bytes_per_s: float) -> Peaks:
    """The peaks of the card named ``name`` (``CARD_PEAKS``) with the
    given memory bandwidth; raises for a card the table lacks."""
    if name not in CARD_PEAKS:
        raise KeyError(f"no peaks for card {name!r}; known: "
                       f"{sorted(CARD_PEAKS)}")
    bf16, f32, nvlink, inter = CARD_PEAKS[name]
    return Peaks(bf16, f32, float(hbm_bytes_per_s), nvlink, inter)


@functools.lru_cache(maxsize=None)
def card_peaks(index: int = 0) -> Peaks:
    """The peaks of CUDA device ``index``: its memory bandwidth read from
    the card, the rest from ``CARD_PEAKS``.  Raises without a card, or
    for a card the table lacks."""
    bw = device_peak_bandwidth(index)
    if bw is None:
        raise RuntimeError("card_peaks: no CUDA device reports its memory "
                           "bandwidth")
    return peaks_for(torch.cuda.get_device_name(index), bw)


def bound_ms(nbytes: float, flops: float, peaks: Peaks,
             f32: bool = False):
    """(ms, "bytes" or "operations"): the least time the card could take
    for a call, the larger of bytes over the memory rate and operations
    over the peak rate of their type."""
    t_bytes = nbytes / peaks.hbm_bytes_per_s * 1e3
    t_ops = flops / (peaks.f32_flops if f32 else peaks.bf16_flops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_launch_bytes(params_bytes: float, kv_bytes_per_step: float,
                        steps: int = 1) -> float:
    """Structural device-memory traffic of a decode-only serving launch.

    A decode step is memory-bound: each generated token streams the full
    parameter set plus the batch's live KV prefix.  ``steps`` is the
    op-suffix length (one readout per suffix token).  Activations and the
    O(B) token writes are negligible against these two terms.
    """
    return steps * (float(params_bytes) + float(kv_bytes_per_step))


def bandwidth_utilization(bytes_moved: float, seconds: float,
                          bw: Optional[float] = None) -> Optional[float]:
    """Fraction of the device-memory roof a measured transfer achieved,
    or ``None`` when there is no device roof to compare with (CPU).
    ``bw`` overrides the roof read from the device."""
    if bw is None:
        bw = device_peak_bandwidth()
    if bw is None:
        return None
    if seconds <= 0.0:
        return 0.0
    return (float(bytes_moved) / float(seconds)) / bw


def overlap_hidden_fraction(hidden_s: float, exposed_s: float) -> float:
    """Fraction of device time hidden behind host work by ahead-of-time
    dispatch: ``hidden / (hidden + exposed)``.

    ``hidden_s`` is the summed in-flight window (dispatch returned, sync
    not yet entered) and ``exposed_s`` the summed completion waits the
    host actually paid.  0.0 at ``inflight=1`` (nothing overlaps), -> 1.0
    when completion never blocks.  Returns 0.0 when both terms are ~0."""
    total = float(hidden_s) + float(exposed_s)
    if total <= 0.0:
        return 0.0
    return float(hidden_s) / total


def logical_param_counts(arch: str, n_rep: Optional[int] = None
                         ) -> Dict[str, float]:
    """(total, active) parameter counts from the UNPADDED architecture."""
    cfg = cut_layers(get_config(arch), n_rep)
    rcfg = resolve(cfg, tp=1)
    total = float(rcfg.param_count())
    active = float(rcfg.active_param_count())
    if cfg.family in ("ssm",):
        # xLSTM blocks: ~10 d^2 per mLSTM block, ~10 d^2 per sLSTM block
        d, l, v = cfg.d_model, cfg.num_layers, cfg.vocab_size
        total = active = l * 10 * d * d + v * d
    if cfg.family == "hybrid":
        d, l, v = cfg.d_model, cfg.num_layers, cfg.vocab_size
        n_rec = sum(1 for k in cfg.layer_kinds() if k == "rglru")
        n_att = cfg.num_layers - n_rec
        rec = 6 * d * d                      # in/gate/out + lru gates
        att = d * (cfg.num_heads + 2 * cfg.num_kv_heads
                   + cfg.num_heads) * (cfg.head_dim or d // cfg.num_heads)
        mlp = 3 * d * cfg.d_ff
        total = active = n_rec * (rec + mlp) + n_att * (att + mlp) + v * d
    return {"total": total, "active": active}


def model_flops(arch: str, shape_name: str, n_rep: Optional[int] = None,
                batch: Optional[int] = None) -> float:
    """6 (train) or 2 x active parameters x tokens; ``batch`` replaces
    the shape's global batch."""
    sh = shape_config(shape_name, batch)
    n = logical_param_counts(arch, n_rep)["active"]
    cfg = get_config(arch)
    tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
    mult = 6.0 if sh.kind == "train" else 2.0
    flops = mult * n * tokens
    if cfg.family == "audio" and sh.kind != "decode":
        # encoder pass (6 layers over encoder_seq_len frames)
        enc_n = logical_param_counts(arch, n_rep)["total"] * 0.45
        flops += mult * enc_n * sh.global_batch * cfg.encoder_seq_len
    return flops


def analytic_memory_floor(arch: str, shape_name: str, devices: int, *,
                          tp: int = 16, block_q: Optional[int] = None,
                          block_kv: Optional[int] = None,
                          n_rep: Optional[int] = None,
                          batch: Optional[int] = None) -> float:
    """Device-memory bytes a card must move in one step, at the least.

    Counts what a fused lowering must move over a ``devices // tp`` x
    ``tp`` mesh:

      params      1x read (serve) / 3x (train: fwd + bwd re-read + dW)
      activations C x B_loc*S*d*L*2B (C~4 serve, ~8 train with remat)
      KV cache    write once (prefill) / read once + slot write (decode)
      logits      ~3x B_loc*S*V_loc (train xent) / tiny at serve
      attention   K/V re-read once a query tile: ``block_q`` x
                  ``block_kv`` tiles (the tensor-core tile of
                  ``csrc/flash_attention.cu`` at the model's head_dim
                  when not given)

    With ``tp=16`` and 512-row tiles this is the JAX package's floor;
    ``n_rep`` cuts the depth and ``batch`` the global batch.
    """
    cfg = cut_layers(get_config(arch), n_rep)
    sh = shape_config(shape_name, batch)
    rcfg = resolve(cfg, tp=tp)
    dp = max(devices // tp, 1)
    b_loc = max(sh.global_batch // dp, 1)
    d, L = cfg.d_model, cfg.num_layers
    dh, hq, hkv = rcfg.head_dim, rcfg.padded_heads, rcfg.padded_kv_heads
    kv_chip = max(hkv // tp, 1) if hkv >= tp else hkv
    S = sh.seq_len
    params_bytes = 2.0 * rcfg.param_count() / tp
    if cfg.moe is not None:
        # experts sharded over data under EP; dense-TP keeps all per chip
        if cfg.moe.strategy == "ep_a2a":
            params_bytes = 2.0 * (rcfg.active_param_count() / tp
                                  + (rcfg.param_count()
                                     - rcfg.active_param_count()) / devices)
    kinds = cfg.layer_kinds()
    tq, tkv = tile(dh)
    bq = block_q or tq
    bkv = block_kv or tkv

    def attn_kv_io(seq_q: int) -> float:
        """K/V re-reads a card (prefill/train): each query tile reads
        the key tiles it sees."""
        total = 0.0
        for kind in kinds:
            if kind not in (ATTN_FULL, ATTN_LOCAL, ENC_ATTN):
                continue
            nq = max(seq_q // bq, 1)
            if kind == ATTN_LOCAL:
                per_q = min(cfg.sliding_window // bkv + 2, nq)
                pairs = nq * per_q
            else:
                pairs = nq * (nq + 1) // 2
            total += pairs * 2 * bkv * dh * 2.0 * b_loc * max(hq // tp, 1)
        return total

    if sh.kind == "train":
        act = 8.0 * L * b_loc * S * d * 2.0
        logits = 3.0 * b_loc * S * (rcfg.padded_vocab / tp) * 2.0
        if cfg.moe is not None:
            act *= (1 + cfg.moe.top_k * cfg.moe.capacity_factor)
        return 3.0 * params_bytes + act + logits + 3.5 * attn_kv_io(S)
    if sh.kind == "prefill":
        act = 4.0 * L * b_loc * S * d * 2.0
        kv_write = sum(
            2.0 * b_loc * (min(cfg.sliding_window, S)
                           if k == ATTN_LOCAL else S) * kv_chip * dh * 2.0
            for k in kinds if k in (ATTN_FULL, ATTN_LOCAL, ENC_ATTN))
        return params_bytes + act + kv_write + attn_kv_io(S)
    # decode: weights + full KV read per token
    kv_read = 0.0
    for k in kinds:
        if k == ATTN_LOCAL:
            s_here = min(cfg.sliding_window, S)
            kv_read += 2.0 * b_loc * s_here * kv_chip * dh * 2.0
        elif k in (ATTN_FULL, ENC_ATTN):
            s_here = S // dp if sh.global_batch < dp else S
            kv_read += 2.0 * b_loc * s_here * kv_chip * dh * 2.0
    return params_bytes + kv_read + 6.0 * L * b_loc * d * 2.0


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float            # min(analytic floor, eager count)
    memory_eager_s: float      # every op's operand and result bytes
    collective_s: float
    dominant: str
    model_flops: float
    flops_global: float
    useful_ratio: float
    bound_step_s: float
    roofline_frac: float       # max-term / sum-of-terms lower bound quality
    note: str = ""

    def table_row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{self.compute_s:.2e} | {self.memory_s:.2e} | "
                f"{self.memory_eager_s:.2e} | {self.collective_s:.2e} | "
                f"**{self.dominant}** | "
                f"{self.useful_ratio:.2f} | {self.roofline_frac:.2f} |")


SUGGESTIONS = {
    "compute": ("compute-bound: keep the tensor cores fed: bf16 products "
                "in wgmma-sized tiles, fewer padded heads, less "
                "recomputation"),
    "memory": ("HBM-bound: move fewer bytes: fuse the elementwise chains, "
               "the softmax and the cross-entropy, keep intermediates out "
               "of HBM, or shard or quantize the dominant resident tensor"),
    "collective": ("link-bound (NVLink in a pod, the inter-node network "
                   "between pods): reshard to cut the dominant collective, "
                   "overlap it with compute, or compress the payload"),
}


def analyze(result: Dict, peaks: Peaks) -> Optional[RooflineRow]:
    """One dry-run result (``launch.dryrun.run_one``'s JSON) at the given
    peaks, or None for a cell that failed."""
    if not result.get("ok"):
        return None
    chips = result["devices"]
    flops_pc = result["flops"]                       # per card (SPMD program)
    flops_f32 = result.get("flops_f32", 0.0)
    bytes_pc = result["bytes_accessed"]
    compute_s = ((flops_pc - flops_f32) / peaks.bf16_flops
                 + flops_f32 / peaks.f32_flops)
    memory_eager_s = bytes_pc / peaks.hbm_bytes_per_s
    floor_bytes = analytic_memory_floor(
        result["arch"], result["shape"], chips, tp=result.get("tp", 16),
        n_rep=result.get("n_rep"), batch=result.get("batch"))
    memory_s = min(max(floor_bytes / peaks.hbm_bytes_per_s, 0.0),
                   memory_eager_s)
    by_axis = result.get("collective_bytes_by_axis")
    if by_axis is None:          # no axis recorded: all over NVLink
        by_axis = {"": result.get("collective_bytes", {})}
    collective_s = sum(float(sum(kinds.values())) / peaks.link(axis)
                       for axis, kinds in by_axis.items())
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(result["arch"], result["shape"], result.get("n_rep"),
                     result.get("batch"))
    flops_global = flops_pc * chips
    useful = mf / flops_global if flops_global else 0.0
    bound = max(terms.values())
    total = sum(terms.values())
    # roofline fraction: how close the binding term is to owning the step
    # (1.0 = perfectly overlapped single-bottleneck execution)
    frac = bound / total if total else 0.0
    return RooflineRow(
        arch=result["arch"], shape=result["shape"], mesh=result["mesh"],
        compute_s=compute_s, memory_s=memory_s,
        memory_eager_s=memory_eager_s, collective_s=collective_s,
        dominant=dominant, model_flops=mf, flops_global=flops_global,
        useful_ratio=useful, bound_step_s=bound, roofline_frac=frac,
        note=SUGGESTIONS[dominant])


HEADER = """| arch | shape | mesh | compute (s) | memory floor (s) | memory eager (s) | collective (s) | bottleneck | useful FLOP ratio | overlap-quality |
|------|-------|------|-------------|------------------|------------------|----------------|------------|-------------------|-----------------|"""


def report(results: Sequence[Dict], peaks: Peaks) -> str:
    """The roofline table of dry-run results (FAILED rows name their
    error) and one line of detail a cell."""
    lines = [HEADER]
    details = []
    for r in results:
        row = analyze(r, peaks)
        if row is None:
            err = str(r.get("error", "")).strip().splitlines()
            why = err[-1][:160].replace("|", "/") if err else ""
            lines.append(f"| {r.get('arch')} | {r.get('shape')} | "
                         f"{r.get('mesh')} | FAILED: {why} | | | | | | |")
            continue
        lines.append(row.table_row())
        details.append(
            f"- **{row.arch} x {row.shape} ({row.mesh})**: dominant "
            f"{row.dominant} ({row.bound_step_s:.2e} s); MODEL_FLOPS "
            f"{row.model_flops:.2e}, counted {row.flops_global:.2e} "
            f"(useful ratio {row.useful_ratio:.2f}). {row.note}")
    return "\n".join(lines) + "\n\n" + "\n".join(details) + "\n"


def main(argv: Optional[Sequence[str]] = None,
         peaks: Optional[Peaks] = None) -> str:
    """``python -m repro_torch.launch.roofline --results r.json [--out
    table.md] [--card NAME --hbm BYTES_PER_S]``: the roofline table of a
    dry-run's results at the peaks of the card this runs on, or of the
    card named by ``--card`` at the memory rate ``--hbm``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--card", default=None,
                    help="a CARD_PEAKS name, to analyze without that card")
    ap.add_argument("--hbm", type=float, default=None,
                    help="device memory bytes/s of --card")
    args = ap.parse_args(argv)
    if peaks is None:
        if args.card is not None:
            if args.hbm is None:
                ap.error("--card needs --hbm")
            peaks = peaks_for(args.card, args.hbm)
        else:
            peaks = card_peaks()
    with open(args.results) as f:
        results = json.load(f)
    if isinstance(results, dict):
        results = [results]
    text = report(results, peaks)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return text


if __name__ == "__main__":
    main()
