"""One run of one cell: set-up, the measured window, the check of what
the window produced, and the result line.

The window drives the program's serving entry, ``CascadeServer``: one
``Cascade`` registered per tenant, every document submitted through its
``QueryHandle``, ``step`` until the window closes.  The loop is closed: it
keeps a backlog of documents per tenant and submits a new one as each
resolves.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import guard
from .spec import Cell, reader
from ..traffic.generator import Doc, make_traffic


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class DocRec:
    doc: Doc
    fut: Any = None
    t_done: Optional[float] = None   # the harness's stamp after ``step``
    status: str = "pending"
    pred: Optional[int] = None
    conf: Optional[float] = None
    exit_stage: Optional[int] = None
    cost: float = 0.0


@dataclass
class Ctx:
    """What the metric readers and the check read after a run."""
    cell: Cell
    seed: int
    specs: Dict[str, dict]           # backend -> model spec ("port")
    stages: List[list]               # tenant -> reference stage table
    t_start: float
    t_open: float = 0.0
    t_close: float = 0.0
    step_s: float = 0.0              # time inside ``server.step`` (window)
    records: list = field(default_factory=list)   # window launch records
    new_tokens: int = 0
    cached_tokens: int = 0
    docs: List[DocRec] = field(default_factory=list)   # judged documents
    # traced runs only
    ops: Optional[list] = None       # device operations, host clock
    trace_from: float = 0.0          # the trace's open marker, host clock
    launches: Optional[list] = None  # launches dispatched in the window,
    #                                  with their documents
    unjoined: int = 0                # of those, launches without them

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open


def port_model(spec: dict, device):
    from repro_torch.config import ModelConfig, MoEConfig, resolve
    from repro_torch.models.model import LM
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in spec.items() if k in fields}
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    for k in ("block_pattern", "mrope_sections"):
        if kw.get(k) is not None:
            kw[k] = tuple(kw[k])
    return LM(resolve(ModelConfig(**kw), tp=1), device=device)


def cascade_of(stages: List[dict], never: bool = False):
    """The program's ``Cascade`` of a tenant's stages from the cell file;
    ``never``: with thresholds no answer meets."""
    from repro_torch.core.tasks import Cascade, Task, TaskConfig
    return Cascade([
        Task(TaskConfig(s["model"], s["op"], float(s["fraction"])),
             {c: 2.0 if never else t for c, t in enumerate(s["thresholds"])})
        for s in stages])


class Run:
    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device = trace, torch.device(device)
        cfg, serve = cell.config, cell.serve
        self.specs = {b: m["port"] for b, m in cfg["models"].items()}
        from ..reference.cascade import stage_table
        self.stages = [stage_table(t["stages"], serve["oracle_op"])
                       for t in serve["tenants"]]
        self.ctx = Ctx(cell, seed, self.specs, self.stages, t_start)
        self.recs: Dict[int, DocRec] = {}
        self.rid_doc: Dict[int, int] = {}
        self.check_imports = True

    # ---------------------------------------------------------- set-up
    def build(self, reuse: Optional["Run"] = None) -> None:
        """Models, weights and server, or ``reuse``'s (drained), then the
        tenants' queries and this seed's traffic."""
        if reuse is None:
            t = time.perf_counter()
            self.build_server()
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            log(f"set-up: models and weights {time.perf_counter() - t:.3f} s"
                f" ({time.perf_counter() - self.ctx.t_start:.3f} s since "
                f"the process began)")
        else:
            self.params, self.server = reuse.params, reuse.server
            self.rid_doc = {}
            self.rid_base = reuse.rid_base + len(reuse.rid_doc)
        serve = self.cell.serve
        self.handles = []
        for t in serve["tenants"]:
            self.handles.append(self.server.register(
                cascade_of(t["stages"]), oracle_op=serve["oracle_op"]))
        t = time.perf_counter()
        self.traffic = make_traffic(self.cell.traffic, self.seed,
                                    int(serve["docs"]), len(self.handles))
        log(f"set-up: {serve['docs']} documents made in "
            f"{time.perf_counter() - t:.3f} s")
        self.taken = [0] * len(self.handles)
        self.qids = {h.query_id for h in self.handles}
        self.draining = False
        self.warmed = reuse is not None

    def build_server(self) -> None:
        from repro_torch.data.tokenizer import HashWordTokenizer
        from repro_torch.serving import scheduler
        from repro_torch.serving.engine import CascadeServer, LMBackend
        cfg, serve = self.cell.config, self.cell.serve
        tok = HashWordTokenizer(vocab_size=cfg["tokenizer_vocab"])
        self.params, backends = {}, {}
        for name, m in cfg["models"].items():
            model = port_model(m["port"], self.device)
            self.params[name] = self.cell.family(name).make_params(
                m["port"], m["weight_seed"], self.device)
            backends[name] = LMBackend(
                name=name, model=model, params=self.params[name],
                tokenizer=tok, rate_per_token=cfg["rates_per_token"][name],
                cached_discount=cfg["cached_discount"],
                init_slots=serve["init_slots"][name], sanitize=False,
                device=self.device)
        self.server = CascadeServer(
            backends, dict(cfg["operations"]), n_classes=cfg["n_classes"],
            batch_size=serve["batch"], inflight=serve["inflight"],
            policy=getattr(scheduler, serve["policy"]), device=self.device)
        self.rid_base = 0

    def warm_signatures(self) -> None:
        """Launch every signature of the cell's traffic once before the
        loop starts: per tenant, a query with the tenant's stages and
        thresholds no answer meets, over one document of the mix's
        longest length in each bucket the mix reaches, drained."""
        from ..reference.cascade import bucket_len
        from ..traffic.generator import length_grid, make_text
        tr, serve = self.cell.traffic, self.cell.serve
        longest: Dict[int, int] = {}
        for n in length_grid(tr["length"], int(tr["block"])).tolist():
            b = bucket_len(n)
            longest[b] = max(longest.get(b, 0), n)
        rng = np.random.default_rng([abs(self.seed), 0x3A4])
        for t in serve["tenants"]:
            h = self.server.register(cascade_of(t["stages"], never=True),
                                     oracle_op=serve["oracle_op"])
            for i, n in enumerate(sorted(longest.values())):
                h.submit(i, make_text(rng, n, 0, 3, 0.0))
                self.rid_doc[self.rid_base + len(self.rid_doc)] = None
        while self.server.pending():
            self.server.step()

    def drain(self) -> None:
        """Step until every open document of this run has resolved."""
        self.draining = True
        while self.server.pending():
            self.step()

    # ------------------------------------------------------------ loop
    def submit(self, doc: Doc) -> None:
        rec = DocRec(doc)
        rec.fut = self.handles[doc.tenant].submit(doc.doc_id, doc.text)
        # the server numbers requests in submission order
        self.rid_doc[self.rid_base + len(self.rid_doc)] = doc.doc_id
        self.recs[doc.doc_id] = rec

    def top_up(self) -> None:
        """Keep ``backlog`` documents open per tenant."""
        want = int(self.cell.traffic["backlog_per_tenant"])
        for k, q in enumerate(self.traffic.docs):
            while self.open_docs[k] < want:
                if self.taken[k] == len(q):
                    self.traffic.more(len(self.traffic.docs) * 64)
                self.submit(q[self.taken[k]])
                self.taken[k] += 1
                self.open_docs[k] += 1

    def step(self) -> None:
        t = time.perf_counter()
        done = self.server.step()
        now = time.perf_counter()
        self.in_step += now - t
        mine = False
        for qid, ext in done:
            if qid not in self.qids:
                continue        # a query of an earlier run on this server
            mine = True
            rec = self.recs[ext]
            rec.t_done = now
            self.open_docs[rec.doc.tenant] -= 1
        if mine and not self.draining:
            self.top_up()

    def run_until(self, t_end: float) -> None:
        while time.perf_counter() < t_end and self.server.pending():
            self.step()

    def start_loop(self) -> None:
        self.in_step = 0.0
        self.t0 = time.perf_counter()
        self.open_docs = [0] * len(self.handles)
        self.top_up()

    # ----------------------------------------------------------- window
    def window(self) -> None:
        ctx, serve = self.ctx, self.cell.serve
        tm = self.server.telemetry
        if not self.warmed:
            self.warm_signatures()
        self.start_loop()
        self.run_until(self.t0 + float(serve["warm_seconds"]))
        if self.check_imports:
            guard.check("after set-up")
        dev_trace = None
        if self.trace:
            tm.level = "trace"
            if self.device.type == "cuda":
                from .trace import DeviceTrace
                dev_trace = DeviceTrace()
                dev_trace.open()
        tm.clear()
        before = self.server.stats()
        self.arena_before = {n: b.arena_nbytes()
                             for n, b in self.server.backends.items()}
        self.in_step = 0.0
        ctx.t_open = time.perf_counter()
        self.run_until(ctx.t_open + self.seconds)
        ctx.t_close = time.perf_counter()
        ctx.step_s = self.in_step
        ctx.records = [r for r in tm.launches.items() if r.ok]
        if dev_trace is not None:
            t = time.perf_counter()
            dev_trace.close()
            ctx.ops, ctx.trace_from = dev_trace.ops, dev_trace.marks[0]
            log(f"device trace: {len(ctx.ops)} device operations read in "
                f"{time.perf_counter() - t:.3f} s")
        after = self.server.stats()
        ctx.new_tokens = (sum(after.stage_new_tokens)
                          - sum(before.stage_new_tokens))
        ctx.cached_tokens = (sum(after.stage_cached_tokens)
                             - sum(before.stage_cached_tokens))
        self.evictions = after.evictions - before.evictions
        if self.trace:
            self.harvest()
            self.join_launches()
        self.collect()

    def harvest(self) -> None:
        """Traced runs, after the close: complete the launches still in
        flight then, oldest first, so that every launch dispatched in the
        window has its record.  The device trace holds all their work
        (it opens and closes on an idle device), and no more."""
        for _ in range(max(int(self.cell.serve["inflight"]), 1)):
            if not self.server.pending():
                return
            self.server.step()

    def collect(self) -> None:
        ctx = self.ctx
        for rec in self.recs.values():
            f = rec.fut
            rec.status = f.status
            if f.done and f.status == "resolved":
                rec.pred, rec.conf = f.pred, f.conf
                rec.exit_stage = f.exit_stage
            rec.cost = f.cost
            rec.fut = None
        ctx.docs = [r for r in self.recs.values()
                    if r.t_done is not None
                    and ctx.t_open < r.t_done <= ctx.t_close]

    def join_launches(self) -> None:
        """Traced runs: each launch dispatched in the window with its
        documents, from the launch records (completion order) and the
        spans' ``launch`` events, whose ``launch`` attribute counts
        completions."""
        tm = self.server.telemetry
        meta = getattr(tm, "_doc_meta", {})
        by_launch: Dict[int, list] = {}
        for rid, evs in tm.spans().items():
            ext = self.rid_doc.get(rid)
            if rid in meta and meta[rid][1] != ext:
                raise RuntimeError(f"request {rid}: spans name document "
                                   f"{meta[rid][1]}, submission order {ext}")
            if ext is None:
                continue        # a warm-up document
            for _ts, _rid, kind, attrs in evs:
                if kind == "launch":
                    by_launch.setdefault(attrs["launch"], []).append(
                        (ext, attrs["stage"]))
        ctx = self.ctx
        records = [r for r in tm.launches.items() if r.ok]
        base = min(by_launch) if by_launch else 0
        ctx.launches, ctx.unjoined = [], 0
        for j, rec in enumerate(records):
            if not ctx.t_open <= rec.ts_enqueue < ctx.t_close:
                continue
            docs = by_launch.get(base + j, [])
            if len(docs) != rec.batch:
                ctx.unjoined += 1
                continue
            ctx.launches.append({"rec": rec, "docs": [
                (self.recs[e].doc.n_tokens, self.recs[e].doc.tenant, s)
                for e, s in docs]})
        log(f"trace: {len(ctx.launches) + ctx.unjoined} launches dispatched "
            f"in the window, {ctx.unjoined} without their documents")

    # ---------------------------------------------------------- result
    def free_program(self) -> None:
        for be in self.server.backends.values():
            be.reset()
        self.server = self.handles = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def device_info(device: torch.device) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def metric_values(ctx: Ctx, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        v = reader(m["name"], ctx.cell.bench_dir)(ctx)
        if v is None:
            continue
        if not math.isfinite(v):
            raise ValueError(f"metric {m['name']} read {v}")
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, check_imports: bool = True
             ) -> Dict[str, Any]:
    """Run the cell once; returns the result object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``,
    ``checks``).  ``check_imports`` False skips the import guard (tests
    share a process with the JAX package's)."""
    from .check import judge
    os.environ.pop("ARENA_SANITIZE", None)
    run = Run(cell, seed, seconds, trace, device, t_start)
    run.check_imports = check_imports
    run.build()
    run.window()
    ctx = run.ctx
    dev = device_info(run.device)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    report_run(run)
    breakdown = None
    if ctx.ops is not None:
        from .trace import breakdown as bd, busy_seconds, gap_medians
        dev["busy_s"] = busy_seconds(ctx.ops, ctx.t_open, ctx.t_close)
        dev["window_s"] = ctx.window_s
        breakdown = bd(ctx.ops, ctx.t_open, ctx.t_close, ctx.records)
        for lab, (n, med) in sorted(gap_medians(
                ctx.ops, ctx.t_open, ctx.t_close, ctx.records).items()):
            log(f"idle gaps under {lab}: {n}, median {med * 1e3:.4f} ms")
    t = time.perf_counter()
    metrics = metric_values(ctx, cell.per_layer if trace
                            else cell.end_to_end)
    log(f"metrics read in {time.perf_counter() - t:.3f} s")
    run.free_program()
    t = time.perf_counter()
    checks = judge(ctx, run.params, run.cell)
    log(f"check against the reference: {time.perf_counter() - t:.3f} s")
    if check_imports:
        guard.check("at exit")
    resolved = sum(1 for r in ctx.docs if r.status == "resolved")
    out = {"correct": all(c["value"] <= c["limit"]
                          for c in checks.values()),
           "attempted": len(ctx.docs), "failed": len(ctx.docs) - resolved,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def report_run(run: Run) -> None:
    ctx = run.ctx
    recs = ctx.records
    n = len(ctx.docs)
    log(f"window {ctx.window_s:.3f} s: {len(recs)} launches, {n} documents "
        f"judged, evictions {run.evictions}, arena bytes "
        + ", ".join(f"{k} {run.arena_before[k]} -> {b.arena_nbytes()}"
                    for k, b in run.server.backends.items()))
    stages: Dict[int, int] = {}
    for r in ctx.docs:
        if r.exit_stage is not None:
            stages[r.exit_stage] = stages.get(r.exit_stage, 0) + 1
    log("exit stages " + ", ".join(f"{s}: {c}"
                                   for s, c in sorted(stages.items())))
    if run.device.type == "cuda":
        log(f"memory: peak {torch.cuda.max_memory_allocated()} B allocated "
            f"in the window, {torch.cuda.memory_reserved()} B reserved")
