"""Dry-run of every (arch x shape x mesh) cell at one card's shapes.

    python -m repro_torch.launch.dryrun --arch llama3_2_1b --shape decode_32k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh both] [--out results.json]

Each cell joins a fake ``torch.distributed`` world of the mesh's size as
rank 0 (the ``fake`` backend: collectives return at once and move
nothing), builds the production mesh over it (16 x 16 ``data`` x
``model``; 2 x 16 x 16 with ``pod`` for ``multi``; ``one`` is a 1 x 1
mesh, one card), builds ``launch.specs.build_case`` on the ``meta``
device and runs the step on its stand-ins, eagerly, under a counting
dispatch mode (``StepCounter``):

- FLOPs: ``torch.utils.flop_counter``'s formulas of every aten op, plus
  each hand-written kernel's own ``work`` (``kernels.meta``: on
  ``meta`` tensors ``kernels.ops`` reports the kernel's work instead of
  running its plain version).  ``flops_f32`` is the part computed on
  f32 inputs.
- Bytes: the operand and result bytes of every aten op, views and
  allocations excluded; an operand the op writes counts once, at most
  the size of the largest other operand (a scatter writes what it is
  given).  The kernels' bytes are their ``work``.
- Collective bytes, per kind and per mesh axis: the ``c10d`` ops, their
  operand plus output bytes (an all-reduce counts twice its payload, as
  the JAX package's HLO count does), the axis from their process group.
- Memory: ``argument_bytes`` (this rank's parameters, moments, batch or
  states), ``output_bytes`` (results that alias no argument) and
  ``temp_bytes``, the peak of the bytes allocated during the step and
  still alive (results included).

The step is eager, so a full-depth count is exact; ``--n-rep R`` counts
the model cut to R repetitions of its block pattern (a speed option:
each repetition adds the same counts, so R = 1 and R = 2 extrapolate to
the full depth), and ``--batch B`` cuts the shape's global batch to B (a
cell run on one card, where the full batch does not fit).

A cell whose step raises is ``ok: false`` with the exception's type and
message in ``error`` (and the end of its ``traceback``).  ``--all`` (only the cells of the comma lists
``--arch``/``--shape`` when given) runs each cell in a process of its own with a timeout, forked
from a ``forkserver`` that has imported this module once (a fresh
interpreter a cell spent most of its time importing torch), and writes
the list of results that ``launch.roofline`` reads.  The default process
group stays in the process that joined it: callers that must not keep
one (tests, the smoke run) run this module as a subprocess.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..config import SHAPES
from ..configs import ARCHS, get_config
from ..kernels import meta as kmeta
from .mesh import make_production_mesh


def mesh_layout(mesh_kind: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The axis sizes and names of a cell's mesh: the production mesh
    for ``single``/``multi``, one card for ``one``."""
    if mesh_kind == "one":
        return (1, 1), ("data", "model")
    m = make_production_mesh(multi_pod=mesh_kind == "multi")
    return m.shape, m.mesh_dim_names


# c10d op name (its overload packet's, without underscores) -> kind
COLLECTIVE_KINDS = (
    ("allreduce", "all-reduce"), ("allgather", "all-gather"),
    ("reducescatter", "reduce-scatter"), ("alltoall", "all-to-all"),
    ("broadcast", "broadcast"), ("send", "collective-permute"),
    ("recv", "collective-permute"),
)
# kinds whose output is their operand: operand + output is twice it
_IN_PLACE_KINDS = ("all-reduce", "broadcast")
# allocations, which move no bytes (their memory is tracked)
_ALLOCATIONS = ("empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided")


def collective_kind(op_name: str) -> Optional[str]:
    """The kind of a ``c10d`` op (``allreduce_`` -> ``all-reduce``), or
    None for one that moves no data (``barrier``)."""
    key = op_name.replace("_", "").replace("base", "")
    for frag, kind in COLLECTIVE_KINDS:
        if key.startswith(frag):
            return kind
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class StepCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and live memory of what runs
    inside it (see the module docstring).  ``axis_of_group`` maps a
    process group's name to its mesh axis; ``arguments`` are the step's
    inputs, which are neither allocations nor results."""

    def __init__(self, axis_of_group: Dict[str, str], arguments: Any):
        super().__init__()
        self.axis_of_group = axis_of_group
        self.flops = 0.0
        self.flops_f32 = 0.0
        self.bytes = 0.0
        self.collective: Dict[str, int] = {}
        self.collective_by_axis: Dict[str, Dict[str, int]] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._tracked: Dict[int, int] = {}
        self._holders: Dict[int, int] = {}
        self._args = {_storage_key(t): _nbytes(t)
                      for t in _tensors(arguments)}

    @property
    def argument_bytes(self) -> int:
        return sum(self._args.values())

    # -------------------------------------------------------------- memory
    # A storage is live while any tensor an op returned over it is: views,
    # and ops such as ``_unsafe_view`` that share a storage without a
    # view's link to its base, each hold it.
    def _release(self, key: int) -> None:
        self._holders[key] -= 1
        if not self._holders[key]:
            del self._holders[key]
            self.live -= self._tracked.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._args:
            return
        if key not in self._tracked:
            n = t.untyped_storage().nbytes()
            self._tracked[key] = n
            self._holders[key] = 0
            self.live += n
            self.peak = max(self.peak, self.live)
        self._holders[key] += 1
        weakref.finalize(t, self._release, key)

    # ----------------------------------------------------------- counting
    def kernel(self, name: str, nbytes: float, flops: float,
               dtype: torch.dtype) -> None:
        """``kernels.meta`` observer: one hand-written kernel's call."""
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0.0,
                                           "flops": 0.0})
        k["calls"] += 1
        k["bytes"] += nbytes
        k["flops"] += flops
        self.bytes += nbytes
        self.flops += flops
        if dtype == torch.float32:
            self.flops_f32 += flops

    def _collective(self, func, args, kwargs) -> None:
        kind = collective_kind(func.__name__.split(".")[0])
        if kind is None:
            return
        seen = {id(t): _nbytes(t) for t in _tensors((args, kwargs))}
        n = sum(seen.values()) * (2 if kind in _IN_PLACE_KINDS else 1)
        axis = "other"
        for a in tree_flatten((args, kwargs))[0]:
            if isinstance(a, torch.ScriptObject) and \
                    "ProcessGroup" in str(a._type()):
                name = dist.ProcessGroup.unbox(a).group_name
                axis = self.axis_of_group.get(name, "other")
        self.collective[kind] = self.collective.get(kind, 0) + n
        per = self.collective_by_axis.setdefault(axis, {})
        per[kind] = per.get(kind, 0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if func.namespace == "c10d":
            self._collective(func, args, kwargs)
            return out
        outs = _tensors(out)
        for t in outs:
            if t.device.type == "meta":
                self._track(t)
        packet = func.overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            ins = _tensors((args, kwargs))
            if ins and ins[0].dtype == torch.float32:
                self.flops_f32 += f
        if func.is_view or packet.__name__ in _ALLOCATIONS:
            return out
        self.bytes += self._op_bytes(func, args, kwargs, outs)
        return out

    @staticmethod
    def _op_bytes(func, args, kwargs, outs) -> float:
        written = set()
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                written.update(id(t) for t in _tensors(v))
        ins = {id(t): t for t in _tensors((args, kwargs))}
        read = [t for k, t in ins.items() if k not in written]
        big = max((_nbytes(t) for t in read), default=None)
        n = float(sum(_nbytes(t) for t in read))
        for k in written:
            if k in ins:
                w = _nbytes(ins[k])
                n += w if big is None else min(w, big)
        in_keys = {_storage_key(t) for t in ins.values()}
        n += sum(_nbytes(t) for t in outs if _storage_key(t) not in in_keys)
        return n


def join_fake_world(world: int) -> None:
    """Join a ``fake`` process group of ``world`` ranks as rank 0 (once
    a process)."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a world of {dist.get_world_size()} is "
                               f"already joined, not {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_cell_mesh(mesh_kind: str):
    """The cell's ``DeviceMesh`` over a fake world of its size."""
    from ..distributed.compat import make_mesh
    shape, axes = mesh_layout(mesh_kind)
    n = 1
    for s in shape:
        n *= s
    join_fake_world(n)
    return make_mesh(shape, axes, "cpu")


def count_case(case, mesh) -> Dict[str, Any]:
    """Run one ``DryRunCase`` on its meta stand-ins under a
    ``StepCounter``; the counts in the JSON shape ``run_one`` writes."""
    axis_of_group = {mesh.get_group(a).group_name: a
                     for a in mesh.mesh_dim_names}
    counter = StepCounter(axis_of_group, case.args)
    train = "train" in case.name
    t0 = time.perf_counter()
    with (torch.enable_grad() if train else torch.no_grad()), \
            kmeta.observe(counter.kernel), counter:
        out = case.fn(*case.args)
    outs = {_storage_key(t): _nbytes(t) for t in _tensors(out)
            if _storage_key(t) not in counter._args}
    return {
        "count_s": round(time.perf_counter() - t0, 2),
        "ops": counter.ops,
        "flops": counter.flops,
        "flops_f32": counter.flops_f32,
        "bytes_accessed": counter.bytes,
        "collective_bytes": dict(counter.collective),
        "collective_bytes_by_axis": {a: dict(k) for a, k in
                                     counter.collective_by_axis.items()},
        "kernels": counter.kernels,
        "memory": {"argument_bytes": counter.argument_bytes,
                   "output_bytes": sum(outs.values()),
                   "temp_bytes": counter.peak},
    }


def run_one(arch: str, shape: str, mesh_kind: str,
            n_rep_override: Optional[int] = None,
            batch_override: Optional[int] = None) -> Dict[str, Any]:
    """Count one cell (see the module docstring).  Joins the fake world
    of the mesh's size in this process."""
    from .specs import build_case
    dims, axes = mesh_layout(mesh_kind)
    n_dev = 1
    for s in dims:
        n_dev *= s
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "devices": n_dev,
        "tp": dict(zip(axes, dims))["model"], "ok": True}
    if n_rep_override is not None:
        result["n_rep"] = n_rep_override
    if batch_override is not None:
        result["batch"] = batch_override
    try:
        mesh = make_cell_mesh(mesh_kind)
        result.update(count_case(build_case(
            arch, shape, mesh, n_rep_override=n_rep_override,
            device="meta", batch_override=batch_override), mesh))
    except Exception as e:     # a cell that fails is a result, not a crash
        result.update(ok=False, error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    return result


def supported_cells() -> List[Tuple[str, str]]:
    return [(arch, shape) for arch in ARCHS
            for shape in get_config(arch).supported_shapes]


def _cell_main(arch: str, shape: str, mesh_kind: str, out: str,
               n_rep: Optional[int], batch: Optional[int]) -> None:
    """One cell in a worker process: its result into the file ``out``."""
    res = run_one(arch, shape, mesh_kind, n_rep_override=n_rep,
                  batch_override=batch)
    with open(out, "w") as f:
        json.dump(res, f)


def run_subprocesses(cells: Sequence[Tuple[str, str, str]], jobs: int,
                     timeout: float, partial_out: Optional[str] = None,
                     n_rep: Optional[int] = None,
                     batch: Optional[int] = None) -> List[Dict[str, Any]]:
    """Run each cell in a process of its own, forked from a
    ``forkserver`` that has imported this module, at most ``jobs`` at
    once, each killed after ``timeout`` s; collect their results in the
    order of ``cells``.  The server ends with this process."""
    from concurrent.futures import ThreadPoolExecutor

    # this module by its package name (``__main__`` under ``python -m``),
    # so the workers find ``_cell_main``
    from . import dryrun as this
    ctx = multiprocessing.get_context("forkserver")
    # what every cell imports: the fake backend, the mesh (DTensor's op
    # tables) and the fake tensors that draw the parameter shapes
    ctx.set_forkserver_preload([
        this.__name__, f"{this.__package__}.specs",
        "torch.testing._internal.distributed.fake_pg",
        "torch.distributed.tensor", "torch._subclasses.fake_tensor",
        "torch.fx.experimental.symbolic_shapes"])

    def run_cell(cell):
        arch, shape, mk = cell
        fd, out = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        t0 = time.time()
        proc = ctx.Process(target=this._cell_main,
                           args=(arch, shape, mk, out, n_rep, batch),
                           daemon=True)
        try:
            proc.start()
            proc.join(timeout)
            if proc.is_alive():
                proc.kill()
                proc.join()
                r = {"arch": arch, "shape": shape, "mesh": mk, "ok": False,
                     "error": f"TimeoutExpired: no result after {timeout} s"}
            else:
                try:
                    with open(out) as f:
                        r = json.load(f)
                except ValueError:
                    r = {"arch": arch, "shape": shape, "mesh": mk,
                         "ok": False, "error": f"ChildProcessError: exit "
                         f"code {proc.exitcode}, no result"}
        finally:
            os.unlink(out)
        status = "OK " if r.get("ok") else "FAIL"
        print(f"[{status}] {arch:20s} {shape:12s} {mk:6s} "
              f"({time.time() - t0:.1f}s)", flush=True)
        return r

    results = []
    with ThreadPoolExecutor(max_workers=jobs) as ex:
        for r in ex.map(run_cell, cells):
            results.append(r)
            if partial_out:        # incremental flush
                with open(partial_out, "w") as f:
                    json.dump(results, f, indent=1)
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="the cell's arch (with --all: a comma list of "
                    "the archs whose cells run)")
    ap.add_argument("--shape", default=None,
                    help="the cell's shape (with --all: a comma list)")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "one"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--n-rep", type=int, default=None,
                    help="count the model cut to this many repetitions")
    ap.add_argument("--batch", type=int, default=None,
                    help="count the shape's global batch cut to this")
    args = ap.parse_args(argv)

    if args.all:
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        archs = args.arch.split(",") if args.arch else None
        shapes = args.shape.split(",") if args.shape else None
        cells = [(arch, shape, mk) for arch, shape in supported_cells()
                 if (archs is None or arch in archs)
                 and (shapes is None or shape in shapes) for mk in meshes]
        results = run_subprocesses(cells, args.jobs, args.timeout,
                                   partial_out=args.out, n_rep=args.n_rep,
                                   batch=args.batch)
        ok = sum(1 for r in results if r.get("ok"))
        print(f"\n=== dry-run: {ok}/{len(results)} cells ran ===")
        for r in results:
            if not r.get("ok"):
                err = str(r.get("error", "")).strip().splitlines()
                print(f"FAILED {r['arch']} {r['shape']} {r['mesh']}: "
                      f"{err[-1] if err else ''}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        return 0 if ok == len(results) else 1

    if args.arch is None or args.shape is None or args.mesh == "both":
        ap.error("one cell needs --arch, --shape and one --mesh")
    if args.shape not in SHAPES:
        ap.error(f"unknown shape {args.shape!r}")
    res = run_one(args.arch, args.shape, args.mesh,
                  n_rep_override=args.n_rep, batch_override=args.batch)
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
