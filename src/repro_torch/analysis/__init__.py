"""Serving-plane static analysis + runtime arena sanitizer of the port.

Two halves, one correctness discipline, as in ``repro.analysis``: the
static pass makes the port's data-plane invariants (hand-written
backwards, ``ctypes`` kernel bindings, in-place arena writes, explicit
random streams) CI failures instead of silent wrong answers, and the
runtime sanitizer checks the arena's row ownership as the server runs.

Static pass (``python -m repro_torch.analysis``)
================================================
AST linter over ``src/repro_torch/`` (and its ``kernels/csrc/*.cu``),
gated against the committed suppression baseline
``analysis/baseline.json`` (new findings and stale suppressions both
fail).  Suppress a finding either with a baseline entry (one-line
``reason`` required) or inline with ``# lint: disable=RSA00X`` on the
flagged line.  Pure AST: it imports neither torch nor the code it lints.

Rule catalogue
--------------
Each rule keeps the number of its counterpart in ``repro.analysis`` and
is redesigned for the port, where ``jax.jit``, ``pl.pallas_call`` and
``donate_argnums`` do not occur.  Every rule prefers a false negative to
a false positive.

**RSA001 — ``torch.autograd.Function`` hygiene** (for jit-signature
hygiene).  (a) A tensor reaches ``backward`` only through
``ctx.save_for_backward``: a tensor stored as a plain ``ctx`` attribute
escapes the version counter.  (b) ``backward`` returns one gradient per
input of ``forward`` (a literal tuple; starred returns are skipped).
(c) No mutable default argument on ``forward``/``backward``.  Minimal
violations::

    class Scale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x: torch.Tensor, w, group):
            ctx.w = w.detach()             # RSA001a: use save_for_backward
            return x * w
        @staticmethod
        def backward(ctx, g):
            return g * ctx.w, None         # RSA001b: 2 items, 3 inputs

**RSA002 — CUDA kernel binding conventions** (for the Pallas
conventions).  (a) Every ``SIGNATURES`` entry of ``kernels/_build.py``
agrees with its ``extern "C"`` declaration in ``kernels/csrc/*.cu`` in
argument count and type (macros such as ``REPRO_DECODE_ARGS`` expanded),
and no symbol is on one side only; (b) every call of an entry point
passes ``len(SIGNATURES[sym])`` arguments; (c) its return code reaches
``check(...)``.  Minimal violations::

    SIGNATURES = {"repro_k": [_P, _I]}   # .cu: int repro_k(void*, long long)
                                         # RSA002a: argument 1 is c_longlong
    lib.repro_k(x.data_ptr(), n, 0)      # RSA002b (3 != 2) and RSA002c
                                         # (return code discarded)

**RSA003 — in-place arena writes commit on success** (for donation
safety).  A ``decode_step(..., slots=...)`` writes arena rows below the
committed length in place, so it must run inside a ``try`` whose
``finally`` restores a preceding ``take_kv_window(...)`` snapshot with
``put_kv_window(...)``.  ``extend(..., slots=...)`` writes only above the
committed length and is exempt.  Minimal violation::

    saved = model.take_kv_window(arena, slots, pos, n)
    model.decode_step(params, tok, arena, pos, slots=slots)   # RSA003
    model.put_kv_window(arena, slots, pos, n, saved)

**RSA004 — merge metadata on stats dataclasses** (the same rule).  Any
``@dataclass`` defining ``merge_from`` (or named ``*Stats``) must declare
a merge strategy on every field (``scheduler._stat(...)`` or
``field(metadata={"merge": ...})``), else multi-tenant aggregation
silently mis-merges the new field.  Minimal violation::

    @dataclass
    class ServeStats:
        launches: int = 0      # RSA004: no merge strategy
        def merge_from(self, src): ...

**RSA005 — no hidden random or clock state** (for wall-clock/RNG in
jit).  (a) ``torch.rand``/``randn``/``randint``/... and the in-place
samplers (``.uniform_``, ``.normal_``, ...) take ``generator=``; (b) no
global-state ``np.random.<fn>``/``random.<fn>`` (``default_rng(seed)``
and seeded ``RandomState``/``Random`` are fine); (c) no
``time.*``/``datetime.*`` read inside the ``forward``/``backward`` of an
``autograd.Function`` or ``nn.Module``, which a CUDA-graph capture would
freeze.  Minimal violations::

    w = torch.randn(d, d)                     # RSA005a: no generator=
    idx = np.random.permutation(n)            # RSA005b: global state
    class Timed(nn.Module):
        def forward(self, x):
            return x * time.perf_counter()    # RSA005c

Runtime half (``analysis/sanitizer.py``)
========================================
:class:`~repro_torch.analysis.sanitizer.ArenaSanitizer` — per-row
ownership epochs over the KV arenas, active under ``ARENA_SANITIZE=1``
(or ``LMBackend.sanitize=True``).  Launches register read/write row
sets; overlapping in-flight writes, writes to pinned prefix rows outside
the COW path, and use-after-release raise
:class:`~repro_torch.analysis.sanitizer.ArenaRaceError` naming rows,
launch signatures, and owning doc/query ids.  The sanitizer is
host-side shadow state only: no tensors, no RNG.
"""
from __future__ import annotations

from .sanitizer import ArenaRaceError, ArenaSanitizer, env_enabled

__all__ = ["ArenaRaceError", "ArenaSanitizer", "env_enabled"]
