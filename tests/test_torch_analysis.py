"""The port's static-analysis linter (``repro_torch.analysis``): each
port rule on violating AND clean snippets, each rule on a mutation of the
real port sources (edited in memory, nothing written), the driver held
against the JAX package's (``repro.analysis.lint``) on the same trees,
RSA004 against JAX's over both packages, and the shipped port tree clean
against its committed baseline.  Pure AST: no subprocess, no device."""
import ast
import json
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.analysis import lint  # noqa: E402
from repro_torch.analysis.lint import (  # noqa: E402
    diff_baseline, lint_source, lint_sources, load_baseline, main)
from repro_torch.analysis.rules import (  # noqa: E402
    RULE_IDS, _common, rsa004_merge_metadata)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.fixture(scope="module")
def ref():
    """The JAX package's linter (framework-free itself)."""
    from repro.analysis import lint as ref_lint
    from repro.analysis.rules import rsa004_merge_metadata as ref_rsa004
    return ref_lint, ref_rsa004


def _rules(src, rel="snippet.py"):
    return sorted({f.rule for f in lint_source(textwrap.dedent(src), rel)})


def _package_rules(files):
    """Rules fired over a package of {relative path: text}."""
    return sorted({f.rule for f in lint_sources(
        [(rel, textwrap.dedent(text)) for rel, text in files.items()])})


def test_rule_ids():
    assert RULE_IDS == ("RSA001", "RSA002", "RSA003", "RSA004", "RSA005")


# --------------------------------------------------------------- RSA001
_FN = """
    import torch

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, group):
            {body}
            return x

        @staticmethod
        def backward(ctx, g):
            return {ret}
"""


def _fn(body="ctx.save_for_backward(x, w)", ret="g, None, None"):
    return _FN.format(body=body, ret=ret)


RSA001_VIOLATING = {
    "tensor method result": _fn("ctx.w = w.detach()"),
    "tensor shown by an attribute":
        _fn("n = w.shape[0]\n            ctx.w = w"),
    "tensor shown by save_for_backward":
        _fn("ctx.save_for_backward(x)\n            ctx.x = x"),
    "torch op result": _fn("ctx.z = torch.zeros(3)"),
    "local bound to a torch op":
        _fn("z = torch.cat([x, w])\n            ctx.z = z"),
    "tuple store": _fn("ctx.group, ctx.x = group, x.view_as(x)"),
    "too few gradients": _fn(ret="g, None"),
    "too many gradients": _fn(ret="g, None, None, None"),
    "mutable default": """
        import torch

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, dims=[0]):
                return x

            @staticmethod
            def backward(ctx, g):
                return g, None
    """,
    "annotated tensor, aliased import": """
        import torch
        from torch.autograd import Function

        class Fn(Function):
            @staticmethod
            def forward(ctx, x: torch.Tensor, k):
                ctx.x = x
                return x

            @staticmethod
            def backward(ctx, g):
                return g, None
    """,
}

RSA001_CLEAN = {
    "as the port writes them": """
        import torch

        class FlashAttentionFn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, kv_len, causal, window, q_offset,
                        sm_scale):
                out = attend(q, k, v)
                ctx.save_for_backward(q, k, v, out, kv_len)
                ctx.kw = dict(causal=causal, window=window,
                              q_offset=q_offset, sm_scale=sm_scale)
                return out

            @staticmethod
            def backward(ctx, dout):
                return dout, dout, dout, None, None, None, None, None

        class _SLSTMScan(torch.autograd.Function):
            @staticmethod
            def forward(ctx, pre, r, c, n, h, m, lay):
                hs, last, saved = scan(pre, r, (c, n, h, m), lay)
                ctx.lay = lay
                ctx.save_for_backward(pre, r, *saved)
                return (hs, *last)

            @staticmethod
            def backward(ctx, d_hs, dc, dn, dh, dm):
                carry = [dc, dn, dh, dm]
                return (d_hs, d_hs, *carry, None)

        class _GatherFromModel(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, group, dim):
                ctx.group, ctx.dim = group, dim
                ctx.shape = x.shape
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                return g, None, None
    """,
    "setup_context style": """
        import torch

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(x, group):
                return x

            @staticmethod
            def setup_context(ctx, inputs, output):
                ctx.group = inputs[1]

            @staticmethod
            def backward(ctx, g):
                return g, None
    """,
    "not a Function": """
        class Fn:
            def forward(self, x, w):
                self.w = w.detach()
                return x

            def backward(self, g):
                return g
    """,
}


@pytest.mark.parametrize("name", sorted(RSA001_VIOLATING))
def test_rsa001_fires(name):
    assert "RSA001" in _rules(RSA001_VIOLATING[name])


@pytest.mark.parametrize("name", sorted(RSA001_CLEAN))
def test_rsa001_clean(name):
    assert "RSA001" not in _rules(RSA001_CLEAN[name])


def test_rsa001_sees_every_function_of_the_port():
    """The nine hand-written backwards are all in the rule's view."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        found += [c.name for c in _common.subclasses(
            tree, _common.import_aliases(tree), "torch.autograd.Function")]
    assert sorted(found) == sorted([
        "FlashAttentionFn", "_HeadMatmul", "_SLSTMScan", "_CopyToModel",
        "_ReduceFromModel", "_MeanOver", "_GatherFromModel",
        "_GatherToModel", "_AllToAll"])


# --------------------------------------------------------------- RSA002
_BUILD = """
    import ctypes

    _P = ctypes.c_void_p
    _I = ctypes.c_int
    _L = ctypes.c_longlong
    _F = ctypes.c_float

    SIGNATURES = {
        "repro_k": [_P, _L, _I, _F, _P],
        "repro_chunk": [],
    }
    SIGNATURES["repro_k_lse"] = SIGNATURES["repro_k"]


    def check(err, what):
        if err != 0:
            raise RuntimeError(what)
"""
_CU = r"""
    // the entry points
    extern "C" int repro_chunk() { return 128; }

    #define K_ARGS                                                      \
      const void *x, long long stride, int n,  /* count */             \
          float scale, void *stream
    extern "C" int repro_k(K_ARGS) { return 0; }
    extern "C" int repro_k_lse(K_ARGS) { return 0; }
"""
_WRAPPER = """
    from . import _build

    def launch(lib, x, n, lse):
        entry = lib.repro_k_lse if lse else lib.repro_k
        err = entry(x, 8, n, 1.0, None)
        _build.check(err, "k")
        if lib.repro_chunk() != 128:
            raise RuntimeError("chunk")
"""


def _kernels(build=_BUILD, cu=_CU, wrapper=_WRAPPER):
    return {"kernels/_build.py": build, "kernels/csrc/k.cu": cu,
            "kernels/k.py": wrapper}


RSA002_VIOLATING = {
    "type": _kernels(build=_BUILD.replace('[_P, _L, _I', '[_P, _I, _I')),
    "count in the .cu macro": _kernels(cu=_CU.replace("int n,", "")),
    "count in SIGNATURES": _kernels(build=_BUILD.replace(", _F, _P]",
                                                         ", _F]")),
    "symbol only in SIGNATURES": _kernels(build=_BUILD.replace(
        '"repro_chunk": [],',
        '"repro_chunk": [],\n        "repro_gone": [],')),
    "symbol only in the .cu": _kernels(cu=_CU + '\n    extern "C" int '
                                       'repro_new(int a) { return a; }\n'),
    "call through the alias with an extra argument": _kernels(
        wrapper=_WRAPPER.replace("1.0, None)", "1.0, None, 0)")),
    "direct call with a missing argument": _kernels(wrapper=_WRAPPER + """
    def direct(lib, x):
        _build.check(lib.repro_k(x, 8, 1, 1.0), "k")
"""),
    "return code discarded": _kernels(wrapper=_WRAPPER + """
    def direct(lib, x):
        lib.repro_k(x, 8, 1, 1.0, None)
"""),
    "return code never checked": _kernels(
        wrapper=_WRAPPER.replace('_build.check(err, "k")', 'pass')),
}


@pytest.mark.parametrize("name", sorted(RSA002_VIOLATING))
def test_rsa002_fires(name):
    assert "RSA002" in _package_rules(RSA002_VIOLATING[name])


def test_rsa002_clean():
    assert "RSA002" not in _package_rules(_kernels())


def test_rsa002_one_file_alone_reads_no_declarations():
    """Without the package's CUDA sources the table is not compared."""
    assert "RSA002" not in _rules(_BUILD.replace('"repro_chunk": [],',
                                                 '"repro_gone": [],'))


# --------------------------------------------------------------- RSA003
_STEP = """
    def paged_step(model, params, arena, slots, op_tok, kv_true, op_len):
        model.extend(params, {{"tokens": op_tok}}, arena, slots=slots)
        saved = model.take_kv_window(arena, slots, kv_true, op_len)
        {body}
        return logits
"""
_DECODE = ("logits, _ = model.decode_step(params, op_tok, arena, kv_true, "
           "slots=slots)")

RSA003_VIOLATING = {
    "no try": _STEP.format(body=_DECODE + "\n        model.put_kv_window("
                           "arena, slots, kv_true, op_len, saved)"),
    "restored in except only": _STEP.format(
        body="try:\n            " + _DECODE + "\n        except Exception:"
             "\n            model.put_kv_window(arena, slots, kv_true, "
             "op_len, saved)\n            raise"),
    "finally restores something else": _STEP.format(
        body="try:\n            " + _DECODE + "\n        finally:"
             "\n            model.put_kv_window(arena, slots, kv_true, "
             "op_len, other)"),
    "decode inside finally": _STEP.format(
        body="try:\n            pass\n        finally:\n            "
             + _DECODE + "\n            model.put_kv_window(arena, slots, "
             "kv_true, op_len, saved)"),
}

RSA003_CLEAN = {
    "undo log in finally": _STEP.format(
        body="try:\n            for t in range(op_len):\n                "
             + _DECODE + "\n        finally:\n            model."
             "put_kv_window(arena, slots, kv_true, op_len, saved)"),
    "gather plane (no slots)": """
        def gather_step(model, params, st, tok, kv_true):
            return model.decode_step(params, tok, st, kv_true)
    """,
    "copy-on-write copy": """
        def cow(model, states, src, dst, start, n):
            win = model.take_kv_window(states, src, start, n)
            model.put_kv_window(states, dst, start, n, win)
    """,
}


@pytest.mark.parametrize("name", sorted(RSA003_VIOLATING))
def test_rsa003_fires(name):
    assert "RSA003" in _rules(RSA003_VIOLATING[name])


@pytest.mark.parametrize("name", sorted(RSA003_CLEAN))
def test_rsa003_clean(name):
    assert "RSA003" not in _rules(RSA003_CLEAN[name])


# --------------------------------------------------------------- RSA004
VIOLATING_RSA004 = """
    from dataclasses import dataclass

    @dataclass
    class LaunchStats:
        launches: int = 0

        def merge_from(self, other):
            self.launches += other.launches
"""

CLEAN_RSA004 = """
    import dataclasses
    from dataclasses import dataclass, field

    def _stat(merge, **kw):
        return field(metadata={"merge": merge}, **kw)

    @dataclass
    class LaunchStats:
        launches: int = _stat("sum", default=0)
        peak: int = field(default=0, metadata={"merge": "max"})

        def merge_from(self, other):
            for f in dataclasses.fields(self):
                pass
"""


def test_rsa004():
    assert "RSA004" in _rules(VIOLATING_RSA004)
    assert "RSA004" not in _rules(CLEAN_RSA004)


# --------------------------------------------------------------- RSA005
RSA005_VIOLATING = {
    "torch.randn without generator": """
        import torch
        w = torch.randn(4, 4)
    """,
    "torch.rand_like": """
        import torch
        def noise(x):
            return torch.rand_like(x)
    """,
    "in-place sampler": """
        import torch
        def init(w):
            w.normal_(0.0, 0.02)
    """,
    "np.random global draw": """
        import numpy as np
        idx = np.random.permutation(8)
    """,
    "np.random.seed": """
        import numpy as np
        np.random.seed(0)
    """,
    "unseeded RandomState": """
        import numpy as np
        rs = np.random.RandomState()
    """,
    "random module draw": """
        import random
        def pick(xs):
            return random.choice(xs)
    """,
    "from-import draw": """
        from random import shuffle
        def mix(xs):
            shuffle(xs)
    """,
    "clock in nn.Module forward": """
        import time
        from torch import nn
        class Timed(nn.Module):
            def forward(self, x):
                return x * time.perf_counter()
    """,
    "clock in Function backward": """
        import torch
        from datetime import datetime
        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x
            @staticmethod
            def backward(ctx, g):
                stamp = datetime.now()
                return g
    """,
}

RSA005_CLEAN = {
    "explicit generators": """
        import numpy as np
        import torch
        def init(gen, shape, seed, w):
            u = torch.rand(shape, generator=gen, device=gen.device)
            w.uniform_(-1.0, 1.0, generator=gen)
            rng = np.random.default_rng(seed)
            rs = np.random.RandomState(seed)
            return u, rng.permutation(8), rs.rand(3)
    """,
    "local named random": """
        import numpy as np
        def draw(seed):
            random = np.random.default_rng(seed)
            return random.normal(size=3)
    """,
    "host loop clock and dataclass default": """
        import time
        from dataclasses import dataclass
        @dataclass
        class Plan:
            clock: callable = time.monotonic
        def train(step, n):
            t0 = time.time()
            for _ in range(n):
                step()
            return time.time() - t0
    """,
}


@pytest.mark.parametrize("name", sorted(RSA005_VIOLATING))
def test_rsa005_fires(name):
    assert "RSA005" in _rules(RSA005_VIOLATING[name])


@pytest.mark.parametrize("name", sorted(RSA005_CLEAN))
def test_rsa005_clean(name):
    assert "RSA005" not in _rules(RSA005_CLEAN[name])


# ------------------------------------------- driver: suppression, RSA000
def test_inline_suppression():
    src = textwrap.dedent(RSA005_VIOLATING["torch.randn without generator"])
    for tag in ("RSA005", "ALL", "RSA001, RSA005"):
        quiet = src.replace("w = torch.randn(4, 4)",
                            f"w = torch.randn(4, 4)  # lint: disable={tag}")
        assert not lint_source(quiet, "snippet.py")
    assert _rules(src) == ["RSA005"]


def test_syntax_error_is_rsa000():
    assert _rules("def broken(:\n    pass") == ["RSA000"]
    found = lint_sources([("a.py", "x = 1\n"), ("b.py", "def (:\n")])
    assert [(f.rule, f.file) for f in found] == [("RSA000", "b.py")]


# ------------------------------- mutations of the real port, in memory
_PAGED_TRY = """        try:
            for t in range(op_len):
                tok = op_tok[t].expand(B)
                logits, _ = model.decode_step(params, tok, arena_states,
                                              kv_true + t, slots=slots)
        finally:
            model.put_kv_window(arena_states, slots, kv_true, op_len, saved)
"""
_PAGED_BARE = """        for t in range(op_len):
            tok = op_tok[t].expand(B)
            logits, _ = model.decode_step(params, tok, arena_states,
                                          kv_true + t, slots=slots)
        model.put_kv_window(arena_states, slots, kv_true, op_len, saved)
"""
MUTATIONS = {
    # rule, file, old text, new text
    "backward drops a None": (
        "RSA001", "kernels/flash_attention.py",
        "return dq, dk, dv, None, None, None, None, None",
        "return dq, dk, dv, None, None, None, None"),
    "a stride bound as c_int": (
        "RSA002", "kernels/_build.py",
        "_L, _L, _L,                         # q strides",
        "_L, _I, _L,                         # q strides"),
    "the .cu declaration loses an argument": (
        "RSA002", "kernels/csrc/flash_attention.cu",
        "    int dtype_kv, void* stream) {", "    void* stream) {"),
    "the decode macro loses an argument": (
        "RSA002", "kernels/csrc/decode_attention.cu",
        "      int dtype_kv, void *stream\n", "      void *stream\n"),
    "the op-suffix decode leaves its try": (
        "RSA003", "serving/engine.py", _PAGED_TRY, _PAGED_BARE),
    "a weight draw loses its generator": (
        "RSA005", "models/layers.py",
        "u = torch.rand(shape, generator=gen, device=gen.device,",
        "u = torch.rand(shape, device=gen.device,"),
}


@pytest.fixture(scope="module")
def port_sources():
    srcs = [(rel, f.read_text()) for f, rel in lint.iter_py_files([PORT])]
    srcs += [(f.relative_to(PORT).as_posix(), f.read_text())
             for f in sorted((PORT / "kernels" / "csrc").glob("*.cu"))]
    return srcs


def _lint_kernels_and(port_sources, rel, text):
    """Lint the kernel package's bindings and ``rel`` (edited to
    ``text``) as one package."""
    keep = {rel, "kernels/_build.py", "kernels/decode_attention.py",
            "kernels/flash_attention.py", "kernels/relevance_score.py"}
    return lint_sources([(r, text if r == rel else t)
                         for r, t in port_sources
                         if r in keep or r.endswith(".cu")])


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_rule_fires_on_mutated_port(port_sources, name):
    rule, rel, old, new = MUTATIONS[name]
    text = dict(port_sources)[rel]
    assert text.count(old) == 1, (rel, old)
    clean = _lint_kernels_and(port_sources, rel, text)
    assert not clean, [f.format() for f in clean]
    found = _lint_kernels_and(port_sources, rel, text.replace(old, new))
    assert rule in {f.rule for f in found}, (rule, name)
    assert all(f.file.endswith(".py") for f in found)


# ------------------------------------------- parity with the JAX linter
def _run(main_fn, args, capsys):
    rc = main_fn([str(a) for a in args])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_driver_matches_jax_driver(tmp_path, capsys, ref):
    """Exit codes and printed finding lines of both drivers on the same
    trees: an RSA004 violation, a syntax error, an inline suppression, a
    baseline round trip, a stale entry, a missing path."""
    ref_lint, _ = ref
    tree = tmp_path / "pkg"
    (tree / "sub").mkdir(parents=True)
    (tree / "stats.py").write_text(textwrap.dedent(VIOLATING_RSA004))
    (tree / "sub" / "broken.py").write_text("def broken(:\n    pass\n")
    (tree / "quiet.py").write_text(textwrap.dedent(
        VIOLATING_RSA004).replace("launches: int = 0",
                                  "launches: int = 0  # lint: disable=ALL"))
    (tree / "ok.py").write_text(textwrap.dedent(CLEAN_RSA004))
    bl = tmp_path / "baseline.json"

    def both(*args):
        ours = _run(main, args, capsys)
        theirs = _run(ref_lint.main, args, capsys)
        assert ours == theirs, (args, ours, theirs)
        return ours

    rc, out, _ = both(tree, "--no-baseline")
    assert rc == 1 and "RSA004" in out and "RSA000" in out
    assert out.count("RSA004 field") == 1          # quiet.py suppressed
    assert both(tree, "--baseline", bl, "--write-baseline")[0] == 0
    theirs = load_baseline(bl)                  # the JAX driver wrote last
    assert main([str(tree), "--baseline", str(bl), "--write-baseline"]) == 0
    capsys.readouterr()
    assert load_baseline(bl) == theirs and len(theirs) == 2
    rc, out, _ = both(tree, "--baseline", bl, "--list")
    assert rc == 0 and "[baseline]" in out
    (tree / "stats.py").write_text(textwrap.dedent(CLEAN_RSA004))
    rc, out, _ = both(tree, "--baseline", bl)
    assert rc == 1 and "stale baseline entry" in out
    assert both(tree / "ok.py", "--no-baseline")[0] == 0
    rc, _, err = both(tmp_path / "does-not-exist")
    assert rc == 2 and "no such path" in err


def test_rsa004_matches_jax_over_both_packages(ref):
    _, ref_rsa004 = ref
    n = 0
    for pkg in (ROOT / "src" / "repro", PORT):
        for path in sorted(pkg.rglob("*.py")):
            src = path.read_text()
            tree, lines = ast.parse(src), src.splitlines()
            rel = path.relative_to(pkg).as_posix()
            ours = list(rsa004_merge_metadata.check(
                tree, lines, rel, _common.Package(modules={rel: tree})))
            assert ours == list(ref_rsa004.check(tree, lines, rel)), rel
            n += 1
    assert n > 100


# ----------------------------------------------- the shipped port tree
def test_shipped_tree_is_clean_vs_committed_baseline():
    findings = lint.lint_paths([lint._PKG_ROOT])
    new, stale, _ = diff_baseline(findings,
                                  load_baseline(lint._DEFAULT_BASELINE))
    assert not new, [f.format() for f in new]
    assert not stale, stale


def test_committed_baseline_entries_have_reasons():
    data = json.loads(lint._DEFAULT_BASELINE.read_text())
    for e in data["suppressions"]:
        assert e.get("reason") and "TODO" not in e["reason"], e


def test_linter_imports_only_the_standard_library():
    """The linter runs where the port's dependencies are absent."""
    files = [PORT / "analysis" / n for n in ("__init__.py", "__main__.py",
                                             "lint.py")]
    for path in files + sorted((PORT / "analysis" / "rules").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            for top in tops:
                assert top in sys.stdlib_module_names or \
                    top == "__future__", (path, top)


def test_package_reexports_the_sanitizer():
    import repro_torch.analysis as pa
    from repro_torch.analysis import (ArenaRaceError, ArenaSanitizer,
                                      env_enabled)
    from repro_torch.analysis import sanitizer
    assert pa.__all__ == ["ArenaRaceError", "ArenaSanitizer", "env_enabled"]
    assert (ArenaRaceError, ArenaSanitizer, env_enabled) == (
        sanitizer.ArenaRaceError, sanitizer.ArenaSanitizer,
        sanitizer.env_enabled)
    assert env_enabled({"ARENA_SANITIZE": "1"})
    assert not env_enabled({})
