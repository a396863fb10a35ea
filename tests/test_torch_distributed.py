"""The port's distributed layer held against the JAX package on the CPU.

One gloo world of 8 ranks (a 4 x 2 ``data`` x ``model`` mesh, spawned
once per module from ``_rank_body``, ``file://`` rendezvous, timeouts on
the join and on every collective) runs the collectives, sequence-parallel
decode and the two MoE mesh strategies on its local shards of seeded
numpy inputs.  The JAX side runs once per module in a subprocess with 8
forced host devices (this file with ``--jax``), under ``shard_map`` on
``jax.make_mesh((4, 2))``, and writes an ``.npz``: per-rank results come
back on a leading axis of 8 in mesh order (``data`` major), which is the
port's rank order.

Tolerances (f32): ring collectives and ``int8_compress`` bitwise (the
same hops, chunks and order of adds); ``compressed_psum`` 1e-6 (the two
all-reduces sum in other orders); ``sp_decode_attention``,
``matmul_ag_overlap`` and the MoE outputs and aux losses 1e-5; keep
masks exact.  Spec arithmetic and fault planning run in-process and are
identical.  The ``cuda`` tests hold ``decode_attention_lse`` against its
plain version on the card.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import collectives as tcol  # noqa: E402
from repro_torch.distributed import fault as tfault  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.distributed.compat import MeshShape, run_world  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
MESH = ((4, 2), ("data", "model"))
SP_LENS = (0, 1, 63, 64, 65, 200, 256)
SP = dict(B=2, H=8, KV=2, S=256, Dh=64)
# 8 drops nothing; 1.25 drops in ep_a2a (its shard pool); tp_smap's row
# capacity at 1.25 is the row length, which top-2 over 4 experts cannot
# exceed, so 0.5 is the case where it drops
MOE_CFS = (8.0, 1.25, 0.5)
MOE = dict(d=16, f=32, E=4, k=2, B=8, S=16)
MOE_W = ("router", "w1", "w3", "w2")
AUX_W = 0.5              # the aux loss's weight in the gradient objective
F32 = dict(atol=1e-5, rtol=1e-5)


def _inputs():
    """Every input of both sides, from one numpy seed."""
    r = np.random.default_rng(0)
    n = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    d, f, E = MOE["d"], MOE["f"], MOE["E"]
    # a shared direction in every token skews the router, so capacity
    # 1.25 drops assignments
    skew = n(d)
    x = {
        "ag_x": n(16, 6), "ag_y": n(5, 8), "rs_x": n(48, 8), "rs_y": n(64, 3),
        "sp_q": n(SP["B"], SP["H"], SP["Dh"]),
        "sp_k": n(SP["B"], SP["S"], SP["KV"], SP["Dh"]),
        "sp_v": n(SP["B"], SP["S"], SP["KV"], SP["Dh"]),
        "c8": n(8, 16), "cp_x": n(64, 16), "cp_e": 0.01 * n(64, 16),
        "mm_x": n(2, 8, 6), "mm_w": n(6, 10),
        "router": n(d, E) / np.sqrt(d), "w1": n(E, d, f) / np.sqrt(d),
        "w3": n(E, d, f) / np.sqrt(d), "w2": n(E, f, d) / np.sqrt(f),
        "moe_x": 0.3 * n(MOE["B"], MOE["S"], d) + 0.8 * skew,
        "moe_ct": n(MOE["B"], MOE["S"], d),
    }
    return {k: v.astype(np.float32) for k, v in x.items()}


def _sp_lens(v):
    return np.asarray([v, SP["S"] - v], np.int32)


# ---------------------------------------------------------------------------
# the JAX side (a subprocess with 8 host devices)
# ---------------------------------------------------------------------------

def _jax_side(out_path):
    """Every reference result, each mapped function under ``jax.jit``."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.distributed import collectives as jc
    from repro.distributed.compat import shard_map
    from repro.models import moe as jm

    mesh = jax.make_mesh(*MESH)
    x = {k: jnp.asarray(v) for k, v in _inputs().items()}
    ranks = P(("data", "model"))
    out = {}

    def per_rank(body, in_specs, *args):
        """Each rank's output on a leading axis of 8, in mesh order."""
        return np.asarray(jax.jit(shard_map(
            lambda *a: body(*a)[None], mesh=mesh, in_specs=in_specs,
            out_specs=ranks))(*args))

    out["ag_x"] = per_rank(lambda a: jc.ring_all_gather(a, "data", axis=0),
                           (P("data", None),), x["ag_x"])
    out["ag_y"] = per_rank(lambda a: jc.ring_all_gather(a, "model", axis=1),
                           (P(None, "model"),), x["ag_y"])
    out["rs_x"] = per_rank(
        lambda a: jc.ring_reduce_scatter(a, "model", axis=1),
        (P(("data", "model"), None),), x["rs_x"])
    out["rs_y"] = per_rank(
        lambda a: jc.ring_reduce_scatter(a, "data", axis=0),
        (P(("data", "model"), None),), x["rs_y"])
    red = per_rank(lambda a, e: jnp.stack(jc.compressed_psum(a, "data", e)),
                   (P(("data", "model"), None),) * 2, x["cp_x"], x["cp_e"])
    out["cp_red"], out["cp_err"] = red[:, 0], red[:, 1]
    q8, s8 = jc.int8_compress(x["c8"])
    out["c8_q"], out["c8_s"] = np.asarray(q8), np.asarray(s8)
    out["mm"] = per_rank(lambda a, w: jc.matmul_ag_overlap(a, w, "data"),
                         (P(None, "data", None), P()), x["mm_x"], x["mm_w"])
    scale = SP["Dh"] ** -0.5
    s_loc = SP["S"] // MESH[0][0]
    sp = jax.jit(functools.partial(jc.sp_decode_attention, mesh=mesh,
                                   sm_scale=scale))
    lse = jax.jit(functools.partial(jc._local_decode_lse, sm_scale=scale))
    for v in SP_LENS:
        kl = jnp.asarray(_sp_lens(v))
        out[f"sp_{v}"] = np.asarray(sp(x["sp_q"], x["sp_k"], x["sp_v"], kl))
        for i in range(MESH[0][0]):
            sl = slice(i * s_loc, (i + 1) * s_loc)
            acc, l, m = lse(
                x["sp_q"], x["sp_k"][:, sl], x["sp_v"][:, sl], kl,
                shard_offset=jnp.full((SP["B"],), i * s_loc, jnp.int32))
            out[f"lse_{v}_{i}"] = np.concatenate(
                [np.asarray(acc), np.asarray(l)[..., None],
                 np.asarray(m)[..., None]], -1)
    params = {k: x[k] for k in ("router", "w1", "w3", "w2")}
    n_data = MESH[0][0]
    b_loc = MOE["B"] // n_data
    E, k = MOE["E"], MOE["k"]
    for cf in MOE_CFS:
        for strat, fn in (("ep", jm.moe_apply_ep_a2a),
                          ("tp", jm.moe_apply_tp_smap)):
            y, aux0 = jax.jit(functools.partial(
                fn, top_k=k, capacity_factor=cf, mesh=mesh,
                dp_spec=P("data", None, None)))(params, x["moe_x"])
            out[f"moe_{strat}_{cf}"] = np.asarray(y)
            out[f"moe_{strat}_{cf}_aux0"] = np.asarray(aux0)
            # each data shard's keep mask and aux loss, from the same
            # helpers the strategies call
            keeps, auxes = [], []
            for i in range(n_data):
                xs = x["moe_x"][i * b_loc:(i + 1) * b_loc]
                if strat == "ep":
                    t = b_loc * MOE["S"]
                    cap = max(int(t * k * cf / E), 8)
                    ids, _, lg = jm._route(params["router"],
                                           xs.reshape(t, -1), k)
                    keeps.append(np.asarray(
                        jm._dispatch_indices(ids, E, cap)[1]))
                    auxes.append(np.asarray(jm._aux_loss(lg, ids, E)))
                else:
                    row_cf = cf * 1.6
                    cap = max(int(MOE["S"] * k * row_cf / E), 8)
                    rows = [jm._route(params["router"], xr, k) for xr in xs]
                    keeps.append(np.stack([np.asarray(
                        jm._dispatch_indices(ids, E, cap)[1])
                        for ids, _, _ in rows]))
                    auxes.append(np.asarray(jm._aux_loss(
                        jnp.concatenate([lg for _, _, lg in rows]),
                        jnp.concatenate([ids for ids, _, _ in rows]), E)))
            out[f"moe_{strat}_{cf}_keep"] = np.stack(keeps)
            out[f"moe_{strat}_{cf}_aux"] = np.stack(auxes)
            # gradients of sum(y * ct) + AUX_W * aux through the strategy
            f = functools.partial(fn, top_k=k, capacity_factor=cf,
                                  mesh=mesh, dp_spec=P("data", None, None))

            def obj(p, xx, f=f):
                y, aux = f(p, xx)
                return jnp.sum(y * x["moe_ct"]) + AUX_W * aux
            gp, gx = jax.jit(jax.grad(obj, argnums=(0, 1)))(
                params, x["moe_x"])
            for name in MOE_W:
                out[f"moe_{strat}_{cf}_d{name}"] = np.asarray(gp[name])
            out[f"moe_{strat}_{cf}_dx"] = np.asarray(gx)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port's side (8 gloo ranks)
# ---------------------------------------------------------------------------

def _rank_body(rank, world, out_dir):
    from repro_torch.distributed.compat import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(*MESH, device_type="cpu")
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    ls = lambda t, *spec: tsh.local_shard(t, spec, mesh)  # noqa: E731
    out = {
        "ag_x": tcol.ring_all_gather(ls(x["ag_x"], "data", None), mesh,
                                     "data", axis=0),
        "ag_y": tcol.ring_all_gather(ls(x["ag_y"], None, "model"), mesh,
                                     "model", axis=1),
        "rs_x": tcol.ring_reduce_scatter(
            ls(x["rs_x"], ("data", "model"), None), mesh, "model", axis=1),
        "rs_y": tcol.ring_reduce_scatter(
            ls(x["rs_y"], ("data", "model"), None), mesh, "data", axis=0),
        "mm": tcol.matmul_ag_overlap(ls(x["mm_x"], None, "data", None),
                                     x["mm_w"], mesh, "data"),
    }
    out["cp_red"], out["cp_err"] = tcol.compressed_psum(
        ls(x["cp_x"], ("data", "model"), None), mesh, "data",
        ls(x["cp_e"], ("data", "model"), None))
    scale = SP["Dh"] ** -0.5
    k_loc = ls(x["sp_k"], None, "data", None, None)
    v_loc = ls(x["sp_v"], None, "data", None, None)
    for v in SP_LENS:
        out[f"sp_{v}"] = tcol.sp_decode_attention(
            x["sp_q"], k_loc, v_loc, torch.from_numpy(_sp_lens(v)), mesh,
            scale)
    params = {k: x[k] for k in MOE_W}
    x_loc = ls(x["moe_x"], "data", None, None)
    for cf in MOE_CFS:
        for strat, fn in (("ep", tmoe.moe_apply_ep_a2a),
                          ("tp", tmoe.moe_apply_tp_smap)):
            tmoe.DROP_LOG = []
            y, aux = fn(params, x_loc, top_k=MOE["k"], capacity_factor=cf,
                        mesh=mesh, dp_spec=("data", None, None))
            out[f"moe_{strat}_{cf}"], out[f"moe_{strat}_{cf}_aux"] = y, aux
            out[f"moe_{strat}_{cf}_keep"] = tmoe.DROP_LOG[0]
            tmoe.DROP_LOG = None
            out.update(_moe_grads(strat, fn, cf, params, x, mesh))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _moe_grads(strat, fn, cf, params, x, mesh):
    """The gradients of ``sum(y * ct) + AUX_W * aux / n_data`` summed over
    the data ranks (the objective JAX differentiates: its ``aux`` is the
    mean of the shards'), through the strategy on this rank's weight
    slices (``sharded=True``), gathered to full arrays."""
    from repro_torch.distributed.compat import axis_group
    spec = tmoe.spec_moe("ep_a2a" if strat == "ep" else "tp_smap")
    pspecs = {k: tsh.logical_to_pspec(spec[k], mesh) for k in MOE_W}
    w = {k: tsh.local_shard(params[k], pspecs[k], mesh).requires_grad_(True)
         for k in MOE_W}
    xl = tsh.local_shard(x["moe_x"], ("data", None, None), mesh)
    xl.requires_grad_(True)
    y, aux = fn(w, xl, top_k=MOE["k"], capacity_factor=cf, mesh=mesh,
                dp_spec=("data", None, None), sharded=True)
    ct = tsh.local_shard(x["moe_ct"], ("data", None, None), mesh)
    obj = (y * ct).sum() + AUX_W * aux / MESH[0][0]
    grads = torch.autograd.grad(obj, [w[k] for k in MOE_W] + [xl])
    data = axis_group(mesh, "data")
    out = {}
    for k, g in zip(MOE_W, grads):
        if "data" not in tsh.spec_axes(pspecs[k]):
            g = tcol.group_sum(g, data)      # a replicated leaf's ranks
        out[f"moe_{strat}_{cf}_d{k}"] = tsh.gather_full(g, pspecs[k], mesh)
    out[f"moe_{strat}_{cf}_dx"] = tsh.gather_full(
        grads[-1], ("data", None, None), mesh)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX outputs, [each rank's outputs]): the JAX subprocess runs while
    the port's world does."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    jax_proc = subprocess.Popen(
        [sys.executable, __file__, "--jax", str(d / "jax.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        run_world(_rank_body, WORLD, str(d), device_type="cpu",
                  init_method=f"file://{d / 'rdv'}", timeout_s=240.0)
        log, _ = jax_proc.communicate(timeout=240)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, log
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(WORLD)]
    return dict(np.load(d / "jax.npz")), ranks


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t


@pytest.mark.parametrize("key", ["ag_x", "ag_y", "rs_x", "rs_y"])
def test_ring_collectives_bitwise(results, key):
    jx, ranks = results
    for r in range(WORLD):
        np.testing.assert_array_equal(_np(ranks[r][key]), jx[key][r],
                                      err_msg=f"rank {r}")


def test_ring_all_gather_is_the_full_array(results):
    _, ranks = results
    x = _inputs()
    for r in range(WORLD):
        np.testing.assert_array_equal(_np(ranks[r]["ag_x"]), x["ag_x"])
        np.testing.assert_array_equal(_np(ranks[r]["ag_y"]), x["ag_y"])


def test_ring_reduce_scatter_reference_fault_pinned(results):
    """The reference's ring adds chunk i + 1 + s of its own input to a
    partial of other chunks, so over more than 2 ranks it is no
    reduce-scatter; both packages give the same (wrong) bits.  Over the
    2 model ranks (``rs_x``) it is chunk i of the sum; over the 4 data
    ranks (``rs_y``) it is not (ROADMAP Queue 3)."""
    jx, ranks = results
    x = _inputs()
    for key, n, ax, coord in (("rs_x", 2, 1, lambda r: r % 2),
                              ("rs_y", 4, 0, lambda r: r // 2)):
        parts = x[key].reshape(WORLD, -1, x[key].shape[-1])   # per rank
        for r in range(WORLD):
            line = [q for q in range(WORLD)
                    if (q // 2 == r // 2 if n == 2 else q % 2 == r % 2)]
            total = sum(parts[q] for q in line)
            c = total.shape[ax] // n
            true = np.take(total, range(coord(r) * c, (coord(r) + 1) * c),
                           axis=ax)
            got = _np(ranks[r][key])
            np.testing.assert_array_equal(got, jx[key][r])
            if n == 2:
                np.testing.assert_allclose(got, true, rtol=1e-6)
            else:
                assert not np.allclose(got, true), (key, r)


@pytest.mark.parametrize("v", SP_LENS)
def test_sp_decode_attention_matches_jax(results, v):
    jx, ranks = results
    for r in range(WORLD):
        np.testing.assert_allclose(_np(ranks[r][f"sp_{v}"]), jx[f"sp_{v}"],
                                   **F32, err_msg=f"rank {r}")


@pytest.mark.parametrize("v", SP_LENS)
def test_lse_plain_matches_local_decode_lse(results, v):
    """``decode_attention_lse_plain`` over each seq shard (its local
    length clamped) against the reference's ``_local_decode_lse`` (global
    length and shard offset): acc, l and m, -inf where no key is seen."""
    jx, _ = results
    x = _inputs()
    s_loc = SP["S"] // MESH[0][0]
    for i in range(MESH[0][0]):
        sl = slice(i * s_loc, (i + 1) * s_loc)
        local = np.clip(_sp_lens(v) - i * s_loc, 0, s_loc)
        got = tops.decode_attention_lse(
            torch.from_numpy(x["sp_q"]), torch.from_numpy(x["sp_k"][:, sl]),
            torch.from_numpy(x["sp_v"][:, sl]), torch.from_numpy(local),
            sm_scale=SP["Dh"] ** -0.5).numpy()
        want = jx[f"lse_{v}_{i}"]
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        np.testing.assert_allclose(got, want, **F32, err_msg=f"shard {i}")


def test_int8_compress_exact(results):
    jx, _ = results
    q, s = tcol.int8_compress(torch.from_numpy(_inputs()["c8"]))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), jx["c8_q"])
    assert float(s) == float(jx["c8_s"])
    back = tcol.int8_decompress(q, s)
    assert float((back - torch.from_numpy(_inputs()["c8"])).abs().max()) \
        <= float(s) / 2 + 1e-7


def test_compressed_psum_value_and_error_feedback(results):
    jx, ranks = results
    for r in range(WORLD):
        for k in ("cp_red", "cp_err"):
            np.testing.assert_allclose(_np(ranks[r][k]), jx[k][r],
                                       atol=1e-6, rtol=0,
                                       err_msg=f"{k} rank {r}")


def test_matmul_ag_overlap(results):
    jx, ranks = results
    x = _inputs()
    for r in range(WORLD):
        np.testing.assert_allclose(_np(ranks[r]["mm"]), jx["mm"][r], **F32)
    np.testing.assert_allclose(_np(ranks[0]["mm"]), x["mm_x"] @ x["mm_w"],
                               **F32)


@pytest.mark.parametrize("cf", MOE_CFS)
@pytest.mark.parametrize("strat", ["ep", "tp"])
def test_moe_mesh_strategies_match_jax(results, strat, cf):
    """``moe_apply_ep_a2a`` / ``moe_apply_tp_smap`` on every rank's batch
    shard: keep masks exact, outputs and aux losses to 1e-5; rank 0's aux
    is the value the JAX function returns (its ``out_specs=P()``)."""
    jx, ranks = results
    key = f"moe_{strat}_{cf}"
    b_loc = MOE["B"] // MESH[0][0]
    for r in range(WORLD):
        i = r // MESH[0][1]                      # data coordinate
        np.testing.assert_array_equal(_np(ranks[r][key + "_keep"]),
                                      jx[key + "_keep"][i])
        np.testing.assert_allclose(_np(ranks[r][key]),
                                   jx[key][i * b_loc:(i + 1) * b_loc],
                                   **F32, err_msg=f"rank {r}")
        np.testing.assert_allclose(_np(ranks[r][key + "_aux"]),
                                   jx[key + "_aux"][i], **F32)
    np.testing.assert_allclose(_np(ranks[0][key + "_aux"]),
                               jx[key + "_aux0"], **F32)


def test_moe_cases_drop_where_they_should(results):
    jx, _ = results
    assert not jx["moe_ep_1.25_keep"].all()
    assert not jx["moe_tp_0.5_keep"].all()
    for strat in ("ep", "tp"):
        assert jx[f"moe_{strat}_8.0_keep"].all(), strat


@pytest.mark.parametrize("cf", MOE_CFS)
@pytest.mark.parametrize("strat", ["ep", "tp"])
def test_moe_mesh_strategy_gradients_match_jax(results, strat, cf):
    """Input and weight gradients through ``moe_apply_ep_a2a`` /
    ``moe_apply_tp_smap`` on the ranks' slices (the all-to-all's backward,
    ``copy_to_model`` and ``reduce_from_model``), gathered, against
    ``jax.grad`` through the reference's ``shard_map`` strategies, to
    1e-5; every rank gathers the same bits."""
    jx, ranks = results
    key = f"moe_{strat}_{cf}"
    for part in [f"d{k}" for k in MOE_W] + ["dx"]:
        want = jx[f"{key}_{part}"]
        got = _np(ranks[0][f"{key}_{part}"])
        np.testing.assert_allclose(got, want, **F32, err_msg=part)
        assert np.abs(want).max() > 0, part
        for r in range(1, WORLD):
            assert torch.equal(ranks[r][f"{key}_{part}"],
                               ranks[0][f"{key}_{part}"]), (part, r)


# ---------------------------------------------------------------------------
# specs (in-process; JAX's on an AbstractMesh)
# ---------------------------------------------------------------------------

SPEC_MESHES = [((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data",
                                                          "model")),
               ((16, 16), ("data", "model")), ((4,), ("data",))]


def _jax_layers_as_port(jspecs, n_rep):
    """The JAX package's stacked spec tree in the port's layout: one dict
    a layer, repetition-major, the stacked lead axis dropped."""
    import jax
    from jax.sharding import PartitionSpec as P

    def conv(tree, drop):
        return jax.tree.map(lambda p: P(*tuple(p)[drop:]), tree,
                            is_leaf=lambda t: isinstance(t, P))
    layers = []
    for r in range(n_rep):
        for stage in jspecs["stages"]:
            layers.append(conv(stage, 1))
    layers.extend(conv(t, 0) for t in jspecs["tail"])
    return layers


def _plain(tree):
    """A JAX spec tree in the port's containers: P as a tuple, tuples of
    subtrees as lists."""
    from jax.sharding import PartitionSpec as P
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return [_plain(v) for v in tree]


@pytest.mark.parametrize("tp", [1, 2, 16])
@pytest.mark.parametrize("arch", [
    "gemma3_27b", "minitron_4b", "llama3_2_1b", "qwen3_1_7b", "qwen2_vl_2b",
    "phi3_5_moe", "dbrx_132b", "whisper_base", "xlstm_350m",
    "recurrentgemma_2b"])
def test_tree_pspecs_match_jax(arch, tp):
    """``tree_pspecs`` of every arch's full config, of its parameters and
    of its states (whisper's included), on four meshes, equals the JAX
    package's on an ``AbstractMesh`` with the stacked lead axis
    dropped."""
    pytest.importorskip("jax")
    from jax.sharding import AbstractMesh
    from repro.config import resolve
    from repro.configs import get_config
    from repro.distributed import sharding as jsh
    from repro.models.model import LM
    from repro.models.runtime import Runtime
    from repro.models.whisper import WhisperModel
    from repro_torch.config import resolve as t_resolve
    from repro_torch.configs import ARCHS, get_config as t_get_config
    from repro_torch.models.model import LM as TLM
    from repro_torch.models.whisper import WhisperModel as TW
    assert arch in ARCHS
    cfg, tcfg = get_config(arch), t_get_config(arch)
    if cfg.family == "audio":
        jm = WhisperModel(resolve(cfg, tp=tp), Runtime())
        tm = TW(t_resolve(tcfg, tp=tp), device="cpu")
    else:
        jm = LM(resolve(cfg, tp=tp), Runtime())
        tm = TLM(t_resolve(tcfg, tp=tp), device="cpu")
    for shape, axes in SPEC_MESHES:
        jt = jsh.tree_pspecs(jm.param_specs(), AbstractMesh(shape, axes))
        tt = tsh.tree_pspecs(tm.param_specs(), MeshShape(shape, axes))
        if cfg.family == "audio":
            want = _plain(jt)
        else:
            want = {"embed": _plain(jt["embed"]),
                    "final_norm": _plain(jt["final_norm"]),
                    "layers": _plain(_jax_layers_as_port(jt, jm.n_rep))}
        assert tt == want, (arch, shape)
        for bs in (False, True):
            for ss in (False, True):
                js = jsh.tree_pspecs(jm.state_specs(
                    batch_sharded=bs, seq_sharded=ss),
                    AbstractMesh(shape, axes))
                ts = tsh.tree_pspecs(tm.state_specs(
                    batch_sharded=bs, seq_sharded=ss), MeshShape(shape, axes))
                want = _plain(js) if cfg.family == "audio" else \
                    _plain(_jax_layers_as_port(js, jm.n_rep))
                assert ts == want, (arch, shape, bs, ss)


PROD_MESHES = [((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model"))]


def _shard_shape(shape, pspec, sizes):
    out = []
    for d, dim in enumerate(shape):
        e = pspec[d] if d < len(pspec) else None
        n = 1
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n *= sizes[a]
        out.append(dim // n)
    return tuple(out)


def _jax_local(structs, pspecs, sizes):
    """ShapeDtypeStructs at one device's shard shapes."""
    import jax
    from jax.sharding import PartitionSpec as P
    return jax.tree.map(
        lambda p, s: jax.ShapeDtypeStruct(_shard_shape(s.shape, tuple(p),
                                                       sizes), s.dtype),
        pspecs, structs, is_leaf=lambda t: isinstance(t, P))


def _unstack_structs(tree, n_rep):
    """A stacked JAX tree of ShapeDtypeStructs in the port's per-layer
    layout (the lead axis of the stage leaves dropped)."""
    import jax
    layers = [jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape[1:],
                                                          s.dtype), stage)
              for _ in range(n_rep) for stage in tree["stages"]]
    return layers + list(tree["tail"])


def _shapes(tree):
    from repro_torch.tree import leaves_with_paths
    return {k: tuple(t.shape) for k, t in leaves_with_paths(tree)}


@pytest.mark.parametrize("arch", [
    "gemma3_27b", "minitron_4b", "llama3_2_1b", "qwen3_1_7b", "qwen2_vl_2b",
    "phi3_5_moe", "dbrx_132b", "whisper_base", "xlstm_350m",
    "recurrentgemma_2b"])
def test_build_case_local_shapes_match_jax(arch):
    """``launch/specs.build_case``'s meta stand-ins, for every supported
    shape of the arch's full config on both production meshes, have one
    rank's shard shapes of the JAX package's layout: parameters and serve
    states by ``tree_pspecs`` (the stacked lead axis dropped), the batch
    by its ``_batch_pspecs``, decode tokens by ``batch_pspec``; the ZeRO-1
    moments by its ``zero_pspec`` of each port leaf's global shape (the
    port has no stacked layer axis to put ``data`` on)."""
    pytest.importorskip("jax")
    import jax
    from jax.sharding import AbstractMesh, PartitionSpec as P
    from repro.config import SHAPES, resolve
    from repro.configs import get_config
    from repro.distributed import sharding as jsh
    from repro.launch import specs as jspecs
    from repro.models.model import LM
    from repro.models.runtime import Runtime
    from repro.models.whisper import WhisperModel
    from repro_torch.launch.specs import build_case
    from repro_torch.tree import leaves_with_paths
    cfg = get_config(arch)
    audio = cfg.family == "audio"
    rc = resolve(cfg, tp=16)
    jm = WhisperModel(rc, Runtime()) if audio else LM(rc, Runtime())
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))

    def as_port(tree):
        if audio:
            return tree
        return {k: v for k, v in tree.items() if k not in ("stages", "tail")} \
            | {"layers": _unstack_structs(tree, jm.n_rep)}

    def port_states(tree):
        return tree if audio else _unstack_structs(tree, jm.n_rep)

    for shape, axes in PROD_MESHES:
        jmesh, tmesh = AbstractMesh(shape, axes), MeshShape(shape, axes)
        sizes = dict(zip(axes, shape))
        pspecs = jsh.tree_pspecs(jm.param_specs(), jmesh)
        want_params = _shapes(as_port(_jax_local(params, pspecs, sizes)))
        glob = as_port(params)
        port_specs = _plain(pspecs) if audio else {
            "embed": _plain(pspecs["embed"]),
            "final_norm": _plain(pspecs["final_norm"]),
            "layers": _plain(_jax_layers_as_port(pspecs, jm.n_rep))}
        for sh_name in cfg.supported_shapes:
            sh = SHAPES[sh_name]
            case = build_case(arch, sh_name, tmesh, device="cpu")
            assert _shapes(case.args[0]) == want_params, (sh_name, shape)
            batch = jspecs._batch_structs(rc, sh_name)
            bspecs = jspecs._batch_pspecs(rc, sh_name, jmesh)
            want_batch = {k: _shard_shape(v.shape, tuple(bspecs[k]), sizes)
                          for k, v in batch.items()}
            if sh.kind == "train":
                spec_of = dict(_spec_leaves(port_specs))
                for k, g in leaves_with_paths(glob):
                    z = jsh.zero_pspec(P(*spec_of[k]), g.shape, jmesh)
                    for part in (case.args[1].mu, case.args[1].nu):
                        got = _shapes(part)[k]
                        assert got == _shard_shape(g.shape, tuple(z),
                                                   sizes), (sh_name, k)
                assert _shapes(case.args[2]) == want_batch, sh_name
                continue
            bs = sh.global_batch % jspecs.dp_size(jmesh) == 0
            st_specs = jsh.tree_pspecs(jm.state_specs(
                batch_sharded=bs, seq_sharded=(sh_name == "long_500k")),
                jmesh)
            if sh.kind == "prefill":
                want_batch.pop("labels")
                assert _shapes(case.args[1]) == want_batch, sh_name
                continue
            states = jm.state_shapes(sh.global_batch, sh.seq_len)
            want_states = _shapes(port_states(_jax_local(states, st_specs,
                                                         sizes)))
            assert _shapes(case.args[2]) == want_states, (sh_name, shape)
            dp = jsh.batch_pspec(jmesh)[0] if bs else None
            tok = _shard_shape((sh.global_batch,), (dp,), sizes)
            assert tuple(case.args[1].shape) == tok == \
                tuple(case.args[3].shape)


def test_spec_kv_cache_and_moe_specs_match_jax():
    from repro.models import attention as ja
    from repro.models import moe as jm
    from repro_torch.models import attention as ta
    for kv in (False, True):
        for sp in (False, True):
            assert ta.spec_kv_cache(kv, sp) == ja.spec_kv_cache(kv, sp)
    for strat in ("tp_dense", "tp_smap", "ep_a2a"):
        assert tmoe.spec_moe(strat) == jm.spec_moe(strat)


def test_logical_zero_and_batch_pspecs_match_jax():
    """``logical_to_pspec``, ``zero_pspec`` (every leaf of each reduced
    arch's port tree, with its shape) and ``batch_pspec`` equal the JAX
    package's on the same inputs."""
    pytest.importorskip("jax")
    from jax.sharding import AbstractMesh, PartitionSpec as P
    from repro.distributed import sharding as jsh
    from repro_torch.config import resolve as t_resolve
    from repro_torch.configs import ARCHS, get_reduced
    from repro_torch.models.model import LM as TLM
    from repro_torch.models.whisper import WhisperModel as TW
    from repro_torch.tree import leaves, leaves_with_paths
    logicals = [("dp", None), ("tp", None, "ep"), ("sp", "dp_only"),
                (None,), ("dp", "sp", "tp", None)]
    models = []
    for arch in ARCHS:
        cfg = get_reduced(arch, dtype="float32")
        rc = t_resolve(cfg, tp=2)
        m = TW(rc, device="cpu") if cfg.family == "audio" else \
            TLM(rc, device="cpu")
        models.append((arch, m, m.init(seed=0)))
    for shape, axes in SPEC_MESHES:
        jmesh, tmesh = AbstractMesh(shape, axes), MeshShape(shape, axes)
        for lg in logicals:
            assert tsh.logical_to_pspec(lg, tmesh) == \
                tuple(jsh.logical_to_pspec(lg, jmesh))
        with pytest.raises(ValueError):
            tsh.logical_to_pspec(("bogus",), tmesh)
        for trail in ((), (None,), (None, "model")):
            assert tsh.batch_pspec(tmesh, *trail) == \
                tuple(jsh.batch_pspec(jmesh, *trail))
        for arch, m, params in models:
            specs = tsh.tree_pspecs(m.param_specs(), tmesh)
            zeros = tsh.zero_tree_pspecs(specs, params, tmesh)
            assert [k for k, _ in _spec_leaves(specs)] == \
                [k for k, _ in leaves_with_paths(params)], arch
            for (_, sp), (_, z), t in zip(_spec_leaves(specs),
                                          _spec_leaves(zeros),
                                          leaves(params)):
                want = tuple(jsh.zero_pspec(P(*sp), tuple(t.shape), jmesh))
                assert tsh.zero_pspec(sp, tuple(t.shape), tmesh) == want
                assert z == want


def _spec_leaves(tree, prefix=""):
    """[(path, spec)] of a port spec tree, paths as ``leaves_with_paths``
    names them."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return [x for k, v in items
                for x in _spec_leaves(v, f"{prefix}/{k}" if prefix
                                      else str(k))]
    return [(prefix, tree)]


def test_a_cuda_world_raises_without_a_gpu():
    """The default backend is NCCL on the card: asked for without one,
    the world and the host mesh raise instead of falling back to gloo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.distributed.compat import init_world
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_world()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh(data=2)
    with pytest.raises(ValueError, match="unsupported device"):
        init_world("tpu")


def test_production_mesh_is_a_shape():
    from repro_torch.launch.mesh import (dp_axes, make_production_mesh,
                                         mesh_axis_size)
    m = make_production_mesh()
    assert m.shape == (16, 16) and dp_axes(m) == ("data",)
    mp = make_production_mesh(multi_pod=True)
    assert dp_axes(mp) == ("pod", "data")
    assert mesh_axis_size(mp, "pod") == 2 and mesh_axis_size(m, "pod") == 1


def test_local_shard_cuts_in_device_order():
    """A dimension over ("data", "model") takes chunk i_data * n_model +
    i_model (the JAX package's device order), from ``shard_slices``."""

    class FakeMesh:                  # a DeviceMesh's surface, one rank's
        def __init__(self, shape, names, coord):
            self.shape, self.mesh_dim_names, self.coord = shape, names, coord

        def get_local_rank(self, name):
            return self.coord[self.mesh_dim_names.index(name)]

    x = torch.arange(48.0).reshape(8, 6)
    for i in range(4):
        for j in range(2):
            m = FakeMesh((4, 2), ("data", "model"), coord=(i, j))
            got = tsh.local_shard(x, (("data", "model"), "model"), m)
            r = i * 2 + j
            assert torch.equal(got, x[r:r + 1, j * 3:(j + 1) * 3])
    with pytest.raises(ValueError):
        tsh.shard_slices((5, 6), ("data", None),
                         FakeMesh((4, 2), ("data", "model"), coord=(0, 0)))


# ---------------------------------------------------------------------------
# fault planning (a copy of the JAX package's, held identical)
# ---------------------------------------------------------------------------

def test_heartbeat_monitor_on_a_fake_clock():
    from repro.distributed import fault as jf
    script = [("a", 0.0), ("b", 0.0), ("c", 0.0), ("a", 1.0), ("b", 1.0),
              ("c", 3.0), ("a", 2.0), ("b", 2.0), ("c", 6.0), ("a", 3.0),
              ("b", 3.0), ("c", 9.0), ("a", 4.0), ("b", 4.1), ("a", 40.0)]
    for timeout, factor in ((30.0, 2.0), (5.0, 1.5), (100.0, 4.0)):
        now = {"t": 0.0}
        clock = lambda: now["t"]  # noqa: E731
        mons = [m.HeartbeatMonitor(timeout_s=timeout, straggler_factor=factor,
                                   clock=clock) for m in (tfault, jf)]
        for who, t in script:
            now["t"] = t
            for mon in mons:
                mon.beat(who)
            assert mons[0].dead() == mons[1].dead()
            assert mons[0].stragglers() == mons[1].stragglers()
        assert mons[0].dead() == ["b", "c"] or timeout != 30.0


def test_plan_remesh_identical():
    from repro.distributed import fault as jf
    assert tfault.SUPPORTED_MESHES == jf.SUPPORTED_MESHES
    for old_dp in (1, 4, 16):
        for chips in range(0, 601):
            a, b = tfault.plan_remesh(chips, old_dp), jf.plan_remesh(
                chips, old_dp)
            if b is None:
                assert a is None
                continue
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
            assert a.dp_size() == b.dp_size()


def test_straggler_policy_identical():
    from repro.distributed import fault as jf
    cases = [{}, {0: 1.0}, {0: 10.0, 1: 10.0, 2: 3.0, 3: 9.0},
             {0: 0.0, 1: 5.0, 2: 5.0}, {i: float(i + 1) for i in range(9)}]
    for thr in (1.5, 2.0, 3.0):
        for rates in cases:
            assert tfault.StragglerPolicy(thr).migrations(rates) == \
                jf.StragglerPolicy(thr).migrations(rates)


# ---------------------------------------------------------------------------
# the LSE kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,S,Hq,Hkv,Dh", [
    (dt, *shape) for dt in (torch.float32, torch.bfloat16)
    for shape in ((8, 1088, 32, 8, 64), (2, 256, 8, 2, 64),
                  (3, 1000, 16, 8, 128), (2, 520, 10, 1, 256))])
def test_cuda_decode_attention_lse_matches_plain(cuda, dtype, B, S, Hq, Hkv,
                                                 Dh):
    """The kernel's LSE mode at the split-KV chunk edges: m exact where no
    key is seen (-inf) and within 1e-5 elsewhere, l within 1e-5 relative,
    acc within 1e-5 of l (acc / l is a convex mix of values); two calls
    bitwise; ``acc / max(l, 1e-30)`` bitwise the normal mode's output."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, Hq, Dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).to(dtype)
    C = tdec.KV_CHUNK
    lens = [0, 1, C - 1, C, C + 1, 2 * C, S, S + 5][:B] + [S] * max(0, B - 8)
    kl = torch.tensor(lens[:B], dtype=torch.int32, device=cuda)
    before = tdec.LAUNCHES["decode_attention_lse"]
    got = tops.decode_attention_lse(q, k, v, kl)
    assert tdec.LAUNCHES["decode_attention_lse"] == before + 1
    want = tdec.decode_attention_lse_plain(q, k, v, kl)
    assert torch.equal(torch.isneginf(got[..., -1]),
                       torch.isneginf(want[..., -1]))
    live = ~torch.isneginf(want[..., -1])
    torch.testing.assert_close(got[..., -1][live], want[..., -1][live],
                               atol=1e-5, rtol=0)
    l = want[..., -2]
    l_rel = ((got[..., -2] - l).abs() / l.clamp_min(1e-30))[live]
    assert l_rel.numel() == 0 or float(l_rel.max()) <= 1e-5
    assert float(((got[..., :Dh] - want[..., :Dh]).abs()
                  / l.clamp_min(1e-30)[..., None]).max()) <= 1e-5
    assert torch.equal(tops.decode_attention_lse(q, k, v, kl), got)
    norm = (got[..., :Dh] / got[..., -2:-1].clamp_min(1e-30)).to(dtype)
    assert torch.equal(norm, tops.decode_attention(q, k, v, kl))


@pytest.mark.cuda
def test_cuda_sp_merge_of_shards_matches_decode(cuda):
    """Four seq shards through the LSE kernel, merged by
    ``collectives.merge_lse``, against the kernel over the whole cache."""
    g = torch.Generator(device=cuda).manual_seed(1)
    B, S, Hq, Hkv, Dh, n = 2, 4096, 32, 8, 64, 4
    q = torch.randn((B, Hq, Dh), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).bfloat16()
    s = S // n
    for lens in ([0, 4096], [1, 1023], [1024, 1025], [3000, 2048]):
        kl = torch.tensor(lens, dtype=torch.int32, device=cuda)
        parts = [tops.decode_attention_lse(
            q, k[:, i * s:(i + 1) * s], v[:, i * s:(i + 1) * s],
            torch.clamp(kl - i * s, 0, s)) for i in range(n)]
        merged = tcol.merge_lse(parts, q.dtype)
        torch.testing.assert_close(
            merged.float(), tops.decode_attention(q, k, v, kl).float(),
            atol=1e-4, rtol=2 ** -7)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        _jax_side(sys.argv[2])
