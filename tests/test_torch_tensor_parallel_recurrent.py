"""Tensor parallelism of the recurrent mixers, of whisper and of a
sequence-parallel cache, on 8 gloo ranks, held against the JAX package's
unsharded computation.

One spawned world of 8 ranks (``file://`` rendezvous, spawn, timeouts on
the join and the collectives; rank bodies at module level, results
through ``torch.save``) runs, on a 4 x 2 and a 2 x 4 ``data`` x
``model`` mesh, reduced f32 models resolved at ``tp`` = the model axis
(vocab 510, which both meshes pad to 512):

* xlstm (one mLSTM and one sLSTM layer) with 2 heads, so that at ``tp``
  4 a head spans two ranks as at production (4 heads over 16): q, k, v
  and the mLSTM's rows of h gathered, ``q . n`` all-reduced, the sLSTM's
  h gathered a token; at ``tp`` 2 each rank holds a whole sLSTM head;
* recurrentgemma (two RG-LRU layers and one sliding-window layer of
  window 8), whose single MQA KV head is replicated over ``model``;
* whisper (2 encoder and 2 decoder layers, 64 frames): the encoder, the
  self-attention caches of the rank's KV heads, cross-attention over the
  rank's heads of the encoder K/V, the vocab-parallel head and loss.

For each: ``launch/specs.build_case(..., "train_4k", mesh)``'s
tensor-parallel + ZeRO-1 step against JAX's unsharded
``value_and_grad`` of the mean of the data shards' losses plus
``adamw_update`` (loss 1e-5 relative, gathered gradients within
``GRAD_REL`` 2e-5 of each leaf's peak, parameters and moments 1e-6, two
runs bitwise, the meta stand-ins' shapes); and the sharded model's
``prefill`` (of ``PROMPT`` tokens into caches of ``S_ALLOC``) plus
``DECODE`` ``decode_step``s against JAX's unsharded ones: the gathered
logits of every step and every gathered state leaf after the last
within 1e-5, each rank's states of the shapes ``build_case`` cuts.  On
2 x 4 also gemma3's ``long_500k`` layout (``LM(sp_decode=True)``
sharded: a global layer's cache cut over ``data`` along its sequence and
over ``model`` along its KV heads, a sliding-window layer's ring of
window 8) against JAX's decode.  The yardstick is a subprocess of this
file (``--jax``).  About 60 s on 8 CPU cores.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import resolve as t_resolve  # noqa: E402
from repro_torch.configs import get_reduced as t_get_reduced  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.distributed.compat import run_world  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
MESHES = {"4x2": (4, 2), "2x4": (2, 4)}
MODELS = ("xlstm", "rgemma", "whisper")
ARCH = {"xlstm": "xlstm_350m", "rgemma": "recurrentgemma_2b",
        "whisper": "whisper_base", "gemma3": "gemma3_27b"}
GLOBAL_B, SEQ, VOCAB = 8, 32, 510
PROMPT, DECODE, S_ALLOC = 16, 3, 32
SP_MESH = "2x4"
GRAD_REL = 2e-5
TOL = dict(atol=1e-5, rtol=1e-5)
TIMEOUT = 300.0


def _config(name, configs):
    """The reduced f32 configuration of one case, from either package's
    registry (``configs`` is its ``get_reduced``)."""
    kw = dict(dtype="float32", vocab_size=VOCAB)
    if name == "xlstm":
        kw.update(num_layers=2, num_heads=2)
    elif name == "rgemma":
        kw.update(num_layers=3, sliding_window=8)
    elif name == "gemma3":
        kw.update(num_layers=2, sliding_window=8,
                  block_pattern=("attn_local", "attn_full"))
    return configs(ARCH[name], **kw)


def _registry_gives(cfg):
    """``launch/specs`` building its models from ``cfg``, a reduced
    configuration, in place of the registry's full one."""
    from unittest import mock

    from repro_torch.launch import specs
    return mock.patch.object(specs, "get_config", lambda arch: cfg)


def _inputs(name):
    """The training batch and the decode inputs (prompt, tokens), with
    whisper's frame embeddings."""
    r = np.random.default_rng(3)
    seq = r.integers(0, VOCAB, (GLOBAL_B, SEQ + 1)).astype(np.int32)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    prompt = {"tokens": r.integers(9, VOCAB, (GLOBAL_B, PROMPT)).astype(
        np.int32)}
    toks = r.integers(9, VOCAB, (DECODE, GLOBAL_B)).astype(np.int32)
    if name == "whisper":
        cfg = _config(name, t_get_reduced)
        frames = (0.02 * r.standard_normal(
            (GLOBAL_B, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
        batch["frame_emb"] = prompt["frame_emb"] = frames
    return batch, prompt, toks


def _flat(tree, prefix):
    """{path: array} of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _unflat(flat, prefix):
    """The tree under ``prefix`` back from ``_flat`` (int-keyed levels as
    lists; an empty JAX tail leaves no key)."""
    root = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = root, key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    tree = lists(root)
    if "stages" in tree:
        tree.setdefault("tail", [])
    return tree


def _to_jax(name, tree, n_rep, period):
    """A port parameter tree (numpy) in the JAX package's layout: an LM's
    first ``n_rep * period`` layers stacked into ``period`` stages, the
    rest as the tail; whisper's layer lists as tuples."""
    import jax
    if name == "whisper":
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in tree.items()}
    layers = tree["layers"]
    stages = [jax.tree.map(lambda *xs: np.stack(xs),
                           *[layers[r * period + p] for r in range(n_rep)])
              for p in range(period if n_rep else 0)]
    return {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "stages": stages, "tail": layers[n_rep * period:]}


def _cases():
    return [(m, n) for m in MESHES for n in MODELS] + [(SP_MESH, "gemma3")]


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_model(name, nm):
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.models.model import LM
    from repro.models.runtime import CPU_TEST
    from repro.models.whisper import WhisperModel
    cfg = _config(name, get_reduced)
    cls = WhisperModel if name == "whisper" else LM
    return cls(resolve(cfg, tp=nm), CPU_TEST), cfg


def _jax_side(params_path, out_path):
    import jax
    import jax.numpy as jnp
    from repro.train.optimizer import OptimizerConfig, adamw_update, \
        init_opt_state

    out = {}
    flat = dict(np.load(params_path))
    for mname, name in _cases():
        nd, nm = MESHES[mname]
        jm, cfg = _jax_model(name, nm)
        key = f"{mname}/{name}"
        tree = _unflat(flat, key)
        n_rep = cfg.num_layers // len(cfg.block_pattern)
        params = jax.tree.map(jnp.asarray, _to_jax(
            name, tree, n_rep, len(cfg.block_pattern)))
        batch, prompt, toks = (jax.tree.map(jnp.asarray, x)
                               for x in _inputs(name))
        if name != "gemma3":
            shards = {k: v.reshape(nd, GLOBAL_B // nd, *v.shape[1:])
                      for k, v in batch.items()}

            def step(p):
                loss, g = jax.value_and_grad(lambda q: jnp.mean(
                    jax.vmap(lambda b: jm.loss(q, b))(shards)))(p)
                new, opt, _ = adamw_update(OptimizerConfig(), p, g,
                                           init_opt_state(p))
                return loss, g, new, opt
            loss, grads, new, opt = jax.jit(step)(params)
            out.update(_flat(grads, key + "/grads"))
            out.update(_flat(new, key + "/after"))
            out.update(_flat(opt.mu, key + "/mu"))
            out.update(_flat(opt.nu, key + "/nu"))
            out[key + "/loss"] = np.asarray(loss)
        logits, states = jax.jit(lambda p, b: jm.prefill(
            p, b, s_alloc=S_ALLOC))(params, prompt)
        seen = [np.asarray(logits)]
        step = jax.jit(jm.decode_step)
        for i in range(DECODE):
            pos = jnp.full((GLOBAL_B,), PROMPT + i, jnp.int32)
            logits, states = step(params, toks[i], states, pos)
            seen.append(np.asarray(logits))
        out[key + "/logits"] = np.stack(seen)
        out.update(_flat(states, key + "/states"))
    np.savez(out_path, **out)


def _model(name, nm):
    from repro_torch.models.model import LM
    from repro_torch.models.whisper import WhisperModel
    cls = WhisperModel if name == "whisper" else LM
    return cls(t_resolve(_config(name, t_get_reduced), tp=nm), device="cpu")


def _init_params(path):
    """Every case's full parameters from the port's ``init`` (seed 11),
    as numpy: the one input both sides read."""
    out = {}
    for mname, name in _cases():
        m = _model(name, MESHES[mname][1])
        out.update(_flat(_tree_np(m.init(11)), f"{mname}/{name}"))
    np.savez(path, **out)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_np(v) for v in tree]
    return tree.numpy()


# ---------------------------------------------------------------------------
# the port's world
# ---------------------------------------------------------------------------

def _gathered(tree, specs, mesh):
    """{path: the full array} of a tree of shards, ``specs`` in leaf
    order."""
    from repro_torch.tree import leaves_with_paths
    return {k: tsh.gather_full(t.detach(), s, mesh)
            for (k, t), s in zip(leaves_with_paths(tree), specs)}


def _leaves(tree):
    from repro_torch.tree import leaves
    return leaves(tree)


def _train(name, mname, mesh, full, batch):
    """``build_case``'s train step: gathered gradients, the step's loss,
    its updated parameters and moments (gathered), twice bitwise, meta
    shapes checked."""
    from repro_torch.launch.specs import build_case, make_model
    from repro_torch.models.convert import shard_params
    from repro_torch.train.optimizer import init_opt_state, zero_layout
    from repro_torch.train.train_loop import local_batch, \
        zero_reduce_grads
    from repro_torch.tree import leaves_with_paths, tree_map
    cfg = _config(name, t_get_reduced)
    with _registry_gives(cfg):
        model, _ = make_model(ARCH[name], mesh, "train_4k", device="cpu")
        case = build_case(ARCH[name], "train_4k", mesh, device="cpu")
    params = shard_params(full, model, mesh)
    lb = local_batch(batch, mesh)
    layout = zero_layout(params, tsh.tree_pspecs(model.param_specs(), mesh),
                         mesh)
    out = {}
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = model.loss(live, lb)
    grads = torch.autograd.grad(loss, _leaves(live))
    it = iter(grads)
    red = zero_reduce_grads(tree_map(lambda _: next(it), params), layout)
    out["grads"] = _gathered(red, [zl.zspec if zl.dim is not None
                                   else zl.spec for zl in layout.leaves],
                             mesh)
    runs = []
    for _ in range(2):
        p = tree_map(torch.clone, params)
        opt = init_opt_state(p, layout)
        meta = dict(leaves_with_paths(case.args[:2]))
        out["meta_ok"] = all(
            a.shape == meta[k].shape and a.dtype == meta[k].dtype
            for k, a in leaves_with_paths((p, opt)))
        runs.append(case.fn(p, opt, lb))
    (p, opt, met), (p2, opt2, met2) = runs
    out["bitwise"] = torch.equal(met["loss"], met2["loss"]) and all(
        torch.equal(a, b) for a, b in zip(_leaves((p, opt)),
                                          _leaves((p2, opt2))))
    zspecs = [zl.zspec for zl in layout.leaves]
    out["loss"] = met["loss"]
    out["after"] = _gathered(p, [zl.spec for zl in layout.leaves], mesh)
    out["mu"] = _gathered(opt.mu, zspecs, mesh)
    out["nu"] = _gathered(opt.nu, zspecs, mesh)
    return out


def _decode(name, mesh, full, prompt, toks):
    """The sharded model's prefill and decode steps: the gathered logits
    of every step, the gathered states after the last, and whether the
    rank's states have the shapes ``build_case`` cuts."""
    from repro_torch.launch.specs import _local_structs, _unsharded, \
        make_model
    from repro_torch.models.convert import shard_params
    from repro_torch.train.train_loop import local_batch
    from repro_torch.tree import leaves
    sp = name == "gemma3"
    shape = "long_500k" if sp else "decode_32k"
    with _registry_gives(_config(name, t_get_reduced)):
        model, _ = make_model(ARCH[name], mesh, shape, device="cpu")
    assert model.sharded and (getattr(model, "sp_decode", False) == sp)
    params = shard_params(full, model, mesh)
    prompt = {k: torch.from_numpy(v) for k, v in prompt.items()}
    toks = torch.from_numpy(toks)
    if sp:            # the batch replicated, the caches cut along S
        dp, cut = None, (lambda t: t)
    else:
        dp = tsh.batch_pspec(mesh)[0]
        prompt = local_batch(prompt, mesh)

        def cut(t):
            return tsh.local_shard(t, (dp,), mesh)
    logits, states = model.prefill(params, prompt, s_alloc=S_ALLOC)
    seen = [logits]
    for i in range(DECODE):
        tok = cut(toks[i])
        pos = torch.full(tok.shape, PROMPT + i, dtype=torch.int32)
        logits, states = model.decode_step(params, tok, states, pos)
        seen.append(logits)
    st_specs = tsh.tree_pspecs(model.state_specs(
        batch_sharded=not sp, seq_sharded=sp), mesh)
    want = _local_structs(_unsharded(model).state_shapes(
        GLOBAL_B, S_ALLOC), st_specs, mesh)
    return {
        "logits": torch.stack([tsh.gather_full(lg, (dp, "model"), mesh)
                               for lg in seen]),
        "states": _gathered(states, tsh.spec_leaves(st_specs, states),
                            mesh),
        "states_ok": [(tuple(a.shape), a.dtype) for a in leaves(states)]
        == [(tuple(b.shape), b.dtype) for b in leaves(want)],
    }


def _rank_body(rank, world, d):
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.tree import tree_map
    torch.set_num_threads(1)
    start = dict(np.load(os.path.join(d, "params.npz")))
    out = {}
    meshes = {m: make_mesh(s, ("data", "model"), "cpu")
              for m, s in MESHES.items()}
    for mname, name in _cases():
        full = tree_map(torch.from_numpy, _unflat(start, f"{mname}/{name}"))
        batch, prompt, toks = _inputs(name)
        res = _decode(name, meshes[mname], full, prompt, toks)
        if name != "gemma3":
            res.update(_train(name, mname, meshes[mname], full,
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()}))
        out[f"{mname}/{name}"] = res
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX outputs, [each rank's outputs])."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("tp_rec")
    _init_params(d / "params.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    jax_proc = subprocess.Popen(
        [sys.executable, __file__, "--jax", str(d / "params.npz"),
         str(d / "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        run_world(_rank_body, WORLD, str(d), device_type="cpu",
                  init_method=f"file://{d / 'rdv'}", timeout_s=TIMEOUT)
        log, _ = jax_proc.communicate(timeout=TIMEOUT)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, log
    return (dict(np.load(d / "jax.npz")),
            [torch.load(d / f"rank{r}.pt") for r in range(WORLD)])


def _rcfg(name, mname):
    return t_resolve(_config(name, t_get_reduced), tp=MESHES[mname][1])


def _jax_leaves(jx, key, name, rcfg, states=False):
    """{path: array} of the JAX tree under ``key`` in the port's
    layout."""
    from repro_torch.models.convert import (from_jax_params,
                                            states_from_jax,
                                            whisper_from_jax)
    from repro_torch.tree import leaves_with_paths
    tree = _unflat(jx, key)
    if name == "whisper":
        port = whisper_from_jax(tree, "cpu")
    elif states:
        port = states_from_jax(tree, rcfg, "cpu")
    else:
        port = from_jax_params(tree, rcfg, "cpu")
    return dict(leaves_with_paths(port))


TRAIN = [(m, n) for m in MESHES for n in MODELS]


@pytest.mark.parametrize("mname,name", TRAIN)
def test_tp_recurrent_loss_and_grads_match_jax(results, mname, name):
    jx, ranks = results
    key = f"{mname}/{name}"
    want = float(jx[key + "/loss"])
    for r in range(WORLD):
        got = float(ranks[r][key]["loss"])
        assert abs(got - want) <= 1e-5 * abs(want), (r, got, want)
    ref = _jax_leaves(jx, key + "/grads", name, _rcfg(name, mname))
    got = ranks[0][key]["grads"]
    assert sorted(got) == sorted(ref)
    for i in ref:
        g, w = got[i], ref[i].numpy()
        assert g.shape == w.shape, i
        peak = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_REL * peak, (i, err, peak)


@pytest.mark.parametrize("mname,name", TRAIN)
def test_tp_recurrent_zero1_update_matches_jax(results, mname, name):
    """Updated parameters and the moments, gathered from each rank's
    ZeRO-1 slices, within 1e-6 of JAX's AdamW; every rank gathers the
    same bits; two runs bitwise; the meta stand-ins have the shapes and
    dtypes of the shards."""
    jx, ranks = results
    key = f"{mname}/{name}"
    rcfg = _rcfg(name, mname)
    for part in ("after", "mu", "nu"):
        ref = _jax_leaves(jx, f"{key}/{part}", name, rcfg)
        got = ranks[0][key][part]
        assert sorted(got) == sorted(ref)
        for i in ref:
            np.testing.assert_allclose(got[i].numpy(), ref[i].numpy(),
                                       atol=1e-6, rtol=0,
                                       err_msg=f"{part} {i}")
        for r in range(1, WORLD):
            assert all(torch.equal(ranks[r][key][part][i], got[i])
                       for i in got), r
    for r in range(WORLD):
        assert ranks[r][key]["bitwise"] and ranks[r][key]["meta_ok"], r


@pytest.mark.parametrize("mname,name", _cases())
def test_tp_prefill_and_decode_match_jax(results, mname, name):
    """The gathered logits of the prefill and of each decode step, and
    every gathered state leaf after the last step, within 1e-5 of JAX's
    unsharded prefill and decode steps (gemma3: the sequence-parallel
    cache under tensor parallelism); each rank's states have the shapes
    ``build_case`` cuts from ``state_specs``."""
    jx, ranks = results
    key = f"{mname}/{name}"
    for r in range(WORLD):
        got = ranks[r][key]
        assert got["states_ok"], r
        np.testing.assert_allclose(got["logits"].numpy(),
                                   jx[key + "/logits"], **TOL)
    ref = _jax_leaves(jx, key + "/states", name, _rcfg(name, mname),
                      states=True)
    got = ranks[0][key]["states"]
    assert sorted(got) == sorted(ref)
    for i in ref:
        np.testing.assert_allclose(got[i].numpy(), ref[i].numpy(), **TOL,
                                   err_msg=i)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        _jax_side(sys.argv[2], sys.argv[3])
