"""The port's tensor-parallel + ZeRO-1 training step on 8 gloo ranks,
held against the JAX package's unsharded step.

One spawned world of 8 ranks (``file://`` rendezvous, spawn, timeouts on
the join and the collectives; rank bodies at module level, results
through ``torch.save``) runs, on a 4 x 2 and a 2 x 4 ``data`` x
``model`` mesh, the train step that ``launch/specs.build_case(...,
"train_4k", mesh)`` builds, over reduced f32 models resolved at ``tp`` =
the model axis (vocab 510, which both meshes pad to 512):

* llama3.2-1b with its KV heads sharded (8 / 4 heads) and replicated
  (8 / tp // 2 heads, ``pad_kv_to_tp=False``, so ``padded_kv_heads <
  tp``: each rank takes the KV heads of its own query heads);
* gemma3 (its two first layers: sliding-window attention of window 8,
  QK-norm, the embedding scale);
* phi3.5-moe through ``tp_smap`` and dbrx through ``ep_a2a`` (the
  reference's dispatch with ``data`` > 1), each at capacity factor 8, so
  that neither they nor the yardstick's ``tp_dense`` drops an assignment
  (which assignments drop is what sets the strategies apart;
  ``test_torch_distributed.py`` holds their drops to JAX's).

The yardstick (a subprocess of this file, ``--jax``) is JAX's unsharded
``jax.value_and_grad`` of the mean over the data shards of ``LM.loss``
on each shard's rows, then ``adamw_update``: the reference's own sharded
step cannot run under JAX 0.9.0 (ROADMAP Queue 3).  For the dense models
that mean is the global batch's loss; for the MoE models it is what the
reference's ``shard_map`` strategies give under ``jax.grad`` (each data
shard's aux loss, averaged).  Tolerances, f32: loss 1e-5 relative; each
gradient leaf, gathered with ``gather_full`` from its ZeRO-1 slices,
within ``GRAD_REL`` 2e-5 of its peak; updated parameters and gathered
moments within 1e-6.  Also: the vocab-parallel loss alone and its
gradient against JAX's log-softmax over the padded vocab, the step's
meta stand-ins against the shards it really holds, and two runs bitwise
equal.  About 30 s on 8 CPU cores.
"""
import dataclasses
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
MODELS = ("llama_kv", "llama_rep", "gemma3", "phi", "dbrx")
ARCH = {"llama_kv": "llama3_2_1b", "llama_rep": "llama3_2_1b",
        "gemma3": "gemma3_27b", "phi": "phi3_5_moe", "dbrx": "dbrx_132b"}
GLOBAL_B, SEQ, VOCAB = 8, 32, 510
GRAD_REL = 2e-5
TIMEOUT = 300.0
XENT = dict(B=4, S=8, V=512)


def _config(name, tp, configs):
    """The reduced f32 configuration of one case, from either package's
    registry (``configs`` is its ``get_reduced``)."""
    kw = dict(dtype="float32", vocab_size=VOCAB, num_layers=2)
    if name == "llama_kv":
        kw.update(num_heads=8, num_kv_heads=4)
    elif name == "llama_rep":
        kw.update(num_heads=8, num_kv_heads=tp // 2, pad_kv_to_tp=False)
    elif name == "gemma3":
        kw.update(sliding_window=8)
    cfg = configs(ARCH[name], **kw)
    if cfg.moe is not None:
        strategy = "ep_a2a" if name == "dbrx" else "tp_dense"
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, strategy=strategy, capacity_factor=8.0))
    return cfg


def _registry_gives(cfg):
    """``launch/specs`` building its models from ``cfg``, a reduced
    configuration, in place of the registry's full one."""
    from unittest import mock

    from repro_torch.launch import specs
    return mock.patch.object(specs, "get_config", lambda arch: cfg)


def _batch():
    r = np.random.default_rng(3)
    seq = r.integers(0, VOCAB, (GLOBAL_B, SEQ + 1)).astype(np.int32)
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def _xent_inputs():
    r = np.random.default_rng(4)
    logits = 3 * r.standard_normal((XENT["B"], XENT["S"], XENT["V"]))
    labels = r.integers(0, VOCAB, (XENT["B"], XENT["S"]))
    return logits.astype(np.float32), labels.astype(np.int32)


def _flat(tree, prefix):
    """{path: array} of a JAX pytree of dicts and tuples."""
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
    lists; empty JAX stages or tail leave no keys)."""
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
    if "layers" not in tree:             # the JAX layout
        tree.setdefault("stages", [])
        tree.setdefault("tail", [])
    return tree


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _to_jax(tree, n_rep, period):
    """A port parameter tree (numpy) in the JAX package's layout: the
    first ``n_rep * period`` layers stacked into ``period`` stages, the
    rest as the tail."""
    import jax
    layers = tree["layers"]
    stages = [jax.tree.map(lambda *xs: np.stack(xs),
                           *[layers[r * period + p] for r in range(n_rep)])
              for p in range(period if n_rep else 0)]
    return {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "stages": stages, "tail": layers[n_rep * period:]}


def _jax_side(params_path, out_path):
    import jax
    import jax.numpy as jnp
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.models.model import LM
    from repro.models.runtime import CPU_TEST
    from repro.train.optimizer import OptimizerConfig, adamw_update, \
        init_opt_state

    out = {}
    flat = dict(np.load(params_path))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    for mname, (nd, nm) in MESHES.items():
        for name in MODELS:
            cfg = _config(name, nm, get_reduced)
            jm = LM(resolve(cfg, tp=nm), CPU_TEST)
            key = f"{mname}/{name}"
            params = jax.tree.map(jnp.asarray, _to_jax(
                _unflat(flat, key), jm.n_rep, len(cfg.block_pattern)))
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
    logits, labels = _xent_inputs()

    def xent(lg):
        logp = jax.nn.log_softmax(lg, axis=-1)
        return -jnp.mean(jnp.sum(jax.nn.one_hot(labels, XENT["V"]) * logp,
                                 -1))
    loss, g = jax.value_and_grad(xent)(jnp.asarray(logits))
    out["xent/loss"], out["xent/grad"] = np.asarray(loss), np.asarray(g)
    np.savez(out_path, **out)


def _init_params(path):
    """Every case's full parameters from the port's ``init`` (seed 11),
    as numpy: the one input both sides read."""
    from repro_torch.models.model import LM as TLM
    out = {}
    for mname, (_, nm) in MESHES.items():
        for name in MODELS:
            m = TLM(t_resolve(_config(name, nm, t_get_reduced), tp=nm),
                    device="cpu")
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


def _case(name, mname, mesh, start, batch):
    """One model on one mesh: gathered gradients, the step's loss, its
    updated parameters and moments (gathered), meta shapes checked."""
    from repro_torch.launch.specs import build_case, make_model
    from repro_torch.models.convert import shard_params
    from repro_torch.train.optimizer import init_opt_state, zero_layout
    from repro_torch.train.train_loop import local_batch, \
        zero_reduce_grads
    from repro_torch.tree import leaves_with_paths, tree_map
    nm = MESHES[mname][1]
    cfg = _config(name, nm, t_get_reduced)
    with _registry_gives(cfg):
        model, rcfg = make_model(ARCH[name], mesh, "train_4k", device="cpu")
    full = tree_map(torch.from_numpy, _unflat(start, f"{mname}/{name}"))
    params = shard_params(full, model, mesh)
    lb = local_batch(batch, mesh)
    pspecs = tsh.tree_pspecs(model.param_specs(), mesh)
    layout = zero_layout(params, pspecs, mesh)
    out = {}
    # gradients: autograd on this rank's loss, then the ZeRO-1 reduction
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = model.loss(live, lb)
    grads = torch.autograd.grad(loss, _leaves(live))
    it = iter(grads)
    red = zero_reduce_grads(tree_map(lambda _: next(it), params), layout)
    gspecs = [zl.zspec if zl.dim is not None else zl.spec
              for zl in layout.leaves]
    out["grads"] = _gathered(red, gspecs, mesh)
    # the step build_case gives, twice from the same start
    with _registry_gives(cfg):
        case = build_case(ARCH[name], "train_4k", mesh, device="cpu")
    runs = []
    for _ in range(2):
        p = tree_map(torch.clone, params)
        opt = init_opt_state(p, layout)
        meta = dict(leaves_with_paths(case.args[:2]))
        out["meta_ok"] = all(
            a.shape == meta[k].shape and a.dtype == meta[k].dtype
            for k, a in leaves_with_paths((p, opt)))
        p, opt, met = case.fn(p, opt, lb)
        runs.append((p, opt, met))
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


def _rank_body(rank, world, d):
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.models.model import vocab_parallel_xent
    torch.set_num_threads(1)
    start = dict(np.load(os.path.join(d, "params.npz")))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    out = {}
    for mname, shape in MESHES.items():
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        for name in MODELS:
            out[f"{mname}/{name}"] = _case(name, mname, mesh, start, batch)
        logits, labels = _xent_inputs()
        spec = (None, None, "model")
        lg = tsh.local_shard(torch.from_numpy(logits), spec, mesh)
        lg.requires_grad_(True)
        loss = vocab_parallel_xent(lg, {"labels": torch.from_numpy(labels)},
                                   mesh)
        (g,) = torch.autograd.grad(loss, [lg])
        out[f"{mname}/xent"] = (loss.detach(), tsh.gather_full(g, spec, mesh))
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(JAX outputs, [each rank's outputs])."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("tp")
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


def _jax_leaves(jx, key, rcfg):
    """{path: array} of the JAX tree under ``key`` in the port's
    layout."""
    from repro_torch.models.convert import from_jax_params
    from repro_torch.tree import leaves_with_paths
    return dict(leaves_with_paths(from_jax_params(_unflat(jx, key), rcfg,
                                                  "cpu")))


def _rcfg(name, mname):
    nm = MESHES[mname][1]
    return t_resolve(_config(name, nm, t_get_reduced), tp=nm)


CASES = [(m, n) for m in MESHES for n in MODELS]


@pytest.mark.parametrize("mname,name", CASES)
def test_tp_loss_and_grads_match_jax(results, mname, name):
    jx, ranks = results
    key = f"{mname}/{name}"
    want = float(jx[key + "/loss"])
    for r in range(WORLD):
        got = float(ranks[r][key]["loss"])
        assert abs(got - want) <= 1e-5 * abs(want), (r, got, want)
    ref = _jax_leaves(jx, key + "/grads", _rcfg(name, mname))
    got = ranks[0][key]["grads"]
    assert sorted(got) == sorted(ref)
    for i in ref:
        g, w = got[i], ref[i].numpy()
        assert g.shape == w.shape, i
        peak = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_REL * peak, (i, err, peak)


@pytest.mark.parametrize("mname,name", CASES)
def test_tp_zero1_update_matches_jax(results, mname, name):
    """Updated parameters and the moments, gathered from each rank's
    ZeRO-1 slices, within 1e-6 of JAX's AdamW; every rank gathers the
    same bits; two runs bitwise; the meta stand-ins have the shapes and
    dtypes of the shards."""
    jx, ranks = results
    key = f"{mname}/{name}"
    rcfg = _rcfg(name, mname)
    for part in ("after", "mu", "nu"):
        ref = _jax_leaves(jx, f"{key}/{part}", rcfg)
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


@pytest.mark.parametrize("mname", list(MESHES))
def test_vocab_parallel_xent_matches_jax(results, mname):
    """The loss over a vocab that ``tp`` pads (510 -> 512, the padded
    columns included) and its logit gradient, gathered, to 1e-6."""
    jx, ranks = results
    for r in range(WORLD):
        loss, g = ranks[r][f"{mname}/xent"]
        assert abs(float(loss) - float(jx["xent/loss"])) <= 1e-6, r
        np.testing.assert_allclose(g.numpy(), jx["xent/grad"], atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("mode", ["extend", "decode"])
def test_tp_raises_for_paged_caches(mode):
    """Paged caches (``slots``) are the one serving layout tensor
    parallelism does not take: they raise, naming ``ROADMAP.md``,
    instead of running on replicated weights."""
    from repro_torch.distributed.compat import MeshShape
    from repro_torch.models.attention import attention_apply, \
        init_attention
    mesh = MeshShape((1, 2), ("data", "model"))
    gen = torch.Generator().manual_seed(0)
    p = init_attention(gen, 32, 2, 2, 16, torch.float32)
    arena = {"k": torch.zeros((3, 16, 2, 16)),
             "v": torch.zeros((3, 16, 2, 16))}
    S = 4 if mode == "extend" else 1
    kw = dict(cache_len=torch.zeros(1, dtype=torch.int32)) \
        if mode == "decode" else {}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention_apply(p, torch.zeros((1, S, 32)), mode=mode, cache=arena,
                        slots=torch.zeros(1, dtype=torch.long),
                        want_cache=True, tp_mesh=mesh, **kw)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        _jax_side(sys.argv[2], sys.argv[3])
