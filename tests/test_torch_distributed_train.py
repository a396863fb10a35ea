"""The port's data-parallel training, elastic restore and
sequence-parallel decode on gloo worlds, held against the JAX package.

Reduced llama3.2-1b (f32, 2 layers, vocab 512, 4 query / 2 KV heads,
``resolve(tp=2)``), weights from the JAX package's init (seed 8) turned
into the port's layout.  The JAX side runs once per module in a
subprocess (this file with ``--jax``; 8 forced host devices, though its
yardsticks are mesh-less) and writes an ``.npz``: the unsharded train
step on the global batch of 8 x 32 (the yardstick of the reference's own
``check_sharded_train_step``, which JAX 0.9.0 cannot run: ROADMAP Queue
3) and a prefill + 10 decode steps.

Worlds, each spawned from a rank body at module level (``file://``
rendezvous, timeouts on the join and the collectives):

* 8 ranks: the data-parallel step on a 4 x 2 mesh (loss to 1e-5, every
  updated leaf to 2e-5 of its peak, bitwise the same on every rank); the
  pod hop on a 2 x 2 x 2 mesh, int8-compressed against full precision
  within the int8 bound per leaf (|diff| <= amax / 127: each pod's value
  is off by at most amax / 254), then a compressed step; a collective
  checkpoint; ``sp_decode=True`` decode on the 4 x 2 mesh to 1e-5;
* 4 ranks: ``plan_remesh(4, old_dp=4)`` -> 2 x 2, the checkpoint restored
  onto it (every rank's ``local_shard`` bitwise, gathered back bitwise),
  one step on ``pipe.with_failures([1])`` finite (the reference's
  ``check_elastic_remesh_training``);
* 2 ranks: ``launch/train.main`` for two steps.
"""
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.checkpoint import Checkpointer  # noqa: E402
from repro_torch.config import resolve as t_resolve  # noqa: E402
from repro_torch.configs import get_reduced as t_get_reduced  # noqa: E402
from repro_torch.data.pipeline import (DataPipeline, ShardPlan,  # noqa: E402
                                       SyntheticLMTask)
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.distributed.compat import make_mesh, run_world  # noqa: E402
from repro_torch.distributed.fault import plan_remesh  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model import LM as TLM  # noqa: E402
from repro_torch.train.optimizer import init_opt_state  # noqa: E402
from repro_torch.train.train_loop import (TrainConfig,  # noqa: E402
                                          dp_reduce_grads, local_batch,
                                          make_train_step)
from repro_torch.tree import leaves, leaves_with_paths, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(dtype="float32", vocab_size=512, num_layers=2, num_heads=4,
           num_kv_heads=2)
GLOBAL_B, SEQ = 8, 32
PROMPT, S_ALLOC, DECODE = 20, 32, 10
GRAD_REL = 2e-5
TIMEOUT = 150.0


def _batch():
    return SyntheticLMTask(512, SEQ).batch(0, 0, 0, GLOBAL_B)


def _decode_inputs():
    r = np.random.default_rng(5)
    return (r.integers(9, 512, (2, PROMPT)).astype(np.int32),
            r.integers(9, 512, (DECODE, 2)).astype(np.int32))


def _flat(tree, prefix=""):
    """{path: array} of a JAX pytree of dicts and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflat(flat, prefix):
    """The JAX tree under ``prefix`` back from ``_flat`` (int-keyed
    levels as lists)."""
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
    tree.setdefault("tail", [])          # an empty tuple leaves no keys
    return tree


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_side(out_path):
    import jax
    import jax.numpy as jnp
    from repro.config import resolve
    from repro.configs import get_reduced
    from repro.models.model import LM
    from repro.models.runtime import CPU_TEST
    from repro.train.optimizer import init_opt_state as jinit
    from repro.train.train_loop import TrainConfig as JTC
    from repro.train.train_loop import make_train_step as jmake

    jm = LM(resolve(get_reduced("llama3_2_1b", **CFG), tp=2), CPU_TEST)
    params = jm.init(jax.random.PRNGKey(8))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    new, _, met = jax.jit(jmake(jm, None, JTC()))(params, jinit(params),
                                                  batch)
    out = {**_flat(params, "params"), **_flat(new, "after"),
           "loss": np.asarray(met["loss"])}
    prompt, toks = _decode_inputs()
    logits, states = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t}, s_alloc=S_ALLOC))(params, jnp.asarray(prompt))
    step = jax.jit(jm.decode_step)
    seen = [np.asarray(logits)]
    for i in range(DECODE):
        pos = jnp.full((2,), PROMPT + i, jnp.int32)
        logits, states = step(params, jnp.asarray(toks[i]), states, pos)
        seen.append(np.asarray(logits))
    out["logits"] = np.stack(seen)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port's worlds
# ---------------------------------------------------------------------------

def _model(**kw):
    return TLM(t_resolve(t_get_reduced("llama3_2_1b", **CFG), tp=2),
               device="cpu", **kw)


def _params(d):
    model = _model()
    return model, from_jax_params(
        _unflat(dict(np.load(os.path.join(d, "jax.npz"))), "params"),
        model.rcfg, "cpu")


def _local_grads(model, params, batch, mesh):
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = model.loss(live, local_batch(batch, mesh))
    grads = iter(torch.autograd.grad(loss, leaves(live)))
    return tree_map(lambda _: next(grads), params)


def _world8(rank, world, d):
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = {}
    model, params0 = _params(d)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    # the data-parallel step
    params = tree_map(torch.clone, params0)
    opt = init_opt_state(params)
    params, opt, met = make_train_step(model, mesh, TrainConfig())(
        params, opt, batch)
    out["loss"], out["after"] = met["loss"], params
    ck = Checkpointer(os.path.join(d, "ck"), mesh=mesh)
    ck.save(1, {"params": params, "opt": opt})
    # the pod hop, full precision and int8
    pod = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    grads = _local_grads(model, params0, batch, pod)
    full = dp_reduce_grads(tree_map(torch.clone, grads), pod, False)
    comp = dp_reduce_grads(tree_map(torch.clone, grads), pod, True)
    # the bound's amax: the largest |data-mean| any pod quantizes
    data_mean = dp_reduce_grads(tree_map(torch.clone, grads),
                                _DataOnly(pod))
    amax = []
    for g in leaves(data_mean):
        a = g.abs().max().reshape(1)
        dist.all_reduce(a, op=dist.ReduceOp.MAX)
        amax.append(a)
    out["pod_full"], out["pod_comp"], out["pod_amax"] = full, comp, amax
    p2 = tree_map(torch.clone, params0)
    p2, _, met2 = make_train_step(model, pod, TrainConfig(
        compress_pod_grads=True))(p2, init_opt_state(p2), batch)
    out["pod_loss"], out["pod_after"] = met2["loss"], p2
    # sequence-parallel decode
    sp = _model(mesh=mesh, sp_decode=True)
    prompt, toks = _decode_inputs()
    logits, states = sp.prefill(params0, {"tokens": torch.from_numpy(prompt)},
                                s_alloc=S_ALLOC)
    seen = [logits]
    for i in range(DECODE):
        pos = torch.full((2,), PROMPT + i, dtype=torch.int32)
        logits, states = sp.decode_step(params0, torch.from_numpy(toks[i]),
                                        states, pos)
        seen.append(logits)
    out["logits"] = torch.stack(seen)
    out["cache_positions"] = states[0]["k"].shape[1]
    torch.save(out, os.path.join(d, f"w8_rank{rank}.pt"))


class _DataOnly:
    """A pod mesh seen without its pod axis (the in-pod reduction)."""

    def __init__(self, mesh):
        self._m = mesh
        self.shape = tuple(s for s, n in zip(mesh.shape, mesh.mesh_dim_names)
                           if n != "pod")
        self.mesh_dim_names = tuple(n for n in mesh.mesh_dim_names
                                    if n != "pod")

    def get_group(self, name):
        return self._m.get_group(name)


def _world4(rank, world, d):
    torch.set_num_threads(1)
    rp = plan_remesh(4, old_dp=4)
    mesh = make_mesh(rp.shape, rp.axes, "cpu")
    model, params0 = _params(d)
    saved = torch.load(os.path.join(d, "w8_rank0.pt"))["after"]
    like = {"params": tree_map(torch.zeros_like, params0),
            "opt": init_opt_state(params0)}
    ck = Checkpointer(os.path.join(d, "ck"), mesh=mesh)
    sh = {"params": tsh.tree_shardings(model.param_specs(), mesh)}
    part = ck.restore(1, like, shardings=sh)
    specs = tsh.tree_pspecs(model.param_specs(), mesh)
    spec_at = dict(_spec_paths(specs))
    out = {"shards_bitwise": all(
        torch.equal(t, tsh.local_shard(s, spec_at[k], mesh))
        for (k, t), s in zip(leaves_with_paths(part["params"]),
                             leaves(saved)))}
    out["gathered_bitwise"] = all(
        torch.equal(tsh.gather_full(t, spec_at[k], mesh), s)
        for (k, t), s in zip(leaves_with_paths(part["params"]),
                             leaves(saved)))
    # the shards saved back under the 2 x 2 mesh (gathered to rank 0)
    ck.save(2, part, shardings=sh)
    back = ck.restore(2, like)
    out["resaved_bitwise"] = all(torch.equal(a, b) for a, b in zip(
        leaves(back["params"]), leaves(saved)))
    whole = ck.restore(1, like)
    pipe = DataPipeline(SyntheticLMTask(512, SEQ), ShardPlan(
        n_shards=4, n_hosts=2), host=0, batch_per_shard=4)
    pipe.step = 2
    batch = next(pipe.with_failures([1]))
    p, _, met = make_train_step(model, mesh, TrainConfig())(
        whole["params"], whole["opt"], batch)
    out["loss"] = float(met["loss"])
    out["finite"] = all(bool(torch.isfinite(t).all()) for t in leaves(p))
    out["rows"] = batch["tokens"].shape[0]
    out["opt_step"] = int(whole["opt"].step)
    torch.save(out, os.path.join(d, f"w4_rank{rank}.pt"))


def _spec_paths(tree, prefix=""):
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return [x for k, v in items
                for x in _spec_paths(v, f"{prefix}/{k}" if prefix
                                     else str(k))]
    return [(prefix, tree)]


def _world2(rank, world, d):
    from repro_torch.launch import train
    torch.set_num_threads(1)
    with open(os.path.join(d, f"launch{rank}.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        train.main(["--device", "cpu", "--steps", "2", "--batch", "4",
                    "--seq", "32", "--ckpt_dir", os.path.join(d, "lck")])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX results, then the three worlds' outputs."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("dtrain")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, __file__, "--jax", str(d / "jax.npz")],
                   env=env, check=True, timeout=TIMEOUT, capture_output=True)
    run_world(_world8, 8, str(d), device_type="cpu",
              init_method=f"file://{d / 'rdv8'}", timeout_s=TIMEOUT)
    run_world(_world4, 4, str(d), device_type="cpu",
              init_method=f"file://{d / 'rdv4'}", timeout_s=TIMEOUT)
    run_world(_world2, 2, str(d), device_type="cpu",
              init_method=f"file://{d / 'rdv2'}", timeout_s=TIMEOUT)
    jx = dict(np.load(d / "jax.npz"))
    return dict(
        d=d, jx=jx,
        w8=[torch.load(d / f"w8_rank{r}.pt") for r in range(8)],
        w4=[torch.load(d / f"w4_rank{r}.pt") for r in range(4)])


def test_dp_step_matches_unsharded_jax(runs):
    jx = runs["jx"]
    model = _model()
    want = from_jax_params(_unflat(jx, "after"), model.rcfg, "cpu")
    for r, w in enumerate(runs["w8"]):
        assert float(w["loss"]) == pytest.approx(float(jx["loss"]),
                                                 rel=1e-5), r
        for (k, a), b in zip(leaves_with_paths(want), leaves(w["after"])):
            peak = float(a.abs().max())
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=GRAD_REL * peak, err_msg=k)


def test_dp_step_leaves_params_replicated(runs):
    first = leaves(runs["w8"][0]["after"])
    for w in runs["w8"][1:]:
        assert all(torch.equal(a, b) for a, b in zip(first,
                                                     leaves(w["after"])))


def test_pod_hop_int8_within_bound(runs):
    for r, w in enumerate(runs["w8"]):
        for a, b, amax in zip(leaves(w["pod_full"]), leaves(w["pod_comp"]),
                              w["pod_amax"]):
            assert float((a - b).abs().max()) <= float(amax) / 127 + 1e-7, r


def test_pod_compressed_step_finite_and_replicated(runs):
    w0 = runs["w8"][0]
    assert np.isfinite(float(w0["pod_loss"]))
    assert float(w0["pod_loss"]) == pytest.approx(float(runs["jx"]["loss"]),
                                                  rel=1e-5)
    for w in runs["w8"][1:]:
        assert all(torch.equal(a, b) for a, b in zip(
            leaves(w0["pod_after"]), leaves(w["pod_after"])))


def test_sp_decode_matches_meshless_jax(runs):
    """Prefill of 20 tokens into caches of 32 positions cut over 4 data
    ranks (8 each), then 10 decode steps crossing the rank 2 -> 3
    boundary: logits to 1e-5 on every rank."""
    for r, w in enumerate(runs["w8"]):
        assert w["cache_positions"] == S_ALLOC // 4
        np.testing.assert_allclose(w["logits"].numpy(), runs["jx"]["logits"],
                                   atol=1e-5, rtol=1e-5, err_msg=f"rank {r}")


def test_checkpoint_restores_resharded_onto_fewer_ranks(runs):
    """Every rank's shard bitwise, gathered back bitwise, and the shards
    saved under the new mesh (gathered to rank 0) restored bitwise."""
    for w in runs["w4"]:
        assert w["shards_bitwise"] and w["gathered_bitwise"]
        assert w["resaved_bitwise"]
        assert w["opt_step"] == 1


def test_elastic_step_after_remesh_is_finite(runs):
    for w in runs["w4"]:
        assert w["finite"] and np.isfinite(w["loss"])
        assert w["rows"] == 16           # host 1's shards failed over
    assert len({w["loss"] for w in runs["w4"]}) == 1


def test_launch_train_under_a_two_rank_world(runs):
    d = runs["d"]
    log0 = (d / "launch0.log").read_text()
    assert "step 0 loss" in log0 and "checkpoints: [2]" in log0
    assert (d / "launch1.log").read_text() == ""       # rank 0 reports
    assert Checkpointer(str(d / "lck")).steps() == [2]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        _jax_side(sys.argv[2])
