"""Training entry point.

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 100 \\
        [--device cuda|cpu]
    torchrun --nproc-per-node N -m repro_torch.launch.train [...]

The JAX package's launcher on the port: a reduced f32 config (vocab
2048) of ``--arch``, synthetic pattern data from a two-shard
``DataPipeline``, AdamW (lr 1e-3, 10 warmup steps) and the checkpointed
``TrainDriver``, resuming from the newest checkpoint in ``--ckpt_dir``.
``--device`` defaults to the CUDA device (attention through the flash
kernel and its backward); ``cpu`` runs the plain versions.

Under ``torchrun`` (its ``WORLD_SIZE`` in the environment) every rank
joins the world (NCCL on ``cuda``, gloo on ``cpu``), builds
``make_host_mesh(data=N, model=1)`` and runs the data-parallel step:
each rank draws the same global batch and trains on its shard, and rank
0 writes the checkpoints.  Without ``torchrun`` it runs on one device.

As in the reference, ``--reduced`` is a flag whose default is already
True, so the launcher always builds the reduced config; and the audio
family (whisper-base) builds a ``WhisperModel`` that the data pipeline
feeds no ``frame_emb``, so its first step raises ``KeyError``
(``ROADMAP.md`` Queue 3).  ``chip_smoke.py`` trains whisper through
``make_train_step`` with seeded frame embeddings instead.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch.distributed as dist

from ..config import resolve
from ..configs import get_config, get_reduced
from ..checkpoint.checkpoint import Checkpointer
from ..data.pipeline import DataPipeline, ShardPlan, SyntheticLMTask
from ..distributed.compat import init_world
from ..distributed.fault import HeartbeatMonitor
from ..models.model import LM
from ..models.whisper import WhisperModel
from ..train.optimizer import OptimizerConfig, init_opt_state
from ..train.train_loop import TrainConfig, TrainDriver, make_train_step
from .mesh import make_host_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt_dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh = None
    if "WORLD_SIZE" in os.environ or dist.is_initialized():
        device = init_world(args.device)
        mesh = make_host_mesh(data=dist.get_world_size(), model=1,
                              device_type=device.type)
    else:
        device = args.device
    cfg = get_reduced(args.arch, dtype="float32", vocab_size=2048) \
        if args.reduced else get_config(args.arch)
    rcfg = resolve(cfg, tp=1)
    model = LM(rcfg, device=device) if cfg.family != "audio" \
        else WhisperModel(rcfg, device=device)

    params = model.init(seed=0)
    opt = init_opt_state(params)
    tc = TrainConfig(accum_steps=args.accum, opt=OptimizerConfig(
        lr=1e-3, warmup_steps=10, total_steps=args.steps))
    step = make_train_step(model, mesh, tc)

    task = SyntheticLMTask(vocab_size=cfg.vocab_size, seq_len=args.seq)
    pipe = DataPipeline(task, ShardPlan(n_shards=2, n_hosts=1), host=0,
                        batch_per_shard=args.batch // 2)
    ck = Checkpointer(args.ckpt_dir, keep=3, mesh=mesh)
    quiet = mesh is not None and dist.get_rank() != 0
    driver = TrainDriver(step, checkpointer=ck, ckpt_every=25, log_every=10,
                         monitor=HeartbeatMonitor(),
                         log_fn=(lambda s: None) if quiet else print)

    restored = driver.restore_latest(params, opt)
    start = 0
    if restored is not None:
        params, opt, start = restored
        driver.log_fn(f"resumed from checkpoint step {start}")
    driver.run(params, opt, iter(pipe), args.steps, start_step=start)
    driver.log_fn(f"training complete; checkpoints: {ck.steps()}")


if __name__ == "__main__":
    main()
