"""End-to-end training on the PyTorch port: data pipeline -> train step
-> checkpoints -> crash -> restart with the dead host's shards failed over.

    python examples/train_lm_torch.py                 # CUDA device
    python examples/train_lm_torch.py --device cpu    # plain versions
    python examples/train_lm_torch.py --full          # ~100M params

The twin of ``examples/train_lm.py``: a small llama-family model learns a
synthetic pattern task, checkpoints every 50 steps, then host 1 dies: the
driver restores the latest checkpoint, the data pipeline fails the dead
host's shards over to host 0 deterministically, and training resumes.
It prints what the JAX example prints.
"""
import argparse
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.config import resolve  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.checkpoint.checkpoint import Checkpointer  # noqa: E402
from repro_torch.data.pipeline import (DataPipeline, ShardPlan,  # noqa: E402
                                       SyntheticLMTask)
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.train_loop import (TrainConfig,  # noqa: E402
                                          TrainDriver, make_train_step)
from repro_torch.tree import leaves  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--full", action="store_true",
                    help="~100M-param config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    if args.full:
        cfg = get_reduced(args.arch, d_model=768, num_layers=12,
                          num_heads=12, num_kv_heads=4, d_ff=2048,
                          head_dim=64, vocab_size=50304, dtype="float32")
    else:
        cfg = get_reduced(args.arch, vocab_size=2048, dtype="float32",
                          num_layers=4, d_model=256, d_ff=512)
    model = LM(resolve(cfg, tp=1), device=args.device)
    params = model.init(seed=0)
    n_params = sum(t.numel() for t in leaves(params))
    print(f"arch={cfg.name} reduced: {n_params / 1e6:.1f}M params")

    opt = init_opt_state(params)
    tc = TrainConfig(opt=OptimizerConfig(
        lr=1e-3, warmup_steps=20, total_steps=args.steps))
    step = make_train_step(model, None, tc)

    task = SyntheticLMTask(vocab_size=cfg.vocab_size, seq_len=args.seq)
    plan = ShardPlan(n_shards=4, n_hosts=2, redundancy=2)
    pipe = DataPipeline(task, plan, host=0,
                        batch_per_shard=args.batch // 2)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    ck = Checkpointer(ckpt_dir, keep=3)
    driver = TrainDriver(step, checkpointer=ck, ckpt_every=50, log_every=20)

    half = args.steps // 2
    print(f"\n-- phase 1: train to step {half}, checkpointing --")
    params, opt, hist1 = driver.run(params, opt, iter(pipe), half)
    ck.wait()

    print("\n-- simulated failure: host 1 dies; restore latest checkpoint --")
    latest = ck.latest_step()
    restored = ck.restore(latest, {"params": params, "opt": opt})
    failover = pipe.with_failures([1])
    failover.step = latest
    print(f"restored step {latest}; host 0 now serves shards "
          f"{plan.shards_for_host(0, [1])} (was {plan.shards_for_host(0)})")

    print("\n-- phase 2: resume training after failover --")
    params, opt, hist2 = driver.run(
        restored["params"], restored["opt"], failover, args.steps,
        start_step=latest)

    losses = [l for _, l in hist1 + hist2]
    print(f"\nloss: first {losses[0]:.3f} -> last {losses[-1]:.3f} "
          f"({'DECREASED ok' if losses[-1] < losses[0] else 'NO PROGRESS'})")
    print(f"checkpoints kept: {ck.steps()} (dir {ckpt_dir})")


if __name__ == "__main__":
    main()
