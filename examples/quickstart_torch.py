"""Quickstart on the PyTorch port: build a task cascade on a calibrated
workload and compare against the model-cascade baseline + oracle-only.

    PYTHONPATH=src python examples/quickstart_torch.py [workload]

The twin of ``examples/quickstart.py``: the same lines from the port's
``core.pipeline`` (Algorithm 1 and the baselines) and ``core.simulation``.
Both are numpy, so this takes no device and prints the same numbers.
"""
import sys

import numpy as np

sys.path.insert(0, "src")

from repro_torch.core.pipeline import (BuildConfig, build_task_cascade,
                                       evaluate_on, model_cascade)
from repro_torch.core.simulation import WORKLOADS, make_workload


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "court"
    assert name in WORKLOADS, f"pick one of {list(WORKLOADS)}"
    w = make_workload(name, 1000)
    rng = np.random.default_rng(0)
    perm = rng.permutation(1000)
    dev, test = w.subset(perm[:200]), w.subset(perm[200:])

    print(f"== workload: {name} (dev 200 docs / test 800 docs) ==\n")
    oracle_cost = test.cost_model().oracle_only_cost()
    print(f"oracle-only cost:          ${oracle_cost:8.2f}")

    mc = evaluate_on(test, model_cascade(dev, alpha=0.9))
    print(f"2-model cascade:           ${mc['total_cost']:8.2f}   "
          f"acc {mc['accuracy']:.1%}")

    out = build_task_cascade(dev, BuildConfig(alpha=0.9, seed=0))
    tc = evaluate_on(test, out)
    print(f"task cascade:              ${tc['total_cost']:8.2f}   "
          f"acc {tc['accuracy']:.1%}   "
          f"({tc['total_cost'] / mc['total_cost']:.2f}x the model cascade)")

    print(f"\ncascade ({len(out.cascade.tasks)} tasks + oracle fallthrough):")
    for i, t in enumerate(out.cascade.tasks):
        m, o, f = t.config.key()
        ths = {c: round(v, 3) for c, v in t.thresholds.items()}
        print(f"  {i + 1}. {m:7s} op={o:24s} fraction={f:<5} thresholds={ths}")
    print(f"  {len(out.cascade.tasks) + 1}. oracle  op=o_orig "
          f"                  fraction=1.0   (terminal)")
    print(f"\ndocs escaping to the oracle: {tc['oracle_frac']:.1%}")


if __name__ == "__main__":
    main()
