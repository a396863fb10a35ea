"""Sharded, fault-tolerant data pipeline (numpy only: a copy of the JAX
package's, so batches are equal element for element).

Deterministic *redundant shard assignment*: logical data shards are mapped
to hosts by seeded hash; each shard is also assigned R-1 backup hosts, so
when a host dies any survivor can recompute exactly the lost shard's
batches (generation is a pure function of (seed, shard, step)).  This is
the standard trick for input-pipeline fault tolerance without a central
data service.

``SyntheticLMTask`` generates next-token-predictable sequences (repeating
patterns + noise) so tiny training runs show decreasing loss — used by the
train example and integration tests.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def _stable_hash(*keys) -> int:
    h = hashlib.blake2b("|".join(map(str, keys)).encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little")


@dataclass(frozen=True)
class ShardPlan:
    """Deterministic shard->host map with redundancy R."""
    n_shards: int
    n_hosts: int
    redundancy: int = 2
    seed: int = 0

    def hosts_for(self, shard: int) -> List[int]:
        """Primary + backup hosts for a shard (distinct, seeded)."""
        out = []
        i = 0
        while len(out) < min(self.redundancy, self.n_hosts):
            h = _stable_hash(self.seed, "shard", shard, i) % self.n_hosts
            if h not in out:
                out.append(h)
            i += 1
        return out

    def shards_for_host(self, host: int,
                        dead_hosts: Sequence[int] = ()) -> List[int]:
        """Shards this host must produce, including failover pickups.

        A shard normally served by its primary falls to the first live
        backup when the primary is dead.
        """
        dead = set(dead_hosts)
        out = []
        for s in range(self.n_shards):
            for owner in self.hosts_for(s):
                if owner not in dead:
                    if owner == host:
                        out.append(s)
                    break
        return out


@dataclass
class SyntheticLMTask:
    """Learnable synthetic LM data: periodic token patterns + noise."""
    vocab_size: int
    seq_len: int
    period: int = 8
    noise: float = 0.05

    def batch(self, seed: int, shard: int, step: int,
              batch_size: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(_stable_hash(seed, shard, step))
        base = rng.integers(
            9, self.vocab_size, size=(batch_size, self.period))
        reps = int(np.ceil((self.seq_len + 1) / self.period))
        seq = np.tile(base, (1, reps))[:, : self.seq_len + 1]
        flip = rng.random(seq.shape) < self.noise
        seq = np.where(flip, rng.integers(9, self.vocab_size, seq.shape), seq)
        return {
            "tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
        }


@dataclass
class DataPipeline:
    """Per-host iterator over the host's (possibly failed-over) shards."""
    task: SyntheticLMTask
    plan: ShardPlan
    host: int
    batch_per_shard: int
    seed: int = 0
    dead_hosts: tuple = ()
    step: int = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        shards = self.plan.shards_for_host(self.host, self.dead_hosts)
        if not shards:
            raise StopIteration
        parts = [self.task.batch(self.seed, s, self.step,
                                 self.batch_per_shard) for s in shards]
        self.step += 1
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def with_failures(self, dead_hosts: Sequence[int]) -> "DataPipeline":
        """Continue the SAME stream with hosts marked dead (failover)."""
        return DataPipeline(self.task, self.plan, self.host,
                            self.batch_per_shard, self.seed,
                            tuple(dead_hosts), self.step)
