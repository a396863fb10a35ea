"""Random weights made by the benchmark, on the device, from a seed.

The tree has the layout that the program's ``LM`` takes
(``LMBackend(params=...)``) and the reference reads: ``embed.table``
``[V, d]``, ``final_norm.scale``, and per layer ``norm1``, ``attn``
(``wq [d, H, Dh]``, ``wk``/``wv [d, KV, Dh]``, ``wo [H, Dh, d]``, the
q/k norms where the model has them), ``norm2`` and ``mlp`` (``w1``/``w3
[d, F]``, ``w2 [F, d]``) or ``moe`` (``router [d, E]`` in float32,
``w1``/``w3 [E, d, F]``, ``w2 [E, F, d]``).  Each tensor is one call of
``normal_`` in the served dtype on a ``torch.Generator`` of the device:
matrices at standard deviation ``1 / sqrt(fan_in)``, the embedding at
0.02, norm scales at one.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_params(spec: Mapping, seed: int, device) -> Dict[str, Any]:
    dt = DTYPES[spec["dtype"]]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d, H, KV = spec["d_model"], spec["num_heads"], spec["num_kv_heads"]
    dh, F, V = spec["head_dim"], spec["d_ff"], spec["vocab_size"]

    def mat(shape, fan_in, dtype=dt):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, fan_in ** -0.5, generator=gen)

    def ones(n):
        return {"scale": torch.ones(n, dtype=torch.float32, device=device)}

    table = torch.empty((V, d), dtype=dt, device=device)
    layers = []
    for _ in range(spec["num_layers"]):
        attn = {"wq": mat((d, H, dh), d), "wk": mat((d, KV, dh), d),
                "wv": mat((d, KV, dh), d), "wo": mat((H, dh, d), H * dh)}
        if spec.get("qk_norm"):
            attn["q_norm"], attn["k_norm"] = ones(dh), ones(dh)
        lp = {"norm1": ones(d), "attn": attn, "norm2": ones(d)}
        moe = spec.get("moe")
        if moe:
            E = moe["num_experts"]
            lp["moe"] = {"router": mat((d, E), d, torch.float32),
                         "w1": mat((E, d, F), d), "w3": mat((E, d, F), d),
                         "w2": mat((E, F, d), F)}
        else:
            lp["mlp"] = {"w1": mat((d, F), d), "w3": mat((d, F), d),
                         "w2": mat((F, d), F)}
        layers.append(lp)
    table.normal_(0.0, 0.02, generator=gen)
    return {"embed": {"table": table}, "final_norm": ones(d),
            "layers": layers}
