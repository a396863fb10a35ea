"""Architecture registry of the port: one module per supported architecture.

``get_config(name)`` returns the full :class:`repro_torch.config.ModelConfig`;
``get_reduced(name)`` returns the tiny same-family config used by CPU smoke
tests; ``cut_layers`` cuts a config's depth as the dry-run's cells do.
``ARCHS`` lists the ported ids.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional

from ..config import ModelConfig, reduced

ARCHS: List[str] = [
    "gemma3_27b",
    "minitron_4b",
    "llama3_2_1b",
    "qwen3_1_7b",
    "qwen2_vl_2b",
    "phi3_5_moe",
    "dbrx_132b",
    "whisper_base",
    "xlstm_350m",
    "recurrentgemma_2b",
]

# public ids (dashes) -> module names
ALIASES: Dict[str, str] = {
    "gemma3-27b": "gemma3_27b",
    "minitron-4b": "minitron_4b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "dbrx-132b": "dbrx_132b",
    "whisper-base": "whisper_base",
    "xlstm-350m": "xlstm_350m",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.CONFIG


def get_reduced(name: str, **overrides) -> ModelConfig:
    return reduced(get_config(name), **overrides)


def cut_layers(cfg: ModelConfig, n_rep: Optional[int]) -> ModelConfig:
    """``cfg`` cut to ``n_rep`` repetitions of its block pattern plus its
    tail (``num_layers % len(block_pattern)``); whisper, and ``n_rep``
    None, as they are."""
    if n_rep is None or cfg.family == "audio":
        return cfg
    p = len(cfg.block_pattern)
    return dataclasses.replace(cfg, num_layers=p * n_rep
                               + cfg.num_layers % p)


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
