"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The JAX package's ten ids, each a copy of its config on the port's
``ModelConfig``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
