"""Architecture registry: ``--arch <id>`` resolution.

Only the architectures whose port has landed are listed; the others come
with the slices that port their model families."""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCHS = {   # in the order of repro.configs.registry.ARCHS
    "llama3.2-1b": "llama3_2_1b",
    "minicpm3-4b": "minicpm3_4b",
    "granite-20b": "granite_20b",
    "minitron-8b": "minitron_8b",
    "arctic-480b": "arctic_480b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "mamba2-780m": "mamba2_780m",
}


def _mod(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not in the PyTorch port yet; "
                       f"ported: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


def all_archs():
    return list(ARCHS)
