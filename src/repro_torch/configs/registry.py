"""Architecture registry: ``--arch <id>`` resolution, over the ten
architectures of ``repro.configs.registry``, in its order (``all_archs``),
and the port's own, which the JAX package has no model of
(``PORT_ARCHS``; ``served_archs`` lists both)."""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCHS = {   # in the order of repro.configs.registry.ARCHS
    "llama3.2-1b": "llama3_2_1b",
    "minicpm3-4b": "minicpm3_4b",
    "granite-20b": "granite_20b",
    "minitron-8b": "minitron_8b",
    "whisper-small": "whisper_small",
    "arctic-480b": "arctic_480b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "mamba2-780m": "mamba2_780m",
}


# the port's own architectures: served and tested against the benchmark's
# plain reference (bench/families/), with no JAX twin to compare against
PORT_ARCHS = {
    "nemotron-3-nano-30b-a3b": "nemotron_3_nano_30b_a3b",
}


def _mod(arch: str):
    mods = {**ARCHS, **PORT_ARCHS}
    if arch not in mods:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(mods)}")
    return importlib.import_module(f"repro_torch.configs.{mods[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


def all_archs():
    """The JAX package's architectures, in its order."""
    return list(ARCHS)


def served_archs():
    """Every architecture the port serves: ``all_archs`` and ``PORT_ARCHS``."""
    return [*ARCHS, *PORT_ARCHS]
