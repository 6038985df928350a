"""Assigned-architecture registry: `--arch <id>` resolves here.

Each module defines CONFIG (the exact assigned numbers) and reduced()
(a small same-family variant for CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = (
    "llava_next_34b",
    "minitron_8b",
    "smollm_360m",
    "minicpm3_4b",
    "internlm2_20b",
    "recurrentgemma_9b",
    "xlstm_125m",
    "deepseek_moe_16b",
    "qwen3_moe_30b_a3b",
    "whisper_base",
)

# CLI ids use dashes; module names use underscores.
def canon(arch: str) -> str:
    return arch.replace("-", "_")


def get_config(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{canon(arch)}")
    return mod.CONFIG


def get_reduced(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{canon(arch)}")
    return mod.reduced()


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
