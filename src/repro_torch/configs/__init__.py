"""Config registry of the LM stack: an arch id resolves to a module with
CONFIG (the exact configuration) and SMOKE (a reduced same-family config
for CPU tests). The port of `repro/configs/__init__.py`."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "tinyllama_1_1b",
]


def _module(arch: str):
    key = arch.replace("-", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch: str, smoke: bool = False):
    mod = _module(arch)
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False):
    return {a: get_config(a, smoke) for a in ARCH_IDS}
