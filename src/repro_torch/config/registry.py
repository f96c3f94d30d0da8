"""Architecture registry: maps assigned arch ids to config modules."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen2-vl-72b",
    "jamba-v0.1-52b",
    "qwen1.5-4b",
    "llama3.2-1b",
    "granite-3-2b",
    "qwen1.5-0.5b",
    "whisper-medium",
    "deepseek-v3-671b",
    "deepseek-v2-236b",
    "xlstm-1.3b",
    # the paper's own experiment configs
    "smollm2-1.7b",
    "smollm2-135m",
    "llama-70b-sct",
]


def _module_name(arch_id: str) -> str:
    return "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "p")


def get_config(arch_id: str, reduced: bool = False):
    mod = importlib.import_module(_module_name(arch_id))
    return mod.REDUCED if reduced else mod.CONFIG


def list_archs():
    return list(ARCH_IDS)
