"""Assigned architecture configs (+ reduced smoke variants).

Port of ``repro/configs``: the same data, field for field, with ``dtype``
a torch dtype.

Every module exposes ``CONFIG`` (the exact assigned configuration),
``SMOKE`` (a reduced same-family config for CPU tests) and ``SHAPES``
(the applicable input-shape cells with skip annotations).
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "phi3_medium_14b",
    "stablelm_1_6b",
    "granite_20b",
    "granite_8b",
    "mamba2_780m",
    "whisper_medium",
    "zamba2_1_2b",
    "phi35_moe_42b",
    "olmoe_1b_7b",
    "paligemma_3b",
]

# canonical shape cells (assignment): name -> (kind, seq_len, global_batch)
SHAPE_CELLS = {
    "train_4k": ("train", 4_096, 256),
    "prefill_32k": ("prefill", 32_768, 32),
    "decode_32k": ("decode", 32_768, 128),
    "long_500k": ("decode", 524_288, 1),
}


def get_config(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{arch_id.replace('-', '_')}")
    return mod.CONFIG


def get_smoke(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{arch_id.replace('-', '_')}")
    return mod.SMOKE


def get_shapes(arch_id: str) -> dict[str, str]:
    """shape cell -> "run" or "skip:<reason>"."""
    mod = importlib.import_module(f"repro_torch.configs.{arch_id.replace('-', '_')}")
    return mod.SHAPES
