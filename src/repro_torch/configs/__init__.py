"""Architecture registry (PyTorch port of ``repro.configs``):
``get_config(arch_id)`` with the JAX package's ten ids and their aliases.

Every config cites its source; the exact numbers come from the assignment
table (public-literature pool).
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "whisper_tiny", "qwen3_0_6b", "zamba2_1_2b", "qwen3_moe_30b_a3b",
    "qwen3_32b", "deepseek_v2_236b", "olmo_1b", "qwen2_vl_7b",
    "mamba2_2_7b", "deepseek_67b",
]

# CLI aliases with dashes/dots as given in the assignment
ALIASES = {
    "whisper-tiny": "whisper_tiny",
    "qwen3-0.6b": "qwen3_0_6b",
    "zamba2-1.2b": "zamba2_1_2b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen3-32b": "qwen3_32b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "olmo-1b": "olmo_1b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "deepseek-67b": "deepseek_67b",
}


def get_config(arch: str):
    arch_id = ALIASES.get(arch, arch)
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; choose from "
                         f"{sorted(ALIASES) + ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.config()


# ----------------------------- input shapes (assignment table) -------------
INPUT_SHAPES = {
    "train_4k":    {"seq_len": 4_096,   "global_batch": 256,
                    "kind": "train"},
    "prefill_32k": {"seq_len": 32_768,  "global_batch": 32,
                    "kind": "prefill"},
    "decode_32k":  {"seq_len": 32_768,  "global_batch": 128,
                    "kind": "decode"},
    "long_500k":   {"seq_len": 524_288, "global_batch": 1,
                    "kind": "decode"},
}
