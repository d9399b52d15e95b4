"""Architecture registry: one module per assigned architecture (the
port's copy of ``repro.configs``: data only, with torch dtypes).

``get_config(name)`` returns the exact published configuration;
``get_reduced(name)`` returns a same-family small config for CPU smoke tests.
``SHAPES`` defines the four assigned input-shape cells; ``arch_shapes(name)``
filters out skips (encoder-only decode / full-attention long-context — see
DESIGN.md §4).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "granite_34b", "qwen2_5_32b", "phi3_medium_14b", "minicpm_2b",
    "deepseek_moe_16b", "mixtral_8x7b", "llava_next_34b",
    "jamba_1_5_large", "whisper_small", "rwkv6_7b",
]

# canonical shape cells: (name, seq_len, global_batch, kind)
SHAPES = [
    ("train_4k", 4096, 256, "train"),
    ("prefill_32k", 32768, 32, "prefill"),
    ("decode_32k", 32768, 128, "decode"),
    ("long_500k", 524288, 1, "decode"),
]

# archs with a sub-quadratic decode path run long_500k (DESIGN.md §4)
LONG_OK = {"rwkv6_7b", "jamba_1_5_large", "mixtral_8x7b"}


def get_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def get_reduced(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.REDUCED


def arch_shapes(name: str):
    """(shape, skip_reason | None) for every canonical cell."""
    out = []
    for shp in SHAPES:
        sname = shp[0]
        skip = None
        if sname == "long_500k" and name not in LONG_OK:
            skip = "full-attention arch: 512k dense-KV decode unsupported"
        out.append((shp, skip))
    return out
