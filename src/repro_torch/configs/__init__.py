"""Architecture registry and the assigned input-shape sets, for the
architectures the port runs.

``get_config`` / ``get_smoke_config`` return the port's ``ArchConfig`` of a
registered name: the published configuration, or a few-layer, narrow one
for tests. Each is a copy of the JAX package's ``repro/configs/<name>.py``.
The registered names cover the dense, MoE, hybrid (Mamba2 + shared
attention) and ``ssm`` (RWKV6) families. The other architectures of the JAX package need model
families the port does not have yet; asking for one raises
``NotImplementedError`` naming the ROADMAP row that ports it.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.base import ArchConfig

_MODULES = {
    "yi-9b": "yi_9b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "arctic-480b": "arctic_480b",
    "zamba2-7b": "zamba2_7b",
    "rwkv6-3b": "rwkv6_3b",
}

#: architectures of the JAX package still to port -> the ROADMAP row
NOT_PORTED = {
    "qwen2-vl-72b": "A11 (vlm: M-RoPE, patch embeddings)",
    "whisper-large-v3": "A11 (encoder-decoder)",
    "minicpm3-4b": "A11 (MLA attention)",
}

ARCH_NAMES = list(_MODULES)


def _mod(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(f"{name} is not ported yet: ROADMAP "
                                  f"{NOT_PORTED[name]}")
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _mod(name).config()


def get_smoke_config(name: str) -> ArchConfig:
    return _mod(name).smoke_config()


# ---------------------------------------------------------------------------
# Assigned shapes (LM-family: seq_len x global_batch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
