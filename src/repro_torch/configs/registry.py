"""Architecture registry of the port: ``--arch <id>`` resolution, model
construction, the shape table and ``input_specs``.

Port of the reference's ``configs/registry.py`` for the dense family,
gemma3 (sliding windows), the MoE family (granite-moe, deepseek-v2-lite),
zamba2 (Mamba2 and shared blocks) and RWKV6; qwen2-vl and whisper come with
their slices (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

import torch

from repro_torch.models.transformer import ArchConfig, TransformerLM

ARCH_MODULES = {
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
}

ARCH_IDS = tuple(ARCH_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str, reduced: bool = False) -> ArchConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; the port has {ARCH_IDS}")
    mod = importlib.import_module(ARCH_MODULES[arch])
    return mod.reduced() if reduced else mod.config()


def build_model(arch_or_cfg, device="cuda", seed: int = 0) -> TransformerLM:
    """The model of an arch id or config, its weights drawn from ``seed`` on
    ``device`` (CUDA by default; raises when there is none)."""
    cfg = get_config(arch_or_cfg) if isinstance(arch_or_cfg, str) else arch_or_cfg
    return TransformerLM(cfg, device=device, seed=seed)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of an input, without storage (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, TensorSpec]:
    """The inputs of a train shape: the full federated batch, tokens and
    the participation mask. The prefill and decode shapes' inputs come with
    their step builders (ROADMAP.md queue 1)."""
    if shape.kind != "train":
        raise NotImplementedError(f"{shape.kind} inputs are not ported yet (ROADMAP.md queue 1)")
    S, B = shape.seq_len, shape.global_batch
    return {"tokens": TensorSpec((B, S), torch.int32),
            "participation": TensorSpec((B,), torch.float32)}
