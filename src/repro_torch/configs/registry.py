"""Architecture registry of the port: ``--arch <id>`` resolution, model
construction, the shape table and ``input_specs``.

Port of the reference's ``configs/registry.py``: every arch of the
reference, in its order, ``shape_applicable`` and ``input_specs``. An arch's
config is an ``ArchConfig`` (a ``TransformerLM``) or, for whisper, a
``WhisperConfig`` (a ``WhisperModel``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.models.transformer import ArchConfig, TransformerLM
from repro_torch.models.whisper import WhisperConfig, WhisperModel

ARCH_MODULES = {
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "whisper-base": "repro_torch.configs.whisper_base",
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


Config = Union[ArchConfig, WhisperConfig]


def get_config(arch: str, reduced: bool = False) -> Config:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    mod = importlib.import_module(ARCH_MODULES[arch])
    return mod.reduced() if reduced else mod.config()


def build_model(arch_or_cfg, device="cuda", seed: int = 0,
                mesh=None) -> Union[TransformerLM, WhisperModel]:
    """The model of an arch id or config, its weights drawn from ``seed`` on
    ``device`` (CUDA by default; raises when there is none). On a ``mesh``
    whose "model" axis is above 1 it holds this rank's shards (a
    ``TransformerLM`` or a ``WhisperModel``)."""
    cfg = get_config(arch_or_cfg) if isinstance(arch_or_cfg, str) else arch_or_cfg
    if isinstance(cfg, WhisperConfig):
        return WhisperModel(cfg, device=device, seed=seed, mesh=mesh)
    return TransformerLM(cfg, device=device, seed=seed, mesh=mesh)


def shape_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    """The reference's skip rule: long_500k only for sub-quadratic archs."""
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention; pure full-attention arch"
    return True, ""


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of an input, without storage (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: Config, shape: ShapeSpec,
                reduced_scale: Optional[int] = None) -> Dict[str, TensorSpec]:
    """Every model input of a shape, as the reference declares them. Train:
    the full federated batch (tokens and the participation mask); prefill:
    the request batch's tokens; both with whisper's frame embeddings
    (B, S, d_model) bfloat16 and M-RoPE's positions3 (3, B, S). Decode: one
    new token and the position. ``reduced_scale`` shrinks the sequence and
    the batch (at least 8 and 1)."""
    S, B = shape.seq_len, shape.global_batch
    if reduced_scale:
        S, B = max(S // reduced_scale, 8), max(B // reduced_scale, 1)
    i32 = torch.int32
    if shape.kind == "decode":  # one token against a cache of S
        return {"token": TensorSpec((B, 1), i32), "pos": TensorSpec((), i32)}
    specs = {"tokens": TensorSpec((B, S), i32)}
    if shape.kind == "train":
        specs["participation"] = TensorSpec((B,), torch.float32)
    if isinstance(cfg, WhisperConfig):
        specs["enc_embeds"] = TensorSpec((B, S, cfg.d_model), torch.bfloat16)
    if getattr(cfg, "mrope", False):
        specs["positions3"] = TensorSpec((3, B, S), i32)
    return specs
