"""The assigned input shapes and each arch's input specs (``meta`` tensors,
the counterpart of the reference's ``ShapeDtypeStruct``).

train_* trace the train step; prefill_* the prefill pass; decode_* and
long_* the serve step (one token against a seq_len-deep cache or state).
long_500k is for sub-quadratic archs only: a pure full-attention arch
skips it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason if skipped). long_500k needs sub-quadratic
    attention."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "skipped(full-attention)"
    return True, ""


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``meta`` stand-ins for every model input of this cell: the token
    batch (and labels to train on; a vlm's patch embeddings, an audio
    arch's frames) for train and prefill, the one-token batch for decode
    (the serve state is built apart)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(shape.kind)
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), torch.int32)}
    batch = {"tokens": _meta((b, s), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = _meta((b, s), torch.int32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = _meta((b, cfg.n_patches, cfg.frontend_dim),
                                      torch.float32)
    if cfg.family == "audio":
        batch["frames"] = _meta((b, s, cfg.frontend_dim), torch.float32)
    return batch
