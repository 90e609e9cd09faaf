"""The assigned input shapes and shape-only input specs (port of
``repro/configs/shapes.py``).

  train_4k     seq 4,096    global_batch 256   training step
  prefill_32k  seq 32,768   global_batch 32    inference prefill
  decode_32k   seq 32,768   global_batch 128   inference decode (1 token)
  long_500k    seq 524,288  global_batch 1     long-context decode

``long_500k`` needs sub-quadratic attention: ``applicable`` runs it only
for architectures with a sliding-window or recurrent layer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: InputShape) -> tuple:
    """Whether (arch, shape) is runnable: ``(ok, reason if not)``."""
    if shape.name != "long_500k":
        return True, ""
    kinds = {cfg.block_kind(i) for i in range(cfg.num_layers)}
    if kinds & {"mamba", "slstm", "mlstm", "swa"}:
        return True, ""
    return False, ("pure full-attention architecture: 500k KV cache decode "
                   "is out of scope per assignment (no sliding-window/"
                   "recurrent state to exploit)")


def token_dtype() -> torch.dtype:
    """The port's index dtype: tokens and labels are int64 (the
    reference's are int32)."""
    return torch.int64


def input_specs(cfg: ModelConfig, shape: InputShape, *,
                activation_dtype: Optional[str] = None) -> dict:
    """Shape-only stand-ins (``device="meta"`` tensors, nothing
    allocated) for every model input of this shape; tokens and labels
    int64, the port's index dtype, where the reference's are int32.

    train   -> {"tokens" | "embeds", "labels"}
    prefill -> {"tokens" | "embeds"}
    decode  -> {"tokens" (1 step), "pos"}: generated tokens always
               enter through the token embedding
    """
    adt = getattr(torch, activation_dtype or cfg.activation_dtype)
    B, S = shape.global_batch, shape.seq_len
    idx = token_dtype()

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "embeds":
            specs = {"embeds": meta((B, S, cfg.d_model), adt)}
        else:
            specs = {"tokens": meta((B, S), idx)}
        if shape.kind == "train":
            specs["labels"] = meta((B, S), idx)
        return specs
    return {"tokens": meta((B, 1), idx), "pos": meta((), idx)}
