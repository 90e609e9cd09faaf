"""Architecture registry (port of ``repro.configs``): the 10 assigned
architectures as data, and the assigned input shapes.  ``get_config(id)``
/ ``--arch <id>`` resolve here."""
from __future__ import annotations

from repro_torch.configs import (
    command_r_35b,
    deepseek_moe_16b,
    gemma3_4b,
    jamba_15_large,
    llama32_1b,
    llava_next_34b,
    musicgen_medium,
    phi35_moe_42b,
    stablelm_16b,
    xlstm_125m,
)
from repro_torch.configs.shapes import (INPUT_SHAPES, InputShape,
                                        applicable, input_specs)
from repro_torch.models.config import ModelConfig

ARCHS = {
    c.CONFIG.name: c.CONFIG
    for c in (
        phi35_moe_42b, llama32_1b, stablelm_16b, gemma3_4b, jamba_15_large,
        musicgen_medium, llava_next_34b, command_r_35b, xlstm_125m,
        deepseek_moe_16b,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list:
    return sorted(ARCHS)


__all__ = ["ARCHS", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "applicable", "get_config", "input_specs", "list_archs"]
