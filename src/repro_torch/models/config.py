"""Model/architecture configuration dataclass shared by all 10 assigned
architectures — a verbatim copy of ``repro.models.config`` (the port keeps
its own copy and imports nothing of the JAX package)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // num_heads

    # layer pattern, cycled over layers. entries:
    #   attn        full-causal GQA attention
    #   swa         sliding-window GQA attention
    #   mamba       selective-SSM (Mamba) block
    #   slstm/mlstm xLSTM blocks
    block_pattern: Tuple[str, ...] = ("attn",)
    # ffn per layer, cycled:  mlp | moe | none
    ffn_pattern: Tuple[str, ...] = ("mlp",)

    # attention
    rope_theta: float = 10_000.0
    sliding_window: int = 4096
    parallel_block: bool = False       # command-r style attn ∥ ffn
    use_bias: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                  # per-expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba)
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0               # 0 -> ceil(d_model / 16)

    # frontend: tokens (LM) | embeds (audio/vlm stub — precomputed
    # frame/patch embeddings of shape (B, S, d_model))
    frontend: str = "tokens"

    # adaptive layer-wise density (core/adaptk.py, DESIGN.md §9):
    # "" = fixed-k; "uniform" | "variance" | "absmax" is the default
    # --density-policy the training CLI resolves for this arch
    density_policy: str = ""

    # numerics
    param_dtype: str = "float32"
    activation_dtype: str = "float32"
    # perf knob (§Perf): pin the residual-stream scan carry sharded over
    # 'model' — 16x smaller activation stacks for the backward pass at the
    # cost of per-layer all-gathers
    shard_activations: bool = False

    # citation / provenance
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank if self.ssm_dt_rank else max(1, -(-self.d_model // 16))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    def ffn_kind(self, layer: int) -> str:
        return self.ffn_pattern[layer % len(self.ffn_pattern)]

    @property
    def pattern_period(self) -> int:
        import math
        return abs(math.lcm(len(self.block_pattern), len(self.ffn_pattern)))

    def layer_sig(self, layer: int) -> Tuple[str, str]:
        return (self.block_kind(layer), self.ffn_kind(layer))

    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff else self.d_ff

    def validate(self) -> "ModelConfig":
        assert self.d_model % self.num_heads == 0 or self.head_dim, self.name
        assert self.num_heads % self.num_kv_heads == 0, self.name
        if "moe" in self.ffn_pattern:
            assert self.num_experts > 0 and self.experts_per_token > 0, self.name
        assert self.frontend in ("tokens", "embeds"), self.name
        return self

    def reduced(self, **over) -> "ModelConfig":
        """Smoke-test variant of the same family: ≤2 layers, d_model ≤ 512,
        ≤4 experts (assignment requirement)."""
        period = self.pattern_period
        layers = min(2 * period, max(period, 2))
        hd = 64 if self.hd >= 64 else self.hd
        heads = max(2, min(4, self.num_heads))
        kv = max(1, min(heads, self.num_kv_heads))
        while heads % kv:
            kv -= 1
        small = dict(
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=min(self.d_model, 256),
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd if self.head_dim else None,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            num_shared_experts=min(self.num_shared_experts, 1)
            if self.num_shared_experts else 0,
            moe_d_ff=min(self.moe_d_ff, 256) if self.moe_d_ff else 0,
            sliding_window=128,
        )
        hd2 = small["d_model"] // small["num_heads"]
        if small["head_dim"] is not None:
            small["head_dim"] = hd2
        small.update(over)
        return dataclasses.replace(self, **small).validate()
