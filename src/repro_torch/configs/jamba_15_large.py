"""jamba-1.5-large-398b — Mamba:attention 7:1 interleave, 16-expert top-2
MoE on alternate layers. [arXiv:2403.19887]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", arch_type="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    ffn_pattern=("mlp", "moe"),
    num_experts=16, experts_per_token=2, moe_d_ff=24576,
    ssm_state_dim=16, ssm_expand=2,
    source="arXiv:2403.19887",
).validate()
