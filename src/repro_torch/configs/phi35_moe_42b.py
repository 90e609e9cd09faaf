"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE, GQA kv=8.
[hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", arch_type="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    ffn_pattern=("moe",), num_experts=16, experts_per_token=2,
    moe_d_ff=6400, rope_theta=10_000.0,
    # expert grads are sparse/bursty — absmax steering reacts fastest
    density_policy="absmax",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
).validate()
