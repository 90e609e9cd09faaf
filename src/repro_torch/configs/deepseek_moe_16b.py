"""deepseek-moe-16b — fine-grained 64-expert top-6 MoE with 2 shared
experts. [arXiv:2401.06066]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", arch_type="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    ffn_pattern=("moe",), num_experts=64, experts_per_token=6,
    num_shared_experts=2, moe_d_ff=1408,
    source="arXiv:2401.06066",
).validate()
