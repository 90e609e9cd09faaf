"""stablelm-1.6b — MHA-equivalent GQA kv=32. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", arch_type="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=5632, vocab_size=100352, rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-2-1_6b",
).validate()
