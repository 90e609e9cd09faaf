"""musicgen-medium — decoder-only transformer over EnCodec audio tokens;
the EnCodec/conditioning frontend is a STUB: input_specs provides
precomputed frame embeddings (assignment carve-out). [arXiv:2306.05284]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", arch_type="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, frontend="embeds",
    source="arXiv:2306.05284",
).validate()
