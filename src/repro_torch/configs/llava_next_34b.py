"""llava-next-34b — LM backbone of LLaVA-NeXT (anyres tiling); the
ViT/SigLIP vision tower + projector is a STUB: input_specs provides
precomputed patch embeddings (assignment carve-out).
[hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", arch_type="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000, frontend="embeds",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
).validate()
