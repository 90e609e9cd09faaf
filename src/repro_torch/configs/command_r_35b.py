"""command-r-35b — parallel attention∥FFN blocks, no biases, GQA kv=8.
[hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", arch_type="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000, parallel_block=True,
    rope_theta=8_000_000.0,
    source="hf:CohereForAI/c4ai-command-r-v01",
).validate()
