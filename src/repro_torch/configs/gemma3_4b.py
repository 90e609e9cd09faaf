"""gemma3-4b — 5:1 local(sliding-window):global attention, 128k-class
context, head_dim decoupled from d_model. [hf:google/gemma-3-1b-pt]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", arch_type="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
    d_ff=10240, vocab_size=262144, head_dim=256,
    block_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
    sliding_window=1024, rope_theta=1_000_000.0,
    source="hf:google/gemma-3-1b-pt",
).validate()
