"""xlstm-125m — alternating mLSTM/sLSTM blocks, no separate FFN (d_ff=0).
[arXiv:2405.04517]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", arch_type="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "slstm"), ffn_pattern=("none",),
    source="arXiv:2405.04517",
).validate()
