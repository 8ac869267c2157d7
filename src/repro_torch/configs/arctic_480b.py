"""arctic-480b — 128 experts top-2 + dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000,
    n_experts=128, top_k=2, dense_residual=True,
    param_dtype="bfloat16", optimizer="adafactor",
    microbatches=16,  # 480B: memory posture
    source="[hf:Snowflake/snowflake-arctic-base; hf]",
)
