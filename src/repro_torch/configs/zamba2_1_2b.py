"""zamba2-1.2b — Mamba2 backbone + single shared attention block.
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, shared_attn_every=6,
    sub_quadratic=True,  # SSM state + seq-sharded shared-attn KV
    microbatches=2,
    source="[arXiv:2411.15242; hf]",
)
