"""rwkv6-3b — Finch: data-dependent decay, attention-free.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    norm_type="layernorm", tie_embeddings=False,
    sub_quadratic=True,  # O(1) state: runs long_500k
    microbatches=4,
    source="[arXiv:2404.05892; hf]",
)
