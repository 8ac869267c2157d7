"""llama-3.2-vision-11b — text backbone with gated cross-attn image layers;
vision tower is a STUB (input_specs provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256,
    cross_attn_every=5, n_image_tokens=1600,
    rope_theta=500000.0,
    microbatches=2,
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
)
