"""whisper-base — enc-dec backbone; conv/audio frontend is a STUB
(input_specs provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    n_encoder_layers=6, encoder_len=1500,
    norm_type="layernorm", activation="gelu", gated_mlp=False,
    qkv_bias=True, tie_embeddings=True,
    source="[arXiv:2212.04356; unverified]",
)
