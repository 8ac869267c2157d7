"""command-r-plus-104b — dense GQA, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000,
    qkv_bias=False, tie_embeddings=True,  # cohere ties embeddings
    param_dtype="bfloat16", optimizer="adafactor",
    microbatches=8,
    attn_chunk=4096, loss_chunk=1024,  # 104B memory posture
    source="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
)
