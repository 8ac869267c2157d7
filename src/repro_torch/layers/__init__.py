"""Layers of the models: dense/norms/rotary, MLP, MoE, attention (self,
cached, paged and cross), RWKV-6, Mamba-2, W8A8."""
