"""Layers of the LMs: dense/norms/rotary, MLP, MoE, attention, RWKV-6,
W8A8."""
