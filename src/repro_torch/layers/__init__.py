"""Layers of the dense LM: dense/norms/rotary, MLP, attention."""
