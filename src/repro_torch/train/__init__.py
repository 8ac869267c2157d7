"""Serving steps (port of ``repro.train.servestep``) and their capture as
CUDA graphs (``graphs``). Training is ROADMAP queue 1, item 10."""
