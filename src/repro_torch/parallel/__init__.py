"""repro_torch.parallel: logical-axis sharding, the per-layer gather of a
sharded step, and the GPipe pipeline over ``torch.distributed`` (port of
``repro.parallel``)."""
