"""repro_torch.data: the synthetic LM data pipeline (port of
``repro.data``)."""
