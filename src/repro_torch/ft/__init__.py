"""repro_torch.ft: checkpoints, straggler detection and resume (port of
``repro.ft``; the re-mesh waits for the port of ``repro.parallel``)."""
