"""repro_torch.ft: checkpoints, straggler detection and resume, on a device
or onto another mesh (port of ``repro.ft``)."""
