"""repro_torch.roofline: dry-run records -> roofline terms and tables (port
of ``repro.roofline``; its HLO parser has no counterpart: the port's dry
run counts a step by running it on the meta device)."""
