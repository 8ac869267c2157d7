"""Training and serving steps (port of ``repro.train``): the optimizers
(``optimizer``), the training step (``trainstep``), the serving steps
(``servestep``) and their capture as CUDA graphs (``graphs``)."""
