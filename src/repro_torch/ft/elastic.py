"""Resume from the newest checkpoint on a device (port of
``repro.ft.elastic``).

``resume_on_device`` is the reference's ``resume_on_mesh`` without the
mesh: rebuild the step artifacts and restore the latest checkpoint (or
init fresh). Checkpoints are stored whole on the host, so the state,
optimizer moments and step counter survive bit for bit, and the data
pipeline resumes from the step counter (``data.synthetic`` is
step-indexed). Restoring onto another mesh waits for the port of the
reference's sharding (``repro.parallel``).
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.ft import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainstep import StepArtifacts, make_train_step


def resume_on_device(
    cfg: ModelConfig,
    ckpt_dir: str,
    *,
    device=None,
    opt_cfg: opt_lib.OptConfig | None = None,
    global_batch: int = 8,
    seq_len: int = 128,
) -> tuple[StepArtifacts, Any, int]:
    """Build step artifacts on ``device`` and restore the newest checkpoint
    onto it (or init fresh from seed 0 if none). Returns (artifacts, state,
    start_step)."""
    device = resolve_device(device)
    art = make_train_step(cfg, opt_cfg, global_batch=global_batch,
                          seq_len=seq_len, device=device)
    step = ckpt_lib.latest_step(ckpt_dir)
    if step is None:
        return art, art.init_fn(0), 0
    state = ckpt_lib.restore(ckpt_dir, step, art.state_shapes, device=device)
    return art, state, step
