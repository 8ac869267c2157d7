"""Resume from the newest checkpoint, on a device or a mesh (port of
``repro.ft.elastic``).

``resume_on_device`` rebuilds the one-device step artifacts and restores
the latest checkpoint (or inits fresh). ``resume_on_mesh`` is the
reference's elastic scaling: scale-down (a node lost) and scale-up
(capacity arrives) are the same operation, rebuilding the sharded step for
the new mesh and restoring the latest checkpoint onto it with the new
mesh's layout. Checkpoints are stored whole on the host, so any mesh
whose extents divide the parameter dims works, and the state, optimizer
moments and step counter survive the reshape bit for bit; the data
pipeline resumes from the step counter (``data.synthetic`` is
step-indexed).
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
    return art, *_restore(art, ckpt_dir, device)


def resume_on_mesh(
    cfg: ModelConfig,
    mesh,
    ckpt_dir: str,
    opt_cfg: opt_lib.OptConfig | None = None,
    *,
    global_batch: int = 8,
    seq_len: int = 128,
) -> tuple[StepArtifacts, Any, int]:
    """Build the sharded step for ``mesh`` and restore the newest
    checkpoint onto it, each rank its blocks (or init fresh from seed 0 if
    none). Returns (artifacts, state, start_step)."""
    art = make_train_step(cfg, opt_cfg, mesh=mesh, global_batch=global_batch,
                          seq_len=seq_len)
    return art, *_restore(art, ckpt_dir, mesh.device)


def _restore(art: StepArtifacts, ckpt_dir: str, device) -> tuple[Any, int]:
    step = ckpt_lib.latest_step(ckpt_dir)
    if step is None:
        return art.init_fn(0), 0
    return ckpt_lib.restore(ckpt_dir, step, art.state_shapes, device=device,
                            shardings=art.state_shardings), step
