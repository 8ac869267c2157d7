"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A :class:`Mesh` names its axes and their extents, holds this rank's
coordinates on it and one process group per axis: the ranks that share
every other coordinate. Ranks lie row-major over the shape, as the
reference's ``np.array(devices).reshape(shape)`` lays devices out: on a
(data, model) mesh, rank = data_index * model + model_index.

* ``make_production_mesh`` returns an **abstract** mesh, (16, 16) over
  ("data", "model") or (2, 16, 16) over ("pod", "data", "model"): no
  process groups, this rank at the origin. The sharding rules and the dry
  run read its shape; the port's collective helpers on it count bytes and
  move nothing (on meta tensors).
* ``free_port`` picks the port a new group's store listens on
  (``MASTER_PORT``, torchrun's ``--master-port``).
* ``init_mesh`` / ``make_local_mesh`` join the default process group,
  starting it if need be: with torchrun's ``RANK`` / ``WORLD_SIZE`` /
  ``MASTER_ADDR`` / ``MASTER_PORT`` set, over ``env://``; with none set, a
  world of one over an in-process store (no rendezvous at all). The
  backend is ``nccl`` for a CUDA device and ``gloo`` only for an explicit
  ``device="cpu"``: there is no silent switch to ``gloo`` on the card.
  ``backend="gloo"`` on a CUDA device is taken only when asked for: it
  runs several ranks on one card (NCCL refuses two ranks on one GPU), each
  collective staged through host memory (``core.distributed``).

The reference's activation hints (``layers.common.hint``, its
``with_sharding_constraint``) have no counterpart: under explicit
collectives no compiler places activations, so there is nothing to hint.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
import random
import socket
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

DP_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axes, their extents, this rank's coordinates and the process group
    of each axis (None for an axis of extent 1, whose collectives are
    skipped; ``groups`` None altogether for an abstract mesh)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    coords: tuple[int, ...] | None = None
    groups: dict[str, Any] | None = dataclasses.field(default=None,
                                                      compare=False)
    device: torch.device | None = None
    backend: str | None = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} do not match shape "
                             f"{self.shape}")
        if self.coords is None:
            object.__setattr__(self, "coords", (0,) * len(self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def abstract(self) -> bool:
        """No process groups: collectives count bytes and move nothing."""
        return self.groups is None

    @property
    def rank(self) -> int:
        return self.rank_of(self.coords)

    def rank_of(self, coords) -> int:
        r = 0
        for c, n in zip(coords, self.shape):
            r = r * n + c
        return r

    def axis_size(self, name: str) -> int:
        """The extent of ``name``; 1 for an axis the mesh does not have
        (the reference's ``layers.common.axis_size``)."""
        if name not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(name)]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along ``name`` (0 for a missing axis)."""
        if name not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(name)]

    def dp_axes(self) -> tuple[str, ...]:
        """The data-parallel axes: ('pod', 'data') on multi-pod meshes,
        ('data',) otherwise (the reference's ``dp_axes_present`` and
        ``sharding.data_axes``)."""
        return tuple(a for a in DP_AXES if a in self.axis_names)

    def axis_ranks(self, name: str) -> list[int]:
        """The global ranks along ``name`` that share this rank's other
        coordinates, in axis order."""
        i = self.axis_names.index(name)
        out = []
        for k in range(self.shape[i]):
            c = list(self.coords)
            c[i] = k
            out.append(self.rank_of(c))
        return out

    def group(self, name: str):
        """The process group of ``name`` (None for an axis of extent 1)."""
        if self.groups is None:
            raise RuntimeError("an abstract mesh has no process groups")
        return self.groups[name]

    def describe(self) -> str:
        return "x".join(str(n) for n in self.shape) + " " + str(
            dict(zip(self.axis_names, self.shape))) + (
            f" backend={self.backend}" if self.backend else "")

    def as_abstract(self) -> "Mesh":
        """This mesh without process groups, this rank at its coordinates:
        the collectives count bytes and move nothing (meta tensors)."""
        return Mesh(self.axis_names, self.shape, self.coords)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes, abstract: 16 x 16 = 256 ranks
    over ("data", "model"), or 2 x 16 x 16 = 512 with the "pod" axis (pure
    DP whose gradient reduction crosses pods)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def _init_default_group(backend: str, device: torch.device) -> None:
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the default process group runs {dist.get_backend()!r}, "
                f"but a mesh on {device.type} needs {backend!r}")
        return
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        if device.type == "cuda":
            local = int(env.get("LOCAL_RANK", rank))
            if backend == "gloo":
                # several ranks may share a card (staged collectives); with
                # nccl each rank needs a card of its own
                local %= torch.cuda.device_count()
            torch.cuda.set_device(local)
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
        return
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


BACKENDS = ("nccl", "gloo")
# free_port's range: below Linux's default ephemeral ports (32768-60999),
# which the kernel hands to any socket bound to port 0 (gloo's pair
# connections, another group's store)
_PORTS = (20000, 32768)


def free_port() -> int:
    """A localhost port that nothing listens on, for a process group's
    store (``MASTER_PORT``). Drawn at random below the ephemeral range:
    a port the kernel picked (a bind to port 0) could be handed to another
    process's socket between this check and the store's bind, which then
    fails with EADDRINUSE when several groups start at once."""
    draw = random.SystemRandom()
    for _ in range(1000):
        port = draw.randrange(*_PORTS)
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in {_PORTS}")


def init_mesh(shape, axis_names, *, device=None, backend=None) -> Mesh:
    """This rank's place on a mesh over the whole world (whose size must
    be the product of ``shape``), and one process group per axis of extent
    above 1. Every rank creates every group, in the same order, as
    ``new_group`` requires. ``backend``: ``nccl`` (the default on cuda) or
    ``gloo`` (the only one on the CPU; on cuda only when asked for)."""
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    device = resolve_device(device)
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on cuda needs a CUDA device")
        backend = backend or "nccl"
    elif device.type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl needs a CUDA device; a CPU mesh runs gloo")
        backend = "gloo"
    else:
        raise ValueError(f"a mesh runs on cuda or cpu, not {device}")
    _init_default_group(backend, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"world has {world}")
    coords, r = [], rank
    for n in reversed(shape):
        coords.append(r % n)
        r //= n
    mesh = Mesh(axis_names, shape, tuple(reversed(coords)), {},
                torch.device("cuda", torch.cuda.current_device())
                if device.type == "cuda" else device, backend)
    for i, name in enumerate(axis_names):
        mesh.groups[name] = None
        if shape[i] == 1:
            continue
        others = [range(n) for j, n in enumerate(shape) if j != i]
        for fixed in itertools.product(*others):
            ranks = []
            for k in range(shape[i]):
                c = list(fixed)
                c.insert(i, k)
                ranks.append(mesh.rank_of(c))
            g = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[name] = g
    return mesh


def make_local_mesh(data: int | None = None, model: int = 1, *,
                    device=None, backend=None) -> Mesh:
    """A (data, model) mesh over the world (torchrun's, or a world of one);
    ``data`` defaults to the world size over ``model``."""
    if data is None:
        world = (int(os.environ["WORLD_SIZE"]) if "WORLD_SIZE" in os.environ
                 else dist.get_world_size() if dist.is_initialized() else 1)
        data = world // model
    return init_mesh((data, model), ("data", "model"), device=device,
                     backend=backend)
