"""Named hardware generations (port of ``repro.core.hwregistry``).

The TPU generations are the reference's, kept so that the port's solver can
be held against the reference plan for plan. ``h100`` is the port's default:
the kernels it plans for are the hand-written CUDA kernels of
``repro_torch.kernels``.

Selection precedence: explicit argument > active context >
``REPRO_TORCH_HW`` env var > ``h100``.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import torch

from repro_torch.core.perfmodel import TPU_V5E, HardwareSpec

DEFAULT_HW_ENV = "REPRO_TORCH_HW"

TPU_V4 = HardwareSpec(
    name="tpu_v4",
    peak_flops_bf16=275e12,
    peak_flops_int8=275e12,
    hbm_bw=1228e9,
    ici_bw=50e9,
    vmem_bytes=16 * 2**20,
    vmem_bw=9e12,
    hbm_latency_bytes=512.0,
    peak_flops_f32=137.5e12,
)

TPU_V6E = HardwareSpec(
    name="tpu_v6e",
    peak_flops_bf16=918e12,
    peak_flops_int8=1836e12,
    hbm_bw=1640e9,
    ici_bw=100e9,
    vmem_bytes=32 * 2**20,
    vmem_bw=22e12,
    hbm_latency_bytes=512.0,
    mxu=256,
    peak_flops_f32=459e12,
)

# NVIDIA H100 SXM. Peaks are NVIDIA's data sheet (dense, no sparsity):
# 989 TFLOP/s bf16 and 1,979 TOP/s int8 on the tensor cores, 67 TFLOP/s f32
# on the CUDA cores (each the rate of a route of the port's fat GEMM,
# ``HardwareSpec.peak_flops``), 3.35 TB/s HBM3, 450 GB/s
# NVLink each way. Shared memory a block may use: 232,448 bytes; 132 SMs
# (both read from the card when one is present, see ``get_hw``).
# vmem_bw is the shared-memory rate, 128 B/clock/SM x 132 SMs x 1.98 GHz
# boost; hbm_latency_bytes is a modeled knee (a run of one 128-byte line
# already streams at most of the rate), not a measurement.
H100 = HardwareSpec(
    name="h100",
    peak_flops_bf16=989e12,
    peak_flops_int8=1979e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    vmem_bytes=232_448,
    vmem_bw=128 * 132 * 1.98e9,
    hbm_latency_bytes=128.0,
    peak_flops_f32=67e12,
    kind="gpu",
    sm_count=132,
)

_REGISTRY: dict[str, HardwareSpec] = {}


def register_hw(spec: HardwareSpec) -> HardwareSpec:
    """Register (or replace) a named generation; returns the spec."""
    _REGISTRY[spec.name.lower()] = spec
    return spec


for _spec in (TPU_V4, TPU_V5E, TPU_V6E, H100):
    register_hw(_spec)


@functools.cache
def _on_card(spec: HardwareSpec) -> HardwareSpec:
    """``spec`` with the SM count and shared memory per block of the card
    in this process, when there is one."""
    if not torch.cuda.is_available():
        return spec
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return dataclasses.replace(
        spec, sm_count=props.multi_processor_count,
        vmem_bytes=props.shared_memory_per_block_optin)


def get_hw(name: str | HardwareSpec) -> HardwareSpec:
    """Resolve a generation by name (a HardwareSpec passes through)."""
    if isinstance(name, HardwareSpec):
        return name
    try:
        spec = _REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown hardware generation {name!r}; "
            f"registered: {sorted(_REGISTRY)}"
        ) from None
    return _on_card(spec) if spec.kind == "gpu" else spec


def list_hw() -> list[str]:
    return sorted(_REGISTRY)


def default_hw() -> HardwareSpec:
    """Process default: ``REPRO_TORCH_HW`` env var, else h100."""
    return get_hw(os.environ.get(DEFAULT_HW_ENV, H100.name))
