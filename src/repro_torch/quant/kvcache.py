"""KV-cache storage formats for the paged serving engine (port of
``repro.quant.kvcache``).

The paged pool (``layers.attention.PagedKVCache``) can store its K/V blocks
in a narrower dtype than the compute dtype: blocks are quantized at write
time (per-block, per-kv-head symmetric absmax scales in parallel scale
arrays) and dequantized inside the table-directed gather. This module says
which formats exist and what they cost in bytes, so the allocator, the
engine and the serve metrics agree on the footprint.
"""
from __future__ import annotations

import enum

import torch


class KVCacheDtype(enum.Enum):
    """Storage format of the paged KV pool."""

    BF16 = "bf16"   # the compute dtype, no scales array
    INT8 = "int8"   # symmetric per-block / per-kv-head absmax (quant/int8.py)

    @property
    def quantized(self) -> bool:
        return self is not KVCacheDtype.BF16

    @property
    def storage_dtype(self) -> torch.dtype:
        """The torch dtype the pool's k/v leaves are allocated in."""
        return {KVCacheDtype.BF16: torch.bfloat16,
                KVCacheDtype.INT8: torch.int8}[self]

    @property
    def itemsize(self) -> int:
        """Bytes per stored K or V element (excluding scales)."""
        return self.storage_dtype.itemsize

    def scale_bytes_per_block(self, n_kv_heads: int) -> int:
        """Bytes of f32 scales per pool block (K and V each carry one scale
        per kv head)."""
        return 2 * 4 * n_kv_heads if self.quantized else 0

    @classmethod
    def parse(cls, name: "str | KVCacheDtype | None") -> "KVCacheDtype":
        """'none'/None/'bf16' -> BF16; 'int8' -> INT8; enum passes through."""
        if isinstance(name, cls):
            return name
        if name is None or name in ("none", "bf16"):
            return cls.BF16
        try:
            return cls(name)
        except ValueError:
            raise ValueError(
                f"unknown KV cache dtype {name!r}; "
                f"one of {[m.value for m in cls]} or 'none'") from None


def kv_block_bytes(block_size: int, n_kv_heads: int, head_dim: int,
                   kv_dtype: KVCacheDtype = KVCacheDtype.BF16,
                   n_layers: int = 1) -> int:
    """Bytes one pool block occupies (K + V + scales) across ``n_layers``:
    the allocator's unit of account."""
    kv = 2 * block_size * n_kv_heads * head_dim * kv_dtype.itemsize
    return n_layers * (kv + kv_dtype.scale_bytes_per_block(n_kv_heads))
