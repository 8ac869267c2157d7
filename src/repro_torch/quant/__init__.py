"""Post-training int8 quantization for the balanced-GEMM stack (port of
``repro.quant``).

* :mod:`repro_torch.quant.int8`: symmetric int8 calibration (per-tensor and
  per-channel), ``quantize``/``dequantize``, scale propagation,
  ``QuantizedLinear`` and the KV blocks' ``quantize_block``;
* :mod:`repro_torch.quant.kvcache`: the paged pool's storage formats and
  their bytes;
* :mod:`repro_torch.quant.prequant`: quantize a parameter tree once at load;
* :mod:`repro_torch.layers.quantized`: the W8A8 layer path whose GEMMs run
  int8 x int8 with the per-channel requantization in the kernel's epilogue.
"""
from repro_torch.quant.int8 import (
    QMAX,
    Calibrator,
    QTensor,
    QuantizedLinear,
    absmax_scale,
    combine_scales,
    dequantize,
    dequantize_block,
    quantize,
    quantize_block,
    quantize_linear,
    quantize_per_channel,
    quantize_per_tensor,
)
from repro_torch.quant.kvcache import KVCacheDtype, kv_block_bytes

__all__ = [
    "QMAX",
    "Calibrator",
    "KVCacheDtype",
    "QTensor",
    "QuantizedLinear",
    "absmax_scale",
    "combine_scales",
    "dequantize",
    "dequantize_block",
    "kv_block_bytes",
    "quantize",
    "quantize_block",
    "quantize_linear",
    "quantize_per_channel",
    "quantize_per_tensor",
]
