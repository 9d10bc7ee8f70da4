"""Quantized paged KV storage for the serving engine (the KV half of
``replicatinggpt_tpu/quant/``).

Page count is the engine's admission currency: every admitted request
reserves whole pages for its lifetime (serve/pages.py), so bytes per
page cap the concurrent requests a card holds. Storing K/V pages in
int8 (or fp8 e4m3) with per-row f32 scales roughly halves the bytes of
a bf16 page. :mod:`~.kv` holds the quantize-on-write and
dequant-on-gather math; the CUDA paged kernels dequantize inside their
loops. Weight quantization (``--weight-quant``, ``--act-quant``) is not
ported (ROADMAP queue A item 8).
"""

from __future__ import annotations

from dataclasses import dataclass

#: storage dtypes of the KV pages ("none" = the compute dtype)
QUANT_DTYPES = ("none", "int8", "fp8")
#: KV scale granularities: "page" = one f32 scale per written row (page
#: position) over the whole model dim; "head" = one per (row, head)
GRANULARITIES = ("page", "head")


@dataclass(frozen=True)
class QuantConfig:
    """How the KV pages are stored and how finely their scales resolve."""

    kv_dtype: str = "none"
    granularity: str = "page"

    def validate(self) -> "QuantConfig":
        if self.kv_dtype not in QUANT_DTYPES:
            raise ValueError(f"kv_dtype must be one of {QUANT_DTYPES}, "
                             f"got {self.kv_dtype!r}")
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"granularity must be one of {GRANULARITIES}, "
                             f"got {self.granularity!r}")
        return self

    @property
    def kv_enabled(self) -> bool:
        return self.kv_dtype != "none"


from .kv import (dequant_gathered, kv_itemsize, kv_qmax,  # noqa: E402
                 kv_store_dtype, pool_quant_mode, quantize_rows,
                 scale_bytes_per_token)

__all__ = ["QUANT_DTYPES", "GRANULARITIES", "QuantConfig", "kv_store_dtype",
           "kv_qmax", "kv_itemsize", "quantize_rows", "dequant_gathered",
           "pool_quant_mode", "scale_bytes_per_token"]
