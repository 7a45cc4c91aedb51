"""The cache carried through the layer loops, and its mode-dispatching
writes.

Only the unquantized (bf16 / f32) pool is ported in this slice; the int8
pool format of the JAX package (per-block-per-head scales, in-register
dequant) is ROADMAP A8, and asking for it raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.paged_cache import write_decode_kv, write_prefill_kv

KV_CACHE_DTYPES = ("bf16",)

_INT8_TODO = ("kv_cache_dtype='int8' is not ported to repro_torch yet "
              "(ROADMAP A8: the int8 KV pool and its kernels)")


def normalize_kv_cache_dtype(kv_cache_dtype: Optional[str]) -> str:
    """None / "bf16" / "bfloat16" name the unquantized pool."""
    if kv_cache_dtype in (None, "bf16", "bfloat16"):
        return "bf16"
    if kv_cache_dtype == "int8":
        raise NotImplementedError(_INT8_TODO)
    raise ValueError(f"unknown kv_cache_dtype {kv_cache_dtype!r}; "
                     f"expected one of {KV_CACHE_DTYPES}")


class KVCache(NamedTuple):
    """K/V pools [L, NB, BS, KV, D] plus (int8 mode only) their scale
    pools [L, NB, KV]; the scales are always None in this slice."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def cache_from_state(state) -> KVCache:
    return KVCache(state["k_pool"], state["v_pool"],
                   state.get("k_scales"), state.get("v_scales"))


def cache_to_state(cache: KVCache) -> dict:
    st = {"k_pool": cache.k, "v_pool": cache.v}
    if cache.quantized:
        st["k_scales"] = cache.k_scale
        st["v_scales"] = cache.v_scale
    return st


def kv_write_prefill(cache: KVCache, layer, k, v, block_table, ctx_lens,
                     pos_offset=0) -> KVCache:
    if cache.quantized:
        raise NotImplementedError(_INT8_TODO)
    write_prefill_kv(cache.k, layer, k, block_table, ctx_lens, pos_offset)
    write_prefill_kv(cache.v, layer, v, block_table, ctx_lens, pos_offset)
    return cache


def kv_write_decode(cache: KVCache, layer, k, v, block_table,
                    positions) -> KVCache:
    if cache.quantized:
        raise NotImplementedError(_INT8_TODO)
    write_decode_kv(cache.k, layer, k, block_table, positions)
    write_decode_kv(cache.v, layer, v, block_table, positions)
    return cache
