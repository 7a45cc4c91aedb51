"""Quantized paged KV cache: int8 block pool + per-block-per-head scales,
and the cache carried through the layer loops with its mode-dispatching
writes and reads.

Two pool formats share one block table and one ``BlockAllocator``:

* unquantized: ``k``/``v`` [L, NB, BS, KV, D] in the activation dtype;
* int8: ``k``/``v`` [L, NB, BS, KV, D] int8 plus ``k_scale``/``v_scale``
  [L, NB, KV] f32 — ONE scale per (block, kv head), so the pool takes
  about half the bytes of a bf16 pool.  Reads dequantize in registers
  (``kernels/paged_attention_quant.py``, the int8 branch of
  ``kernels/flash_attention.py``); the quantized cache is never
  materialized densely on the serving path.

Write discipline (what keeps one scale per block sound), as in the JAX
package:

* a fresh block is quantized from exactly the tokens written into it,
  junk slots zeroed before the amax so stale data never inflates the
  scale;
* an appending write (decode, or a chunk's boundary block) dequantizes
  the block's live prefix, merges the new tokens and requantizes the
  whole block with the recomputed amax;
* copy-on-write copies the scale row with the value block.

The quantize-on-write ops are plain torch, as they are plain XLA in the
JAX package.  They keep its order of operations (``max(amax, 1e-20) /
127``, a true divide, round half to even, clip before the cast) so the
codes match bit for bit on the same inputs.  Every write updates the
pools in place, reads no device value on the host (offsets may be 0-d
device tensors: all block arithmetic is index arithmetic), and drops
writes through ``paged_cache._scatter_rows`` instead of indexing out of
range.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.paged_cache import (_scatter_rows, copy_blocks,
                                          gather_kv, gather_kv_bounded,
                                          write_decode_kv, write_prefill_kv)

INT8_MAX = 127.0
# floor on amax before the /127: keeps all-zero blocks at scale ~1e-22
# (dequant exactly 0) without 0/0 in the quantize divide.
AMAX_FLOOR = 1e-20

KV_CACHE_DTYPES = ("bf16", "int8")


def normalize_kv_cache_dtype(kv_cache_dtype: Optional[str]) -> str:
    """None / "bf16" / "bfloat16" name the unquantized pool (its element
    dtype is the activation dtype); "int8" the quantized one."""
    if kv_cache_dtype in (None, "bf16", "bfloat16"):
        return "bf16"
    if kv_cache_dtype == "int8":
        return "int8"
    raise ValueError(f"unknown kv_cache_dtype {kv_cache_dtype!r}; "
                     f"expected one of {KV_CACHE_DTYPES}")


# --------------------------------------------------------------------------
# The cache carried through the layer loops
# --------------------------------------------------------------------------

class KVCache(NamedTuple):
    """K/V pools [L, NB, BS, KV, D] plus (int8 mode only) their scale
    pools [L, NB, KV] f32; the scales are None in the unquantized mode."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.k, self.v, self.k_scale, self.v_scale)
                   if a is not None)


def cache_from_state(state) -> KVCache:
    return KVCache(state["k_pool"], state["v_pool"],
                   state.get("k_scales"), state.get("v_scales"))


def cache_to_state(cache: KVCache) -> dict:
    st = {"k_pool": cache.k, "v_pool": cache.v}
    if cache.quantized:
        st["k_scales"] = cache.k_scale
        st["v_scales"] = cache.v_scale
    return st


def make_kv_pool_quant(num_layers: int, num_blocks: int, block_size: int,
                       num_kv_heads: int, head_dim: int, device="cuda"
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor]:
    """(k_values, v_values [L, NB, BS, KV, D] int8, k_scales, v_scales
    [L, NB, KV] f32), all zero, on the card unless the caller asks for
    the CPU."""
    device = resolve_device(device)
    vshape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    sshape = (num_layers, num_blocks, num_kv_heads)
    return (torch.zeros(vshape, dtype=torch.int8, device=device),
            torch.zeros(vshape, dtype=torch.int8, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device))


# --------------------------------------------------------------------------
# Quantize / dequantize primitives
# --------------------------------------------------------------------------

def quantize_blocks(x: torch.Tensor, live: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block-per-head int8 quantization.

    x [..., BS, KV, D] float; live [..., BS] bool — slots outside the
    mask are zeroed before the amax (and quantize to exactly 0).  Returns
    (q int8 like x, scales [..., KV] f32) with ``scale = amax / 127``, so
    the round-trip error of a live value is at most scale / 2."""
    xf = torch.where(live[..., None, None], x.float(),
                     torch.zeros((), device=x.device))
    amax = xf.abs().amax(dim=(-3, -1))                          # [..., KV]
    scales = amax.clamp(min=AMAX_FLOOR) / INT8_MAX
    q = torch.round(xf / scales[..., None, :, None])
    return q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8), scales


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q [..., BS, KV, D] int8, scales [..., KV] -> f32 values."""
    return q.float() * scales[..., None, :, None]


# --------------------------------------------------------------------------
# Quantize-on-write pool ops (int8 counterparts of core.paged_cache)
# --------------------------------------------------------------------------

def _scatter_blocks(values, scales, layer, blk, q, sc, valid) -> None:
    """Write whole quantized blocks and their scale rows in place:
    ``values[layer, blk[r]] = q[r]`` and ``scales[layer, blk[r]] = sc[r]``
    for every ``valid`` row.  One index vector and one mask drive both
    scatters, so a redirected row carries identical payloads in both."""
    idx = blk.reshape(-1).long()
    ok = valid.reshape(-1)
    _scatter_rows(values[layer], idx, q.reshape(-1, *q.shape[-3:]), ok)
    _scatter_rows(scales[layer], idx, sc.reshape(-1, sc.shape[-1]), ok)


def write_prefill_kv_quant(values: torch.Tensor, scales: torch.Tensor,
                           layer: int, k: torch.Tensor,
                           block_table: torch.Tensor, ctx_lens: torch.Tensor,
                           pos_offset=0) -> None:
    """Quantize a prompt (or prompt chunk) into the int8 pool, in place.

    values [L, NB, BS, KV, D] int8; scales [L, NB, KV] f32; k [B, S, KV,
    D] holding positions ``pos_offset + i``; only absolute positions <
    ctx_lens are live.  Each touched block is quantized whole: blocks at
    or after ``pos_offset`` are fresh, and the one boundary block a chunk
    appends into merges its dequantized live prefix ``[0, lead)`` first.
    ``pos_offset`` is an int or a 0-d device tensor; nothing here reads
    it on the host.
    """
    B, S, KV, D = k.shape
    NB, bs = values.shape[1], values.shape[2]
    MB = block_table.shape[1]
    dev = k.device
    nb = -(-S // bs) + 1                       # static max touched blocks
    if torch.is_tensor(pos_offset):
        pos_offset = pos_offset.long()
    j0 = pos_offset // bs                      # first touched block
    lead = pos_offset - j0 * bs                # live prefix rows in block j0
    ctx = ctx_lens.long()

    # the chunk at rows [lead, lead + S) of a zero [B, nb * bs] buffer
    src = torch.arange(nb * bs, device=dev) - lead
    inside = (src >= 0) & (src < S)
    rows = k.float().index_select(1, src.clamp(0, S - 1))
    buf = torch.where(inside[None, :, None, None], rows,
                      torch.zeros((), device=dev)).reshape(B, nb, bs, KV, D)
    pos = (j0 * bs + torch.arange(nb * bs, device=dev)).reshape(nb, bs)
    live = (pos[None] >= pos_offset) & (pos[None] < ctx[:, None, None])

    # the table padded with the out-of-range sentinel NB, sliced at j0
    # (start clamped as dynamic_slice clamps it); sentinel columns are
    # never live, their writes drop
    btp = torch.cat([block_table.long(),
                     torch.full((B, nb), NB, dtype=torch.long, device=dev)],
                    1)
    cols = (torch.arange(nb, device=dev) + j0).clamp(0, MB)
    blk = btp.index_select(1, cols)                            # [B, nb]
    # chunk boundary: block j0 may already hold this sequence's tokens at
    # slots [0, lead) — dequantize and merge them before requantizing
    safe0 = blk[:, 0].clamp(max=NB - 1)
    old = dequantize_blocks(values[layer].index_select(0, safe0),
                            scales[layer].index_select(0, safe0))
    old_live = ((torch.arange(bs, device=dev)[None] < lead)
                & (pos[0][None] < ctx[:, None]))               # [B, bs]
    buf[:, 0] += torch.where(old_live[..., None, None], old,
                             torch.zeros((), device=dev))
    live[:, 0] |= old_live

    q, sc = quantize_blocks(buf, live)
    _scatter_blocks(values, scales, layer, blk, q, sc, live.any(-1))


def write_decode_kv_quant(values: torch.Tensor, scales: torch.Tensor,
                          layer: int, k_new: torch.Tensor,
                          block_table: torch.Tensor, positions: torch.Tensor
                          ) -> None:
    """Append one token per sequence to its (private, CoW-guaranteed)
    tail block, in place: dequantize the live prefix, insert the token,
    requantize the block with the recomputed amax.  positions [B]:
    absolute position of the new token; negative = inactive slot, whose
    write drops (its read of ``block_table[b, 0]`` is harmless)."""
    bs = values.shape[2]
    dev = k_new.device
    valid = positions >= 0
    pos = positions.long().clamp(min=0)
    col = (pos // bs).clamp(max=block_table.shape[1] - 1)
    blk = block_table.gather(1, col[:, None])[:, 0].long()     # [B]
    off = pos % bs                                             # [B]
    old = dequantize_blocks(values[layer].index_select(0, blk),
                            scales[layer].index_select(0, blk))
    slot = torch.arange(bs, device=dev)[None, :]               # [1, bs]
    zero = torch.zeros((), device=dev)
    buf = torch.where((slot < off[:, None])[..., None, None], old, zero)
    buf = torch.where((slot == off[:, None])[..., None, None],
                      k_new[:, None].float(), buf)
    q, sc = quantize_blocks(buf, slot <= off[:, None])
    _scatter_blocks(values, scales, layer, blk, q, sc, valid)


def gather_kv_quant(values: torch.Tensor, scales: torch.Tensor, layer: int,
                    block_table: torch.Tensor, max_len: int,
                    dtype=torch.float32) -> torch.Tensor:
    """Dequantizing counterpart of ``gather_kv`` (reference path):
    [B, max_len, KV, D] in ``dtype``."""
    bs = values.shape[2]
    nb = -(-max_len // bs)
    blk = block_table[:, :nb].long()                           # [B, nb]
    x = dequantize_blocks(values[layer][blk], scales[layer][blk])
    return x.reshape(blk.shape[0], nb * bs,
                     *values.shape[3:])[:, :max_len].to(dtype)


def gather_kv_quant_bounded(values: torch.Tensor, scales: torch.Tensor,
                            layer: int, block_table: torch.Tensor,
                            max_len: int, num_live_blocks,
                            dtype=torch.float32) -> torch.Tensor:
    """``gather_kv_quant`` that reads and dequantizes only the first
    ``num_live_blocks`` table entries; the rest of the [B, max_len, KV,
    D] view stays zero (reference path: reads the count on the host)."""
    bs = values.shape[2]
    nb = -(-max_len // bs)
    B = block_table.shape[0]
    buf = torch.zeros((B, nb, bs) + tuple(values.shape[3:]), dtype=dtype,
                      device=values.device)
    for j in range(min(int(num_live_blocks), nb)):
        blk = block_table[:, j].long()
        buf[:, j] = dequantize_blocks(values[layer, blk],
                                      scales[layer, blk]).to(dtype)
    return buf.reshape(B, nb * bs, *values.shape[3:])[:, :max_len]


def copy_blocks_quant(values: torch.Tensor, scales: torch.Tensor,
                      src: torch.Tensor, dst: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copy-on-write for the quantized pool, in place: the scale rows
    move with the value blocks."""
    return copy_blocks(values, src, dst), copy_blocks(scales, src, dst)


# --------------------------------------------------------------------------
# Mode-dispatching writes / reads over a KVCache (what the layers call)
# --------------------------------------------------------------------------

def kv_write_prefill(cache: KVCache, layer, k, v, block_table, ctx_lens,
                     pos_offset=0) -> KVCache:
    if cache.quantized:
        write_prefill_kv_quant(cache.k, cache.k_scale, layer, k, block_table,
                               ctx_lens, pos_offset)
        write_prefill_kv_quant(cache.v, cache.v_scale, layer, v, block_table,
                               ctx_lens, pos_offset)
    else:
        write_prefill_kv(cache.k, layer, k, block_table, ctx_lens,
                         pos_offset)
        write_prefill_kv(cache.v, layer, v, block_table, ctx_lens,
                         pos_offset)
    return cache


def kv_write_decode(cache: KVCache, layer, k, v, block_table,
                    positions) -> KVCache:
    if cache.quantized:
        write_decode_kv_quant(cache.k, cache.k_scale, layer, k, block_table,
                              positions)
        write_decode_kv_quant(cache.v, cache.v_scale, layer, v, block_table,
                              positions)
    else:
        write_decode_kv(cache.k, layer, k, block_table, positions)
        write_decode_kv(cache.v, layer, v, block_table, positions)
    return cache


def kv_gather_bounded(cache: KVCache, layer, block_table, max_len: int,
                      num_live_blocks, dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kv_gather`` whose page walk stops at ``num_live_blocks``;
    positions past the live pages are zeros (reference path)."""
    if cache.quantized:
        return tuple(gather_kv_quant_bounded(p, s, layer, block_table,
                                             max_len, num_live_blocks, dtype)
                     for p, s in ((cache.k, cache.k_scale),
                                  (cache.v, cache.v_scale)))
    return tuple(gather_kv_bounded(p, layer, block_table, max_len,
                                   num_live_blocks).to(dtype)
                 for p in (cache.k, cache.v))


def kv_gather(cache: KVCache, layer, block_table, max_len: int,
              dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    if cache.quantized:
        return tuple(gather_kv_quant(p, s, layer, block_table, max_len,
                                     dtype)
                     for p, s in ((cache.k, cache.k_scale),
                                  (cache.v, cache.v_scale)))
    return tuple(gather_kv(p, layer, block_table, max_len).to(dtype)
                 for p in (cache.k, cache.v))
