"""Paged KV cache (paper §III.A 'Management of Shared Key-Value Vectors').

Two halves, as in the JAX package:

* **Host side** — ``BlockAllocator``: a pre-allocated fixed pool of block
  ids, free-list allocation, ref-counted blocks, prefix-hash reuse
  (copy-on-write), watermark admission.  Pure Python, ported near
  verbatim; it drives the scheduler.

* **Device side** — ONE dense pool per K and V,
  ``[L, num_blocks, block_size, kv_heads, head_dim]``, plus an int32
  ``block_table [max_seqs, max_blocks_per_seq]``.  The JAX package updates
  the pools by buffer donation; here every write updates them **in
  place**.  Out-of-range scatters drop in XLA but are a device assert in
  CUDA, so dropped writes are redirected (see ``_scatter_rows``) instead
  of indexed out of range, and no write syncs the host.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

# --------------------------------------------------------------------------
# Host-side allocator
# --------------------------------------------------------------------------


class OutOfBlocksError(RuntimeError):
    pass


@dataclass
class _Block:
    ref: int = 0
    token_hash: Optional[bytes] = None   # set only for full, immutable blocks


class BlockAllocator:
    """Ref-counted fixed-pool allocator with prefix reuse.

    Prefix reuse: a *full* block of a prompt is content-addressed by the
    hash of (all tokens up to and including the block). A new request whose
    prompt shares that prefix gets the same physical block with ref+1 —
    the paper's "cache reuse strategy based on request features".
    """

    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_reuse: bool = True,
                 watermark_frac: float = 0.01):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_reuse = enable_prefix_reuse
        self.watermark = max(1, int(num_blocks * watermark_frac))
        self._blocks = [_Block() for _ in range(num_blocks)]
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._hash_to_block: Dict[bytes, int] = {}
        self.stats = {"allocated": 0, "reused": 0, "freed": 0, "cow": 0}

    # -- basics ---------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    def can_allocate(self, n: int) -> bool:
        return self.num_free - n >= self.watermark

    def _alloc_raw(self) -> int:
        if not self._free:
            raise OutOfBlocksError("KV block pool exhausted")
        b = self._free.pop()
        self._blocks[b].ref = 1
        self._blocks[b].token_hash = None
        self.stats["allocated"] += 1
        return b

    def free(self, block_id: int) -> None:
        blk = self._blocks[block_id]
        assert blk.ref > 0, f"double free of block {block_id}"
        blk.ref -= 1
        if blk.ref == 0:
            if blk.token_hash is not None:
                self._hash_to_block.pop(blk.token_hash, None)
                blk.token_hash = None
            self._free.append(block_id)
            self.stats["freed"] += 1

    def free_sequence(self, block_ids: Sequence[int]) -> None:
        for b in block_ids:
            self.free(b)

    def fork_sequence(self, block_ids: Sequence[int]) -> List[int]:
        """Share a sequence's blocks with a fork (parallel sampling / beam
        candidates): every block's refcount is bumped, including a partial
        tail — the first divergent append on either fork triggers
        copy-on-write (``grow`` returns the source block for the device
        block-copy)."""
        for b in block_ids:
            assert self._blocks[b].ref > 0, f"fork of freed block {b}"
            self._blocks[b].ref += 1
        return list(block_ids)

    # -- prefix-aware prompt allocation ----------------------------------
    @staticmethod
    def _hash_prefix(tokens: Sequence[int]) -> bytes:
        return hashlib.blake2b(np.asarray(tokens, np.int32).tobytes(),
                               digest_size=16).digest()

    def allocate_prompt(self, tokens: Sequence[int],
                        register: bool = True) -> Tuple[List[int], int]:
        """Allocate blocks for a prompt. Returns (block_ids, num_reused_blocks).

        Full blocks are content-addressed and may be shared; the trailing
        partial block is always private.

        ``register=False`` still *looks up* (and shares) existing hashed
        blocks but does not content-address fresh ones — for callers that
        cannot guarantee the hashed content will ever land in the pool.
        The serving scheduler registers eagerly: a reusing prompt always
        rewrites the shared block bit-identically rather than trusting
        its contents, and ``free`` drops a block's hash entry the moment
        its refcount hits 0, so aborted or failed dispatches cannot leave
        stale prefix-cache entries behind.
        """
        n = len(tokens)
        n_full = n // self.block_size
        ids: List[int] = []
        reused = 0
        for i in range(n_full):
            h = self._hash_prefix(tokens[: (i + 1) * self.block_size])
            if self.enable_prefix_reuse and h in self._hash_to_block:
                b = self._hash_to_block[h]
                self._blocks[b].ref += 1
                ids.append(b)
                reused += 1
                continue
            b = self._alloc_raw()
            if register:
                self._blocks[b].token_hash = h
                self._hash_to_block[h] = b
            ids.append(b)
        if n % self.block_size or n == 0:
            ids.append(self._alloc_raw())
        self.stats["reused"] += reused
        return ids, reused

    def allocate_private(self, n: int) -> List[int]:
        """``n`` fresh blocks for one sequence alone: never looked up by
        content and never content-addressed, so never shared (a
        sliding-window ring overwrites its blocks as it wraps)."""
        return [self._alloc_raw() for _ in range(n)]

    def register_full_block(self, block_id: int,
                            tokens: Sequence[int]) -> None:
        """Content-address a block *after* allocation (register-on-write).

        ``allocate_prompt`` hashes only the full blocks of the tokens it
        is given — for a chunked admission, just the first chunk.  Blocks
        grown for continuation chunks become hashable only once the chunk
        that fills them has executed; the scheduler calls this with the
        prompt prefix through the block's last token.  No-ops when prefix
        reuse is off, when the block is already content-addressed (it was
        itself a reused prefix block), or when another live block owns
        the hash (first writer wins; we cannot retroactively dedupe a
        block that is already scattered into the pool).
        """
        if not self.enable_prefix_reuse:
            return
        blk = self._blocks[block_id]
        assert blk.ref > 0, f"register_full_block of freed block {block_id}"
        if blk.token_hash is not None:
            return
        h = self._hash_prefix(tokens)
        if h in self._hash_to_block:
            return
        blk.token_hash = h
        self._hash_to_block[h] = block_id

    def ref(self, block_id: int) -> int:
        """Current refcount of a block (0 == free)."""
        return self._blocks[block_id].ref

    def audit(self) -> Dict[str, int]:
        """Leak/consistency snapshot for tests and ``engine.health()``.

        live_blocks + num_free must equal num_blocks; every hash entry
        must map to a live block that owns that hash (a dangling entry
        would serve stale prefix-cache hits).  Raises AssertionError on
        inconsistency instead of returning a lie.
        """
        live = sum(1 for b in self._blocks if b.ref > 0)
        assert live + self.num_free == self.num_blocks, \
            f"block accounting broken: {live} live + {self.num_free} " \
            f"free != {self.num_blocks}"
        for h, bid in self._hash_to_block.items():
            blk = self._blocks[bid]
            assert blk.ref > 0, f"hash entry -> freed block {bid}"
            assert blk.token_hash == h, \
                f"hash entry -> block {bid} owning a different hash"
        return {"live_blocks": live, "free_blocks": self.num_free,
                "hash_entries": len(self._hash_to_block)}

    def grow_prefill(self, block_ids: List[int], start_pos: int,
                     num_tokens: int, tokens: Sequence[int]
                     ) -> Tuple[List[int], int]:
        """``grow`` for a prefill chunk, with content-addressed reuse.

        Any *new* block the chunk will completely cover (the chunk writes
        all ``block_size`` of its slots) may instead share an existing
        block whose registered hash matches ``tokens`` up to that block's
        end — the continuation-chunk counterpart of ``allocate_prompt``'s
        prefix reuse.  Safe because the chunk then rewrites the shared
        block with bit-identical content (same tokens, same absolute
        positions, deterministic projections — and a fully-covered block
        is always a *fresh* quantize in int8 mode, never a boundary
        merge).  Partially-covered blocks (the chunk's tail) stay
        private raw allocations.  Prefill chunks never CoW: ``start_pos``
        is this sequence's own computed length, so the current tail is
        private.  Returns (block_ids, num_reused_blocks).
        """
        assert not self._tail_needs_cow(block_ids, start_pos)
        if self.blocks_needed(block_ids, start_pos, num_tokens) \
                > self.num_free:
            raise OutOfBlocksError("KV block pool exhausted")
        block_ids = list(block_ids)
        end = start_pos + num_tokens
        reused = 0
        while len(block_ids) * self.block_size < end:
            i = len(block_ids)                       # next block index
            blk_end = (i + 1) * self.block_size
            if self.enable_prefix_reuse and blk_end <= end:
                h = self._hash_prefix(tokens[:blk_end])
                b = self._hash_to_block.get(h)
                if b is not None:
                    self._blocks[b].ref += 1
                    block_ids.append(b)
                    reused += 1
                    continue
            block_ids.append(self._alloc_raw())
        self.stats["reused"] += reused
        return block_ids, reused

    def append_slot(self, block_ids: List[int], seq_len: int) -> Tuple[List[int], Optional[int]]:
        """Ensure capacity for one more token at position seq_len.

        Returns (block_ids, copied_from): if the tail block is shared
        (ref > 1) it is copy-on-write'd; copied_from is the old block id the
        device must copy data out of, else None.
        """
        block_ids, cow = self.grow(block_ids, seq_len, 1)
        return block_ids, (cow[0] if cow else None)

    def _tail_needs_cow(self, block_ids: Sequence[int],
                        start_pos: int) -> bool:
        """A write at start_pos lands in the current tail block and that
        tail is shared — the single predicate both ``blocks_needed`` and
        ``grow`` must agree on (the fused planner budgets with the former
        and relies on the latter not raising)."""
        return bool(start_pos % self.block_size and block_ids
                    and self._blocks[block_ids[-1]].ref > 1)

    def blocks_needed(self, block_ids: Sequence[int], start_pos: int,
                      num_tokens: int) -> int:
        """New blocks ``grow`` would consume for writes at positions
        [start_pos, start_pos + num_tokens), including a CoW replacement."""
        end = start_pos + num_tokens
        n = max(0, -(-end // self.block_size) - len(block_ids))
        if self._tail_needs_cow(block_ids, start_pos):
            n += 1                                   # CoW'd tail is a new block
        return n

    def grow(self, block_ids: List[int], start_pos: int,
             num_tokens: int = 1
             ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Ensure capacity for ``num_tokens`` writes starting at start_pos.

        Bulk form of ``append_slot`` for the fused decode horizon: allocates
        every block the horizon will touch in one host pass. Returns
        (block_ids, cow): cow is a (src_block, dst_block) pair the device
        must copy (shared tail copy-on-write), else None. Only the current
        tail can need CoW: blocks past it are freshly allocated and private.

        Atomic: capacity is checked up front, so a raise leaves both the
        allocator and the caller's block list untouched.
        """
        if self.blocks_needed(block_ids, start_pos, num_tokens) \
                > self.num_free:
            raise OutOfBlocksError("KV block pool exhausted")
        cow = None
        if self._tail_needs_cow(block_ids, start_pos):
            tail = block_ids[-1]                    # CoW: shared full-prefix tail
            nb = self._alloc_raw()
            self.free(tail)
            block_ids = block_ids[:-1] + [nb]
            cow = (tail, nb)
            self.stats["cow"] += 1
        else:
            block_ids = list(block_ids)
        end = start_pos + num_tokens
        while len(block_ids) * self.block_size < end:
            block_ids.append(self._alloc_raw())
        return block_ids, cow

    def utilization(self) -> float:
        return 1.0 - self.num_free / self.num_blocks




# --------------------------------------------------------------------------
# Device-side pool ops (in place; no host sync)
# --------------------------------------------------------------------------


def make_kv_pool(num_layers: int, num_blocks: int, block_size: int,
                 num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-allocated pool: (k_pool, v_pool) each [L, num_blocks, bs, KV, D],
    on the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _scatter_rows(flat: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                  valid: torch.Tensor) -> None:
    """``flat[idx[r]] = rows[r]`` for every ``valid`` row, in place.

    Dropped rows are redirected to the target of the first valid row and
    carry that row's payload (or, when no row is valid, to row 0 carrying
    its current contents), so every duplicate index writes an identical
    value: the scatter stays deterministic, never indexes out of range
    and never asks the host how many rows are valid."""
    # index_select, not idx[first]: indexing with a 0-d device tensor
    # would read it on the host
    has = valid.any()
    first = valid.to(torch.int32).argmax().reshape(1)
    tgt0 = torch.where(has, idx.index_select(0, first),
                       torch.zeros(1, dtype=idx.dtype, device=idx.device))
    fill = torch.where(has, rows.index_select(0, first), flat[:1])
    tail = (slice(None),) + (None,) * (rows.dim() - 1)
    idx = torch.where(valid, idx, tgt0)
    rows = torch.where(valid[tail], rows, fill)
    flat.index_put_((idx,), rows)


def write_decode_kv(pool: torch.Tensor, layer: int, k_new: torch.Tensor,
                    block_table: torch.Tensor, positions: torch.Tensor
                    ) -> torch.Tensor:
    """Scatter one token's K (or V) per sequence into the paged pool.

    pool: [L, NB, BS, KV, D]; k_new: [B, KV, D]; block_table: [B, MB];
    positions: [B] absolute position of the new token.  Negative
    positions (inactive decode slots, seq_len == 0) are dropped.
    Updates ``pool`` in place and returns it.
    """
    NB, bs = pool.shape[1], pool.shape[2]
    valid = positions >= 0
    pos = positions.long().clamp(min=0)
    col = (pos // bs).clamp(max=block_table.shape[1] - 1)
    blk = block_table.gather(1, col[:, None])[:, 0].long()
    flat = blk * bs + pos % bs
    lp = pool[layer].view(NB * bs, *pool.shape[3:])
    _scatter_rows(lp, flat, k_new.to(pool.dtype), valid)
    return pool


def write_prefill_kv(pool: torch.Tensor, layer: int, k: torch.Tensor,
                     block_table: torch.Tensor, ctx_lens: torch.Tensor,
                     pos_offset=0) -> torch.Tensor:
    """Scatter a prompt (or prompt chunk) K/V into the pool, in place.

    k: [B, S, KV, D] (padded); k[:, i] holds position pos_offset + i
    (``pos_offset`` an int or a 0-d device tensor); only absolute
    positions < ctx_lens are written.
    """
    B, S = k.shape[:2]
    NB, bs = pool.shape[1], pool.shape[2]
    if torch.is_tensor(pos_offset):
        pos_offset = pos_offset.long()
    pos = pos_offset + torch.arange(S, device=k.device)             # [S]
    col = (pos // bs).clamp(max=block_table.shape[1] - 1)
    blk = block_table[:, col].long()                                # [B, S]
    flat = blk * bs + (pos % bs)[None, :]
    valid = pos[None, :] < ctx_lens.long()[:, None]                 # [B, S]
    lp = pool[layer].view(NB * bs, *pool.shape[3:])
    _scatter_rows(lp, flat.reshape(-1),
                  k.reshape(B * S, *k.shape[2:]).to(pool.dtype),
                  valid.reshape(-1))
    return pool


def gather_kv_bounded(pool: torch.Tensor, layer: int,
                      block_table: torch.Tensor, max_len: int,
                      num_live_blocks) -> torch.Tensor:
    """``gather_kv`` that only reads the first ``num_live_blocks`` table
    entries; positions past the live pages are zeros (reference path)."""
    bs = pool.shape[2]
    nb = -(-max_len // bs)
    B = block_table.shape[0]
    buf = torch.zeros((B, nb, bs) + tuple(pool.shape[3:]), dtype=pool.dtype,
                      device=pool.device)
    for j in range(min(int(num_live_blocks), nb)):
        buf[:, j] = pool[layer, block_table[:, j].long()]
    return buf.reshape(B, nb * bs, *pool.shape[3:])[:, :max_len]


def gather_kv(pool: torch.Tensor, layer: int, block_table: torch.Tensor,
              max_len: int) -> torch.Tensor:
    """Gather a contiguous [B, max_len, KV, D] copy of each row's first
    blocks: the plain versions of the attention kernels, and the ring
    decode of sliding-window layers (``max_len = MB * BS``, the whole
    ring); ``max_len`` need not be a block multiple."""
    bs = pool.shape[2]
    nb = -(-max_len // bs)
    blk = block_table[:, :nb].long()
    g = pool[layer][blk]                                  # [B, nb, bs, KV, D]
    return g.reshape(blk.shape[0], nb * bs, *pool.shape[3:])[:, :max_len]


def copy_blocks(pool: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor) -> torch.Tensor:
    """Copy-on-write block copy ``pool[:, src[i]] -> pool[:, dst[i]]`` for
    every layer, in place (the contents never visit the host)."""
    pool[:, dst.long()] = pool[:, src.long()]
    return pool
