"""Paged KV cache bookkeeping: fixed-size token blocks in preallocated
device pools (the port's copy of ``paddle_tpu/serving/kv_cache.py``,
prefix-cache hooks included).

The pools are allocated ONCE per engine — [L, nkv, num_pages, page, d]
tensors that live for the engine's lifetime and that every step updates
in place — and requests own *pages* of them via a host-side block
table.  Admission control is therefore pure bookkeeping: a request fits
iff the allocator has enough free pages for it, and no device
allocation happens mid-serve.

Page 0 is reserved as the **null page**: the allocator never hands it
out, every unused block-table slot points at it, and the model's write
of padding-token k/v lands on it.  The ragged kernel masks by sequence
length and reads only pages below it, so the null page's contents are
never read.

With a ``PrefixCache`` attached (``enable_prefix_cache``), requests
also borrow cached pages (refcounted, read-only) and fork a partially
matching one copy-on-write; ``drain_copies`` hands the engine the page
copies to run on the device before the next forward.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["BlockAllocator", "PagedKVCache", "kv_bytes_per_token",
           "plan_capacity"]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BlockAllocator:
    """Refcounted free-list allocator over ``num_pages`` pool pages.

    Pages start single-owner (``alloc`` hands them out at refcount 1)
    and become shared through ``incref`` — the prefix cache borrows a
    cached page for every request reading it, plus one reference for
    the trie itself.  A page returns to the free list only when the
    last reference drops.

    Invariants:
      * page 0 is never allocated (the null page),
      * no page is freed while its refcount is > 1 (``free`` raises;
        ``decref`` only recycles at zero),
      * capacity == num_pages - 1, and free + allocated == capacity,
        where allocated counts distinct pages with refcount >= 1.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list: recently-freed pages are reused first, which
        # keeps the working set of pool pages small
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._owner: Dict[int, object] = {}   # allocating owner (debug)
        self._ref: Dict[int, int] = {}

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._ref)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def is_held(self, page: int) -> bool:
        return page in self._ref

    def alloc(self, n: int, owner=None) -> Optional[List[int]]:
        """Pop n pages at refcount 1, or None (and no change) if fewer
        are free."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = owner
            self._ref[p] = 1
        return pages

    def incref(self, pages: List[int]) -> None:
        for p in pages:
            if p == 0 or p not in self._ref:
                raise ValueError(f"incref of page {p} not allocated")
            self._ref[p] += 1

    def decref(self, pages: List[int]) -> List[int]:
        """Drop one reference per page; pages whose count reaches zero
        go back to the free list.  Returns the pages actually freed."""
        freed: List[int] = []
        for p in pages:
            if p == 0 or p not in self._ref:
                raise ValueError(f"decref of page {p} not allocated")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                del self._owner[p]
                self._free.append(p)
                freed.append(p)
        return freed

    def free(self, pages: List[int]) -> None:
        """Single-owner release: refuses shared pages outright, and a
        double free raises."""
        for p in pages:
            if p == 0 or p not in self._ref:
                raise ValueError(f"freeing page {p} not allocated")
            if self._ref[p] != 1:
                raise ValueError(
                    f"freeing page {p} with refcount {self._ref[p]} — "
                    "shared pages must be released via decref")
            del self._ref[p]
            del self._owner[p]
            self._free.append(p)


@dataclasses.dataclass
class _Entry:
    pages: List[int]           # pool pages, in logical-block order
    num_tokens: int = 0        # kv tokens written so far


class PagedKVCache:
    """Host-side page bookkeeping for one engine: request id -> block
    list, plus the [R, Bmax] block-table rows the kernel consumes.  The
    device pools themselves are owned by the engine; this class never
    holds device memory.

    With a ``PrefixCache`` attached (``enable_prefix_cache``),
    ``match_prefix`` seeds a new request's block list from the trie —
    full cached pages are borrowed (one reference each), a partially
    matching page is forked copy-on-write into a private page whose
    device copy the engine drains before the next forward — and
    ``donate`` retires a finished request's full pages into the trie
    instead of freeing them."""

    def __init__(self, num_pages: int, page_size: int, max_blocks: int):
        self.allocator = BlockAllocator(num_pages, page_size)
        self.page_size = int(page_size)
        self.max_blocks = int(max_blocks)    # Bmax of the block table
        self._table: Dict[object, _Entry] = {}
        self.prefix = None                   # Optional[PrefixCache]
        # COW forks awaiting their device copy: (src_page, dst_page);
        # one src reference is held per pending pair until drained
        self._pending_copies: List[tuple] = []

    def enable_prefix_cache(self):
        from .prefix_cache import PrefixCache
        self.prefix = PrefixCache(self.allocator, self.page_size)
        return self.prefix

    # -- allocation ------------------------------------------------------
    def pages_needed(self, rid, target_tokens: int) -> int:
        """Extra pages required to grow request rid to target_tokens."""
        have = len(self._table[rid].pages) if rid in self._table else 0
        return max(_cdiv(target_tokens, self.page_size) - have, 0)

    def grow(self, rid, target_tokens: int) -> bool:
        """Ensure rid owns pages covering target_tokens.  All-or-
        nothing: returns False (state unchanged) when the pool cannot
        cover it."""
        need = self.pages_needed(rid, target_tokens)
        if _cdiv(target_tokens, self.page_size) > self.max_blocks:
            return False
        if need:
            got = self.allocator.alloc(need, owner=rid)
            if got is None:
                return False
            self._table.setdefault(rid, _Entry([])).pages.extend(got)
        self._table.setdefault(rid, _Entry([]))
        return True

    def commit(self, rid, num_tokens: int) -> None:
        """Record that rid's kv is written up to num_tokens."""
        self._table[rid].num_tokens = num_tokens

    # -- prefix cache ----------------------------------------------------
    def match_prefix(self, rid, tokens: List[int]) -> int:
        """Seed rid's block list from the prefix cache: borrow every
        fully matching cached page, fork a partially matching one
        copy-on-write.  Returns the number of tokens whose kv the
        request inherits (0 when the cache is off, rid already has
        pages, or nothing matches); the request must re-feed everything
        past that point."""
        if self.prefix is None or rid in self._table:
            return 0
        pages, matched, partial = self.prefix.match(tokens)
        entry_pages = list(pages)
        total = matched
        if partial is not None:
            src, plen = partial
            got = self.allocator.alloc(1, owner=rid)
            if got is None:
                # no private page for the fork — keep the full-page hit
                self.prefix.release_partial(src)
            else:
                # the src reference taken by match() is held until the
                # engine drains this pair (drain_copies) or the request
                # is released before the copy ran
                self._pending_copies.append((src, got[0]))
                entry_pages.append(got[0])
                total += plen
                self.prefix.stats.forks += 1
        if not entry_pages:
            return 0
        self._table[rid] = _Entry(pages=entry_pages, num_tokens=total)
        return total

    def drain_copies(self) -> List[tuple]:
        """Hand the engine the (src_page, dst_page) COW pairs to copy
        on device, dropping the src references.  The caller MUST apply
        the copies before the next forward pass or allocation — after
        this call a src page may be evicted or recycled."""
        pairs, self._pending_copies = self._pending_copies, []
        for src, _dst in pairs:
            self.allocator.decref([src])
        return pairs

    def donate(self, rid, tokens: List[int], valid_tokens: int) -> int:
        """Completion path with the cache on: full pages covering the
        first ``valid_tokens`` of ``tokens`` (the kv actually written)
        move into the trie; the remainder is released.  Returns pages
        donated."""
        entry = self._table.pop(rid, None)
        if entry is None:
            return 0
        self._drop_pending_for(entry)
        full = min(valid_tokens // self.page_size, len(entry.pages))
        donated = entry.pages[:full]
        if self.prefix is not None and donated:
            self.prefix.insert(tokens[:full * self.page_size], donated)
        else:
            self.allocator.decref(donated)
        self.allocator.decref(entry.pages[full:])
        return len(donated)

    def evict_cached(self, num_pages: int) -> int:
        """Ask the trie to reclaim up to num_pages unreferenced cached
        pages (LRU).  No-op without a cache."""
        if self.prefix is None:
            return 0
        return self.prefix.evict(num_pages)

    def _drop_pending_for(self, entry: _Entry) -> None:
        """Cancel COW copies whose destination belongs to a request
        being torn down before the copy ran; their src refs drop."""
        if not self._pending_copies:
            return
        mine = set(entry.pages)
        keep: List[tuple] = []
        for src, dst in self._pending_copies:
            if dst in mine:
                self.allocator.decref([src])
            else:
                keep.append((src, dst))
        self._pending_copies = keep

    def release(self, rid) -> List[int]:
        """Drop all of rid's references (completion without donation,
        preemption, cancel).  Shared pages stay alive for the trie and
        any sibling readers; uniquely-owned pages return to the pool."""
        entry = self._table.pop(rid, None)
        if entry is None:
            return []
        self._drop_pending_for(entry)
        self.allocator.decref(entry.pages)
        return entry.pages

    def num_tokens(self, rid) -> int:
        return self._table[rid].num_tokens if rid in self._table else 0

    def block_row(self, rid) -> List[int]:
        """One block-table row, padded with the null page to Bmax."""
        pages = self._table[rid].pages if rid in self._table else []
        return (pages + [0] * self.max_blocks)[:self.max_blocks]

    def audit(self) -> dict:
        """Snapshot of the capacity invariant: every allocated page is
        either uniquely owned by one request, shared between requests
        and the trie, or cached with only the trie's reference — and
        ``free + unique_owned + shared + cached_idle == capacity``.
        ``ok`` is False when pages leak outside those states (e.g. a
        foreign owner holds pool pages)."""
        held = set()
        for e in self._table.values():
            held.update(e.pages)
        cached = set(self.prefix.cached_pages()) if self.prefix else set()
        free = self.allocator.num_free
        unique = len(held - cached)
        sharedc = len(held & cached)
        idle = len(cached - held)
        return {
            "free": free,
            "unique_owned": unique,
            "shared": sharedc,
            "cached_idle": idle,
            "capacity": self.allocator.capacity,
            "ok": (free + unique + sharedc + idle
                   == self.allocator.capacity
                   and self.allocator.num_allocated
                   == unique + sharedc + idle),
        }


# ---------------------------------------------------------------------------
# capacity planning (pure arithmetic, no device)
# ---------------------------------------------------------------------------

def kv_bytes_per_token(cfg, dtype_bytes: int = 2) -> int:
    """Paged-KV bytes one token costs across all layers (k and v)."""
    return (2 * cfg.num_hidden_layers * cfg.num_key_value_heads
            * cfg.head_dim * dtype_bytes)


def _param_count(cfg) -> int:
    """Dense llama parameter count from the config (embed + L blocks +
    final norm + lm_head), the number that dominates serving memory."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    nh, nkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    per_layer = (H * nh * d + 2 * H * nkv * d + nh * d * H  # attn
                 + 3 * H * I                                 # gated mlp
                 + 2 * H)                                    # norms
    return (cfg.vocab_size * H * 2                           # embed+head
            + cfg.num_hidden_layers * per_layer + H)


#: --kv-dtype axis of the capacity plan: page itemsize in bytes
KV_DTYPE_BYTES = {"bf16": 2, "fp16": 2, "int8": 1, "fp8": 1}


def plan_capacity(cfg, *, hbm_bytes: int, page_size: int = 128,
                  max_model_len: Optional[int] = None,
                  kv_dtype: Optional[str] = None,
                  kv_dtype_bytes: int = 2, weights_dtype_bytes: int = 2,
                  headroom_fraction: float = 0.10,
                  runtime_bytes: int = 0) -> dict:
    """Device-memory budget for one card: how many pool pages fit after
    weights, and how many concurrent max-length requests that sustains.
    Pure arithmetic.

    ``kv_dtype`` ("bf16"/"int8"/...) overrides ``kv_dtype_bytes`` and,
    for sub-2-byte pages, adds the quantized-KV path's per-page scale
    overhead: two f32 scales per (layer, kv head, page)."""
    max_len = int(max_model_len or cfg.max_position_embeddings)
    if kv_dtype is not None:
        if kv_dtype not in KV_DTYPE_BYTES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}; "
                             f"choose from {sorted(KV_DTYPE_BYTES)}")
        kv_dtype_bytes = KV_DTYPE_BYTES[kv_dtype]
    weights = _param_count(cfg) * weights_dtype_bytes
    usable = int(hbm_bytes * (1.0 - headroom_fraction)) - weights \
        - int(runtime_bytes)
    page_bytes = kv_bytes_per_token(cfg, kv_dtype_bytes) * page_size
    scale_bytes_per_page = 0
    if kv_dtype_bytes < 2:
        # k + v scale-pool entries across layers, f32 each
        scale_bytes_per_page = 2 * cfg.num_hidden_layers \
            * cfg.num_key_value_heads * 4
        page_bytes += scale_bytes_per_page
    num_pages = max(usable // page_bytes, 0)
    blocks_per_req = _cdiv(max_len, page_size)
    max_concurrent = (num_pages - 1) // blocks_per_req \
        if num_pages > 1 else 0
    return {
        "hbm_bytes": int(hbm_bytes),
        "weights_bytes": int(weights),
        "usable_kv_bytes": max(int(usable), 0),
        "page_size": int(page_size),
        "page_bytes": int(page_bytes),
        "kv_dtype": kv_dtype or f"{kv_dtype_bytes}B",
        "scale_bytes_per_page": int(scale_bytes_per_page),
        "num_pages": int(num_pages),
        "kv_bytes_per_token": kv_bytes_per_token(cfg, kv_dtype_bytes),
        "max_model_len": max_len,
        "blocks_per_request": int(blocks_per_req),
        "max_concurrent_requests": int(max_concurrent),
    }
