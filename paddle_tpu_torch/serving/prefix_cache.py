"""Shared-prefix KV reuse: a radix (trie) index over refcounted pages
(the port's copy of ``paddle_tpu/serving/prefix_cache.py``; stdlib
only).

``ragged_paged_attention`` reads kv through per-request block tables,
so two requests whose tables point at the same pool page cost one page
of device memory and no extra compute.  This module is the host-side
index that finds those pages.

The trie is keyed on token-id sequences at **page granularity**: every
node holds one *full* pool page and the ``page_size`` token ids whose kv
it contains.  ``match()`` walks full-page chunks, then finishes with a
partial match against the children of the deepest node — a prompt whose
shared prefix ends mid-page still reuses that page's leading tokens.  A
partially matched page is **copy-on-write**: the caller forks it into a
private page before any request writes into it (with int8 pools the
fork copies the page's scales too), so the cached copy is immutable for
future matchers.

Reference counting (``BlockAllocator`` in kv_cache.py) is the ownership
model: the trie holds exactly one reference per cached page, every
borrowing request holds one more, and a page returns to the free list
only when the last reference drops.  A cached page whose only reference
is the trie's is evictable; ``evict()`` sweeps those in LRU order when
the scheduler's admission watermark comes under pressure.  Completed
requests *donate* their full pages into the trie instead of freeing
them — the cache populates itself from real traffic.

Invariant: every pool page is in exactly one of three states — free,
uniquely owned by one request (non-cached), or cached (trie-held, with
zero or more borrowers) — and ``free + uniquely-owned + cached ==
capacity``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

__all__ = ["PrefixCache", "PrefixStats"]


@dataclasses.dataclass
class PrefixStats:
    """Cumulative counters for one cache (the engine mirrors
    ``evicted_pages`` into the serving stats)."""

    lookups: int = 0
    hits: int = 0              # lookups that matched >= 1 token
    hit_tokens: int = 0        # tokens served from cached pages
    forks: int = 0             # copy-on-write forks of partial pages
    inserted_pages: int = 0    # pages donated into the trie
    deduped_pages: int = 0     # donations dropped as duplicates
    evicted_pages: int = 0     # cached pages reclaimed under pressure


class _Node:
    """One cached full page: ``chunk`` is the page_size token ids whose
    kv the pool page holds, ``children`` keys the next full chunk."""

    __slots__ = ("chunk", "page", "children", "parent")

    def __init__(self, chunk: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}


def _common_prefix_len(a: Tuple[int, ...], b: List[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class PrefixCache:
    """Radix index from token-id sequences to pool pages.

    The cache never allocates pages itself — donated pages arrive with
    the donor's reference, which the trie inherits; matches hand out
    extra references via ``allocator.incref``.  The allocator is shared
    with the engine's ``PagedKVCache``, so the admission math stays
    exact: a cached page is "held" to the allocator whether zero or ten
    requests borrow it.
    """

    def __init__(self, allocator, page_size: int):
        self.allocator = allocator
        self.page_size = int(page_size)
        self._root = _Node((), 0, None)
        # LRU over nodes: oldest first; match/insert touch to the end
        self._lru: "OrderedDict[_Node, None]" = OrderedDict()
        self.stats = PrefixStats()

    # -- introspection ---------------------------------------------------
    def cached_pages(self) -> List[int]:
        return [n.page for n in self._lru]

    # -- lookup ----------------------------------------------------------
    def _touch(self, node: _Node) -> None:
        if node in self._lru:
            self._lru.move_to_end(node)

    def _walk(self, tokens: List[int], cap: int):
        """Longest full-page descent, then the best partial child.
        Returns (full_nodes, partial_node, partial_len)."""
        p = self.page_size
        node, full = self._root, []
        n = 0
        while n + p <= cap:
            child = node.children.get(tuple(tokens[n:n + p]))
            if child is None:
                break
            full.append(child)
            node = child
            n += p
        best, best_len = None, 0
        rest = tokens[n:cap]
        if rest:
            for child in node.children.values():
                m = _common_prefix_len(child.chunk, rest)
                if m > best_len:
                    best, best_len = child, m
        return full, best, best_len

    def peek(self, tokens: List[int]) -> int:
        """Dry-run match length (no refs taken, no LRU touch) — the
        router's placement signal: how many of ``tokens`` this replica
        would serve from cache."""
        cap = max(len(tokens) - 1, 0)
        full, _best, best_len = self._walk(tokens, cap)
        return len(full) * self.page_size + best_len

    def match(self, tokens: List[int], cap: Optional[int] = None):
        """Longest cached prefix of ``tokens``, capped at ``cap`` tokens
        (default ``len(tokens) - 1`` — at least one token must always be
        fed so the step can sample).

        Returns ``(pages, matched, partial)``: ``pages`` are the fully
        matched pool pages (one reference taken on each), ``matched``
        counts their tokens, and ``partial`` is ``None`` or
        ``(src_page, plen)`` — a cached page whose first ``plen`` tokens
        extend the match but which the caller must FORK (copy-on-write)
        before writing; one reference is taken on ``src_page`` and the
        caller releases it once the fork copy has executed."""
        if cap is None:
            cap = max(len(tokens) - 1, 0)
        self.stats.lookups += 1
        full, best, best_len = self._walk(tokens, cap)
        pages = []
        for node in full:
            self.allocator.incref([node.page])
            self._touch(node)
            pages.append(node.page)
        partial = None
        if best is not None and best_len > 0:
            self.allocator.incref([best.page])
            self._touch(best)
            partial = (best.page, best_len)
        matched = len(pages) * self.page_size
        if matched or partial:
            self.stats.hits += 1
            self.stats.hit_tokens += matched + best_len
        return pages, matched, partial

    def release_partial(self, src_page: int) -> None:
        """Drop the reference ``match`` took on a partial page (fork
        aborted, or the fork copy has been applied)."""
        self.allocator.decref([src_page])

    # -- donation --------------------------------------------------------
    def insert(self, tokens: List[int], pages: List[int]) -> None:
        """Donate full pages: ``pages[i]`` holds the kv of
        ``tokens[i*p:(i+1)*p]``.  The trie inherits the donor's one
        reference per page; a chunk already cached keeps the existing
        page and the donated duplicate is released instead."""
        p = self.page_size
        node = self._root
        for i, page in enumerate(pages):
            chunk = tuple(int(t) for t in tokens[i * p:(i + 1) * p])
            if len(chunk) < p:
                # defensive: never index partial chunks
                self.allocator.decref([page])
                continue
            child = node.children.get(chunk)
            if child is not None:
                # duplicate content (or the donor was borrowing this
                # very page): the trie keeps its copy, the donor's
                # reference is dropped
                self.allocator.decref([page])
                if child.page != page:
                    self.stats.deduped_pages += 1
                self._touch(child)
                node = child
                continue
            child = _Node(chunk, page, node)
            node.children[chunk] = child
            self._lru[child] = None
            self.stats.inserted_pages += 1
            node = child

    # -- eviction --------------------------------------------------------
    def _evict_node(self, node: _Node) -> List[int]:
        del node.parent.children[node.chunk]
        del self._lru[node]
        freed = self.allocator.decref([node.page])
        self.stats.evicted_pages += 1
        return freed

    def evict(self, num_pages: int) -> int:
        """LRU sweep: reclaim up to ``num_pages`` cached pages whose
        only reference is the trie's.  Only leaves are evicted (an
        interior node still anchors its children's token prefix);
        repeated passes let a freed leaf expose its parent.  Returns
        the number of pages actually returned to the free list."""
        freed = 0
        while freed < num_pages:
            progressed = False
            for node in list(self._lru):
                if node.children:
                    continue
                if self.allocator.refcount(node.page) != 1:
                    continue  # borrowed by a live request — never freed
                freed += len(self._evict_node(node))
                progressed = True
                if freed >= num_pages:
                    break
            if not progressed:
                break
        return freed
