"""Block-paged KV serving in PyTorch: a paged pool, prefix reuse, chunked
prefill and draft-model speculative decoding on the continuous-batching
scheduler (``models/scheduler.py``).

Counterpart of ``kubeflow_tpu/models/paged.py``.  The fixed-slot pool
gives every row ``slot_len`` cache positions; here K/V live in ONE flat
pool of ``num_pages x page_len`` positions a layer
(``layers.PagedKVCache``), and a row holds ``ceil(len / page_len)`` pages,
resolved through its page table into the flat positions
``layers.PagedSlots`` carries into the model:

    pool          [num_pages * page_len, kv_h, d]   (page 0: the null page)
    page table    row -> [p3, p7, p1, ...]          (logical page -> physical)
    read indices  row -> the pool position of each of its L logical slots
                  (pages not allocated point at the null page, which the
                  row's mask hides)

* **Prefix sharing.**  Page-sized chunks of the raw prompt key a trie
  (``PrefixCache``): identical prefixes map to the same read-only pages,
  prefilled once.  Copy-on-write holds by construction: only fully-real
  prompt pages are shared, and decode writes start at the padded prompt
  length, past them.
* **Chunked prefill.**  The unshared prompt suffix prefills in
  ``KFT_SERVE_PREFILL_CHUNK``-token chunks (K2, causal and end-aligned
  over the rows' gathered prefix), one chunk between decode quanta, so a
  long prompt never stalls the pool.
* **Speculative decoding.**  A draft model of the same vocabulary
  proposes ``KFT_SERVE_SPEC_TOKENS`` greedy tokens a step from its own
  pool (the same page tables, pointers in lockstep); one target pass over
  [current, d_1..d_k] verifies them, and each row emits the longest
  prefix where d_i is the target's argmax plus the target's next token:
  exactly the target's greedy stream.  Spec steps run only while every
  live row is greedy; sampled rows take the normal quantum.

Decode is K5 over each row's view gathered from the pool
(``index_select``, the counterpart of the reference's XLA gather); the
verify pass is the plain attention the reference runs outside Pallas
(``layers.verify_attention``).  Masked slots add exact zeros and the
first token replays the lock path's generator recipe
(``generate.sample_first``), so a request's tokens equal the lock path's
(greedy and seeded) up to the last bits that another batch shape moves.

Under a mesh (``mesh=``, the reference's ``paged.py:45-55, 511-573``)
the flat pool's positions shard over the data axes
(``sharding.page_pool_spec``; ``num_pages`` rounds up to a multiple of
``pool_shards``, so a page never straddles two processes): a process
writes only the positions it owns, and a step's view is assembled from
each owner's positions with one collective a layer
(``layers.PagedKVCache``).  Lanes stay replicated, as in the reference:
every process steps every lane, its heads split over ``tp``.  The page
tables, free list and prefix trie are the same on every process, which
all apply rank 0's decisions (``parallel/lockstep.py``).  A mesh with no
data axis keeps ``pool_shards`` at 1.  A draft model under a mesh raises
at construction: the draft pool's mirroring is not mesh-aware, and the
service serves the fixed-slot pool instead (``spec-decode-mesh``).

``KFT_SERVE_PAGED=0`` pins a service to the fixed-slot pool
(``models/serve.py`` records and counts why).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

import torch

from kubeflow_tpu_torch.models.generate import (
    NEG_INF,
    SamplingRows,
    decode_step,
    pad_bias_rows,
    prompt_positions,
    row_generators,
    sample_first,
)
from kubeflow_tpu_torch.models.layers import PagedKVCache, PagedSlots
from kubeflow_tpu_torch.models.scheduler import (
    DEFAULT_PRIORITY,
    DecodeScheduler,
    PendingRequest,
    _Slot,
)
from kubeflow_tpu_torch.parallel.sharding import (
    data_groups,
    page_pool_shards,
    page_pool_spec,
)
from kubeflow_tpu_torch.platform import config


# -- the device steps ---------------------------------------------------------


def read_indices(page_rows: torch.Tensor, page_len: int) -> torch.Tensor:
    """[W, M] physical page ids -> [W, M * page_len] flat pool positions."""
    W = page_rows.shape[0]
    offsets = torch.arange(page_len, device=page_rows.device)
    return (page_rows[:, :, None] * page_len + offsets).reshape(W, -1)


def _resolve(page_rows: torch.Tensor, slots: torch.Tensor,
             page_len: int) -> torch.Tensor:
    """Logical slots [W, s] -> flat pool positions through the page table."""
    lanes = torch.arange(page_rows.shape[0], device=slots.device)[:, None]
    return page_rows[lanes, slots // page_len] * page_len + slots % page_len


def prefill_chunk(model, cache: PagedKVCache, tokens: torch.Tensor,
                  positions: torch.Tensor, read: torch.Tensor, start: int,
                  lengths: torch.Tensor,
                  last_logits: torch.Tensor) -> torch.Tensor:
    """One chunked-prefill pass: ``tokens`` [b, c] land at logical slots
    [start, start + c) of each row, whose pool positions are ``read``
    [b, L].  Returns ``last_logits`` [b, vocab] with row i's replaced by
    the logits of its last valid token when slot ``lengths[i] - 1`` falls
    in this chunk; the head runs on b rows (``logits_at``), not b x c.
    Counterpart of the reference's ``_prefill_chunk``."""
    b, c = tokens.shape
    ps = PagedSlots(write=read[:, start:start + c], read=read, slots=None,
                    pool_positions=cache.pool_positions, prefix_len=start)
    last = lengths - 1 - start
    in_chunk = (last >= 0) & (last < c)
    picked = model(tokens, positions=positions, cache=cache, cache_slots=ps,
                   logits_at=last.clamp(0, c - 1))
    return torch.where(in_chunk[:, None], picked, last_logits)


def paged_pool_steps(model, state, rows: SamplingRows, write: torch.Tensor,
                     page_rows: torch.Tensor, *, page_len: int,
                     quantum: int):
    """``quantum`` decode steps over the paged pool: the fixed pool's
    ``scheduler.pool_steps`` with each row's write slot, clamped to the
    last slot, resolved through the page table.  A vacated lane's table
    row is zeros, so it steps on writing the null page.  ``state`` (its
    cache a ``PagedKVCache``) advances in place; returns ``(write, toks
    [quantum, W], dones [quantum, W])``, all on the device: nothing here
    reads a tensor on the host."""
    last = state.pad_bias.shape[1] - 1
    read = read_indices(page_rows, page_len)
    pool = state.cache.pool_positions
    toks, dones = [], []
    for _ in range(quantum):
        slots = write.clamp_max(last)[:, None]
        ps = PagedSlots(write=_resolve(page_rows, slots, page_len),
                        read=read, slots=slots, pool_positions=pool)
        toks.append(decode_step(model, state, rows, cache_slots=ps))
        dones.append(state.done)
        write = write + 1
    return write, torch.stack(toks), torch.stack(dones)


def draft_propose(model, cache: PagedKVCache, token, pos, write, pad_rows,
                  page_rows, *, k: int, page_len: int) -> torch.Tensor:
    """k + 1 greedy draft steps from the draft's pool; returns the
    proposals d_1..d_k [W, k].  The (k + 1)-th step's proposal is dropped:
    it writes slot write + k, so the draft's cache has no hole when the
    target accepts all k.  A rejected tail's writes go stale above the
    pointer, hidden until the step that reaches their slot overwrites
    them.  Counterpart of the reference's ``_draft_propose``."""
    last = pad_rows.shape[1] - 1
    read = read_indices(page_rows, page_len)
    outs = []
    for _ in range(k + 1):
        slots = write.clamp_max(last)[:, None]
        ps = PagedSlots(write=_resolve(page_rows, slots, page_len),
                        read=read, slots=slots,
                        pool_positions=cache.pool_positions)
        logits = model(token[:, None], positions=pos[:, None], cache=cache,
                       pad_bias=pad_rows, cache_slots=ps)
        token = logits[:, -1].argmax(dim=-1)
        outs.append(token)
        pos, write = pos + 1, write + 1
    return torch.stack(outs[:k], dim=1)


def spec_verify(model, cache: PagedKVCache, token, drafts, pos, write,
                pad_rows, page_rows, *,
                page_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One target pass over [current, d_1..d_k] a row (k + 1 queries,
    each seeing the slots up to its own): ``(greedy [W, k + 1], accepted
    [W])``, accepted the length of the longest prefix of the drafts that
    equals the target's argmax.  Row i emits greedy[i, :accepted + 1]:
    the accepted drafts, which are the target's greedy tokens by the
    match, and the token after them.  Counterpart of ``_spec_verify``."""
    W, L = pad_rows.shape
    k = drafts.shape[1]
    steps = torch.arange(k + 1, device=token.device)[None, :]
    slots = (write[:, None] + steps).clamp_max(L - 1)
    ps = PagedSlots(write=_resolve(page_rows, slots, page_len),
                    read=read_indices(page_rows, page_len), slots=slots,
                    pool_positions=cache.pool_positions)
    seq = torch.cat([token[:, None], drafts], dim=1)
    logits = model(seq, positions=pos[:, None] + steps, cache=cache,
                   pad_bias=pad_rows, cache_slots=ps)
    greedy = logits.argmax(dim=-1)
    match = (drafts == greedy[:, :k]).long()
    return greedy, torch.cumprod(match, dim=1).sum(dim=1)


# -- the host structures ------------------------------------------------------


class PageAllocator:
    """Host-side free list of physical pages with refcounts.  Page 0 is
    the null page: unallocated logical pages and vacated lanes' writes
    resolve to it, always behind the mask."""

    def __init__(self, total_pages: int):
        if total_pages < 2:
            raise ValueError(
                f"paged pool needs >= 2 pages (1 null + 1 usable), got "
                f"{total_pages}")
        self.total = total_pages
        self._free = list(range(total_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated_count(self) -> int:
        return len(self._refs)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages at refcount 1, or None when the pool is short
        (the caller retries after evictions free pages)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def retain(self, pages):
        for p in pages:
            self._refs[p] += 1

    def release(self, pages):
        for p in pages:
            n = self._refs[p] - 1
            if n < 0:
                raise AssertionError(f"page {p} over-released")
            if n == 0:
                del self._refs[p]
                self._free.append(p)
            else:
                self._refs[p] = n


class _PrefixNode:
    __slots__ = ("page", "chunk", "parent", "children", "row_refs",
                 "last_use")

    def __init__(self, page, chunk, parent):
        self.page = page
        self.chunk = chunk
        self.parent = parent
        self.children: dict = {}
        self.row_refs = 0
        self.last_use = 0


class PrefixCache:
    """A trie over page-sized chunks of raw prompt tokens: the node at
    depth j maps chunk j to the physical page holding its K/V.  Exact
    token tuples are the keys, so no collision can serve another prefix.
    Each node holds one allocator reference on its page; live rows pin
    nodes (``row_refs``).  Under page pressure, unpinned leaves evict in
    LRU order (leaves first keep every cached chain walkable)."""

    def __init__(self, allocator: PageAllocator, page_len: int):
        self.alloc = allocator
        self.page_len = page_len
        self._root: dict = {}
        self._nodes: List[_PrefixNode] = []
        self._clock = 0
        self.hits = 0       # pages served from the cache
        self.misses = 0     # lookup-eligible pages that had to prefill

    @property
    def cached_pages(self) -> int:
        return len(self._nodes)

    def page_ids(self) -> set:
        return {n.page for n in self._nodes}

    def lookup(self, tokens, cap: int) -> Tuple[List[_PrefixNode], List[int]]:
        """Walk the trie over ``tokens``' page-sized chunks, at most
        ``cap`` deep: (nodes, physical pages) of the longest cached
        prefix."""
        self._clock += 1
        nodes: List[_PrefixNode] = []
        pages: List[int] = []
        level = self._root
        i = 0
        p = self.page_len
        while len(nodes) < cap and i + p <= len(tokens):
            node = level.get(tuple(tokens[i:i + p]))
            if node is None:
                break
            node.last_use = self._clock
            nodes.append(node)
            pages.append(node.page)
            level = node.children
            i += p
        return nodes, pages

    def acquire(self, nodes):
        for n in nodes:
            n.row_refs += 1

    def release(self, nodes):
        for n in nodes:
            n.row_refs -= 1

    def insert(self, tokens, pages, parent_nodes, upto: int):
        """Insert chunks [len(parent_nodes), upto) of ``tokens``, whose
        physical pages are ``pages`` (the row's whole page table, shared
        prefix included).  Only fully-real prompt pages qualify (``upto =
        len // page_len``); the cache takes one allocator reference a new
        page."""
        level = self._root if not parent_nodes else parent_nodes[-1].children
        parent = parent_nodes[-1] if parent_nodes else None
        p = self.page_len
        self._clock += 1
        for j in range(len(parent_nodes), upto):
            chunk = tuple(tokens[j * p:(j + 1) * p])
            node = level.get(chunk)
            if node is None:
                node = _PrefixNode(pages[j], chunk, parent)
                node.last_use = self._clock
                self.alloc.retain([pages[j]])
                level[chunk] = node
                self._nodes.append(node)
            else:
                node.last_use = self._clock
            level = node.children
            parent = node

    def evict_for(self, needed: int):
        """Evict unpinned LRU leaves until the allocator can serve
        ``needed`` pages (best effort: pinned chains stay)."""
        while self.alloc.free_count < needed:
            victims = [n for n in self._nodes
                       if not n.children and n.row_refs == 0]
            if not victims:
                return
            v = min(victims, key=lambda n: n.last_use)
            parent_map = v.parent.children if v.parent else self._root
            del parent_map[v.chunk]
            self._nodes.remove(v)
            self.alloc.release([v.page])


# -- the scheduler ------------------------------------------------------------


class _PagedSlot(_Slot):
    """One lane's row under the paged engine: the base bookkeeping plus
    its page table, its own (releasable) pages and the prefix nodes it
    pins."""

    __slots__ = ("pages", "own_pages", "nodes")


class _PrefillState:
    """The admission in progress: one request's rows prefill chunk by
    chunk between decode quanta.  The request stays in the queue until
    this completes, so a loop crash reaches it through
    ``_fail_outstanding``."""

    __slots__ = ("req", "tokens", "positions", "lengths", "padded", "n",
                 "pages", "own_pages", "nodes", "shared", "cursor",
                 "last_logits", "pads", "read", "sampling")

    def __init__(self, req):
        self.req = req


class PagedDecodeScheduler(DecodeScheduler):
    """The ``DecodeScheduler`` over the paged pool.  The same surface
    (submit / stats / stop, the crash failover, admitted == evicted +
    active), other cache economics.  Knobs (constructor argument, else the
    environment; the integer ones raise on a bad value):

      page_len      KFT_SERVE_PAGE_LEN      tokens a page (default 64;
                                            must divide slot_len)
      num_pages     KFT_SERVE_PAGES         pages, the null page included
                                            (default: the fixed pool's
                                            capacity, slots x slot_len /
                                            page_len, + 1)
      prefill_chunk KFT_SERVE_PREFILL_CHUNK tokens a prefill pass (0: the
                                            whole suffix; default 512)
      spec_tokens   KFT_SERVE_SPEC_TOKENS   draft tokens a speculative
                                            step (default 4; with a draft)
      prefix_cache  KFT_SERVE_PREFIX_CACHE  prefix sharing on or off

    ``slots`` stays the width of a pool step (lanes); pages are the
    memory: a short row holds 2 pages where a long one holds 30, and the
    fixed pool gave both ``slot_len``.  The page table lives on the
    device in one tensor [slots, max_pages_row], refreshed in place from
    a pinned host buffer at each dispatch, so a quantum's tensors keep
    their shapes and addresses."""

    def __init__(self, model, *, slots: Optional[int] = None,
                 slot_len: Optional[int] = None,
                 quantum: Optional[int] = None,
                 pipeline: Optional[bool] = None, telemetry=None,
                 page_len: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 spec_tokens: Optional[int] = None, draft_model=None,
                 prefix_cache: Optional[bool] = None, mesh=None,
                 lockstep=None):
        if mesh is not None and draft_model is not None:
            # The draft pool mirrors the target's pages from host-built
            # slots; that mirroring is not mesh-aware (the reference's
            # rule).  models/serve.py records the fallback.
            raise ValueError(
                "speculative decoding under a mesh is not supported: drop "
                "the draft model or the mesh (serve.py falls back to the "
                "fixed-slot scheduler for this combination)")
        super().__init__(model, slots=slots, slot_len=slot_len,
                         quantum=quantum, pipeline=pipeline,
                         telemetry=telemetry, mesh=mesh, lockstep=lockstep)
        # The pool's position axis splits over the data axes (1 on a
        # mesh without one: the pool then replicates, tp splits heads).
        self.pool_shards = page_pool_shards(mesh)
        self.page_len = page_len or config.knob(
            "KFT_SERVE_PAGE_LEN", 64, int,
            doc="Paged-KV page size in tokens (models/paged.py); the "
                "serve slot length must be a multiple of it",
            validate=lambda v: None if 1 <= v <= 4096
            else "must be in [1, 4096]")
        if self.page_len < 1 or self.slot_len % self.page_len:
            raise ValueError(
                f"KFT_SERVE_PAGE_LEN {self.page_len} must be a positive "
                f"divisor of slot_len {self.slot_len} — a bad page size "
                f"must fail loudly, not quietly serve the fallback path")
        self.max_pages_row = self.slot_len // self.page_len
        self.num_pages = num_pages or config.knob(
            "KFT_SERVE_PAGES", 0, int,
            doc="Physical KV pages in the paged pool, null page "
                "included (0 = the fixed pool's capacity + 1)",
            validate=lambda v: None if v >= 0 else "must be >= 0",
        ) or self.slots * self.max_pages_row + 1
        if self.num_pages < self.max_pages_row + 1:
            raise ValueError(
                f"KFT_SERVE_PAGES {self.num_pages} cannot hold one "
                f"full-length row ({self.max_pages_row} pages) plus the "
                f"null page")
        if self.num_pages % self.pool_shards:
            # Round up: every shard then holds whole pages.
            self.num_pages += self.pool_shards - self.num_pages % \
                self.pool_shards
        self.pool_positions = self.num_pages * self.page_len
        self.prefill_chunk = prefill_chunk if prefill_chunk is not None \
            else config.knob(
                "KFT_SERVE_PREFILL_CHUNK", 512, int,
                doc="Chunked-prefill pass size in tokens (0 = whole "
                    "prompt suffix in one pass)",
                validate=lambda v: None if v >= 0 else "must be >= 0")
        self.spec_tokens = spec_tokens if spec_tokens is not None \
            else config.knob(
                "KFT_SERVE_SPEC_TOKENS", 4, int,
                doc="Draft tokens proposed per speculative-decoding "
                    "step (needs --draft-model; 0 disables)",
                validate=lambda v: None if 0 <= v <= 64
                else "must be in [0, 64]")
        if not 0 <= self.spec_tokens <= 64:
            raise ValueError(
                f"KFT_SERVE_SPEC_TOKENS {self.spec_tokens} outside [0, 64]")
        self.draft_model = draft_model
        if draft_model is not None:
            if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_model.cfg.vocab_size} != target "
                    f"vocab {model.cfg.vocab_size}: speculative proposals "
                    f"would index a different token space")
            if draft_model.cfg.max_seq_len < self.slot_len:
                raise ValueError(
                    f"draft max_seq_len {draft_model.cfg.max_seq_len} < "
                    f"slot_len {self.slot_len}")
        use_prefix = prefix_cache if prefix_cache is not None else \
            config.env_bool("KFT_SERVE_PREFIX_CACHE", True)
        self.allocator = PageAllocator(self.num_pages)
        self.prefix = (PrefixCache(self.allocator, self.page_len)
                       if use_prefix else None)
        self._lane_pages: List[List[int]] = [[] for _ in range(self.slots)]
        self._prefilling: Optional[_PrefillState] = None
        self._draft_pool: Optional[PagedKVCache] = None
        self._page_rows: Optional[torch.Tensor] = None    # on the device
        self._page_rows_host: Optional[torch.Tensor] = None
        self._table_copied = None   # event after the last table upload
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0
        self._spec_steps_total = 0
        self._chunks_total = 0
        self._draft_prefills_total = 0
        self._page_waits_total = 0

    # -- sizing -----------------------------------------------------------

    def _local_rows(self) -> tuple:
        # Lanes stay replicated: every process steps every lane.
        return 0, self.slots, 1

    def knobs(self) -> dict:
        return dict(super().knobs(), page_len=self.page_len,
                    num_pages=self.num_pages,
                    prefill_chunk=self.prefill_chunk,
                    spec_tokens=self.spec_tokens,
                    prefix_cache=self.prefix is not None)

    def _spec_slack(self) -> int:
        """Write slots a verify pass can touch past the last budgeted
        token, reserved so its reads never resolve to the null page."""
        if self.draft_model is None or self.spec_tokens < 1:
            return 0
        return self.spec_tokens + 1

    def _pages_per_row(self, padded: int, n: int) -> int:
        need = padded + n - 1 + self._spec_slack()
        return min(math.ceil(need / self.page_len), self.max_pages_row)

    def submit(self, rows, *, max_new_tokens, temperature=0.0, top_k=None,
               eos_token=None, seed=0, tokens=None, prompt_mask=None,
               priority=DEFAULT_PRIORITY, deadline=None):
        longest = max(len(r) for r in rows)
        if longest + max_new_tokens <= self.slot_len:
            # The worst case (no prefix reuse) must fit the pool, or the
            # admission would wait forever; past slot_len the base class
            # raises its own error.
            per_row = self._pages_per_row(longest, max_new_tokens)
            if per_row * len(rows) > self.num_pages - 1:
                raise ValueError(
                    f"request needs up to {per_row * len(rows)} KV pages "
                    f"({len(rows)} rows x {per_row}), pool has "
                    f"{self.num_pages - 1} usable (KFT_SERVE_PAGES)")
        return super().submit(
            rows, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, eos_token=eos_token, seed=seed, tokens=tokens,
            prompt_mask=prompt_mask, priority=priority, deadline=deadline)

    def stats(self) -> dict:
        out = super().stats()
        shared = self.prefix.cached_pages if self.prefix else 0
        out.update({
            "page_len": self.page_len,
            "pages_total": self.num_pages,
            "pages_free": self.allocator.free_count,
            "pages_shared": shared,
            "pages_active": self.allocator.allocated_count - shared,
            "prefix_hits": self.prefix.hits if self.prefix else 0,
            "prefix_misses": self.prefix.misses if self.prefix else 0,
            "spec_proposed": self._spec_proposed_total,
            "spec_accepted": self._spec_accepted_total,
            "pool_shards": self.pool_shards,
            "prefill_chunks_total": self._chunks_total,
            "spec_steps_total": self._spec_steps_total,
            "draft_prefills_total": self._draft_prefills_total,
            "page_waits_total": self._page_waits_total,
            "prefill_chunk": self.prefill_chunk,
            "spec_tokens": self.spec_tokens,
        })
        return out

    def debug_pages(self) -> dict:
        """Live page-table snapshot: two lanes' page sets may overlap only
        inside the shared (prefix-cache) pages."""
        shared = self.prefix.page_ids() if self.prefix else set()
        lanes = {i: list(pages) for i, pages in enumerate(self._lane_pages)
                 if self._slot_state[i] is not None}
        return {"shared": shared, "lanes": lanes}

    # -- pool -------------------------------------------------------------

    def _ensure_pool(self):
        if self._pool is not None:
            return
        dev = self.model.device
        groups = data_groups(self.mesh)
        self._pool = self.model.new_paged_cache(
            self.pool_positions, groups=groups,
            shard=(page_pool_spec(self.mesh, self.pool_positions)
                   if groups else None))
        self._pad_rows = torch.full((self.slots, self.slot_len), NEG_INF,
                                    dtype=torch.float32, device=dev)
        self._spare = torch.Generator(device=dev).manual_seed(0)
        self._gens = [self._spare] * self.slots
        self._page_rows = torch.zeros(self.slots, self.max_pages_row,
                                      dtype=torch.long, device=dev)
        self._page_rows_host = torch.zeros(
            self.slots, self.max_pages_row, dtype=torch.long,
            pin_memory=dev.type == "cuda")
        if self._spec_slack():
            if self.draft_model.device != dev:
                raise ValueError(f"draft model on {self.draft_model.device}, "
                                 f"target on {dev}")
            self._draft_pool = self.draft_model.new_paged_cache(
                self.pool_positions)
        tel = self._telemetry()
        if tel is not None:
            tel.page_pool_shards.set(self.pool_shards)
        self._update_page_metrics()

    def _refresh_page_rows(self) -> torch.Tensor:
        """The device page table, rewritten in place from the lanes'
        pages.  The pinned host buffer is refilled only once its last
        upload has run (at most one quantum back, already harvested)."""
        if self._table_copied is not None:
            self._table_copied.synchronize()
        host = self._page_rows_host
        host.zero_()
        for i, pages in enumerate(self._lane_pages):
            if pages:
                host[i, :len(pages)] = torch.tensor(pages)
        self._page_rows.copy_(host, non_blocking=True)
        if self._page_rows.is_cuda:
            self._table_copied = torch.cuda.Event()
            self._table_copied.record()
        return self._page_rows

    def _update_page_metrics(self):
        tel = self._telemetry()
        if tel is None:
            return
        shared = self.prefix.cached_pages if self.prefix else 0
        active = self.allocator.allocated_count - shared
        tel.kv_pages.labels(state="free").set(self.allocator.free_count)
        tel.kv_pages.labels(state="active").set(active)
        tel.kv_pages.labels(state="shared").set(shared)
        # Fragmentation: capacity live rows reserve but have not written.
        # Written positions a lane: its write pointer (clamped to its
        # reservation); the prefill in progress counts its cursor.
        reserved = written = 0
        for i, slot in enumerate(self._slot_state):
            if slot is None:
                continue
            cap = len(self._lane_pages[i]) * self.page_len
            reserved += cap
            written += min(slot.write, cap)
        for slot in self._pending_rows:
            cap = len(slot.pages) * self.page_len
            reserved += cap
            written += min(slot.write, cap)
        st = self._prefilling
        if st is not None:
            reserved += len(st.pages[0]) * self.page_len * len(st.req.rows)
            written += st.cursor * len(st.req.rows)
        tel.kv_page_fragmentation.set(
            1.0 - written / reserved if reserved else 0.0)

    # -- admission --------------------------------------------------------

    def _admit(self):
        """Place prefilled rows, then advance the ONE prefill in progress
        by a single chunk, then (when none is) start the next queued
        request.  Returning with ``_prefilling`` set hands the device back
        to ``_run_quantum``: that is the chunk/decode interleave."""
        while True:
            free = self._free_slots()
            while free and self._pending_rows:
                self._place(self._pending_rows[0], free.pop(0))
                self._pending_rows.pop(0)
            st = self._prefilling
            if st is not None:
                try:
                    self._advance_prefill(st)
                except Exception as exc:  # noqa: BLE001 — per request
                    if self.lockstep is not None:
                        raise   # the processes may have diverged
                    self._abort_prefill(st, exc)
                    continue
                if self._prefilling is not None:
                    return          # mid-prefill: give decode a quantum
                continue            # finished: loop to place its rows
            if self._pending_rows:
                return              # rows wait for lanes: keep decoding
            req = self._next_queued(pop=False)
            if req is None:
                return
            try:
                started = self._begin_prefill(req)
            except Exception as exc:  # noqa: BLE001 — per request
                if self.lockstep is not None:
                    raise
                self._drop_queued(req)
                req._fail(exc)
                tel = self._telemetry()
                if tel is not None:
                    tel.queue_depth.dec(len(req.rows))
                continue
            if not started:
                self._page_waits_total += 1
                return              # pages short: decode frees them

    def _drop_queued(self, req: PendingRequest):
        with self._cond:
            if req in self._queue:
                self._queue.remove(req)

    def _release_prefill(self, st: _PrefillState):
        for own in st.own_pages:
            self.allocator.release(own)
        if self.prefix is not None:
            for nodes in st.nodes:
                self.prefix.release(nodes)

    def _abort_prefill(self, st: _PrefillState, exc: BaseException):
        self._prefilling = None
        self._release_prefill(st)
        self._drop_queued(st.req)
        st.req._fail(exc)
        tel = self._telemetry()
        if tel is not None:
            tel.queue_depth.dec(len(st.req.rows))
        self._update_page_metrics()

    def _begin_prefill(self, req: PendingRequest) -> bool:
        """Admission's host side: prefix lookup, page allocation, the
        chunk cursor.  False (the request stays queued) when the pages
        are short even after LRU prefix eviction: decode quanta go on and
        free pages."""
        rows = req.rows
        b = len(rows)
        n = req.max_new_tokens
        padded = max(len(r) for r in rows)
        p = self.page_len
        if self.prefix is not None:
            caps = [(len(r) - 1) // p for r in rows]
            looked = [self.prefix.lookup(r, cap)
                      for r, cap in zip(rows, caps)]
            # One shared depth for all of the request's rows keeps the
            # chunk rectangular; the cap leaves at least one suffix token
            # to give the first token's logits.
            m = min(len(nodes) for nodes, _ in looked)
        else:
            caps = [0] * b
            looked = [([], [])] * b
            m = 0
        own_count = self._pages_per_row(padded, n) - m
        need = own_count * b
        hit_nodes = [nodes[:m] for nodes, _ in looked]
        if self.prefix is not None:
            # Pin the hit before making room: an unpinned matched leaf
            # could be evicted and handed straight back by alloc as one
            # of this request's own pages, overwriting its prefix.
            for nodes in hit_nodes:
                self.prefix.acquire(nodes)
            self.prefix.evict_for(need)
        flat = self.allocator.alloc(need)
        if flat is None:
            if self.prefix is not None:
                for nodes in hit_nodes:
                    self.prefix.release(nodes)
            return False
        st = _PrefillState(req)
        st.shared = m
        st.own_pages = [flat[i * own_count:(i + 1) * own_count]
                        for i in range(b)]
        st.nodes = hit_nodes
        st.pages = [list(pages[:m]) + st.own_pages[i]
                    for i, (_, pages) in enumerate(looked)]
        if self.prefix is not None:
            hit = m * b
            miss = sum(max(cap - m, 0) for cap in caps)
            self.prefix.hits += hit
            self.prefix.misses += miss
            tel = self._telemetry()
            if tel is not None:
                if hit:
                    tel.prefix_cache_hits.inc(hit)
                if miss:
                    tel.prefix_cache_misses.inc(miss)
        try:
            self._prefill_inputs(st)
        except BaseException:
            self._release_prefill(st)
            raise
        req.t_admitted = time.perf_counter()
        req.admitted.set()
        self._prefilling = st
        self._update_page_metrics()
        return True

    def _prefill_inputs(self, st: _PrefillState):
        """The admission's tensors on the device: prompt, positions,
        lengths, pad rows, read indices, sampling rows, the logits
        accumulator."""
        req = st.req
        rows = req.rows
        b = len(rows)
        padded = max(len(r) for r in rows)
        p = self.page_len
        dev = self.model.device
        if req.tokens is not None:
            prompt, mask = req.tokens, req.prompt_mask.bool()
        else:
            prompt = torch.tensor(
                [r + [0] * (padded - len(r)) for r in rows], device=dev)
            mask = torch.tensor(
                [[True] * len(r) + [False] * (padded - len(r))
                 for r in rows], device=dev)
        st.padded, st.n, st.cursor = padded, req.max_new_tokens, st.shared * p
        st.tokens = prompt
        st.positions, st.lengths = prompt_positions(mask)
        st.pads = pad_bias_rows(mask, self.slot_len)
        table = torch.tensor(
            [pages + [0] * (self.max_pages_row - len(pages))
             for pages in st.pages], dtype=torch.long, device=dev)
        st.read = read_indices(table, p)
        st.sampling = SamplingRows.make(b, dev, req.temperature, req.top_k,
                                        req.eos_token)
        st.last_logits = torch.zeros(b, self.model.cfg.vocab_size,
                                     dtype=torch.float32, device=dev)

    def _advance_prefill(self, st: _PrefillState):
        """One prefill chunk on the device; after the last, the first
        token and the rows' hand-over (``_finish_prefill``)."""
        c = st.padded - st.cursor
        if self.prefill_chunk > 0:
            c = min(c, self.prefill_chunk)
        sl = slice(st.cursor, st.cursor + c)
        st.last_logits = prefill_chunk(
            self.model, self._pool, st.tokens[:, sl], st.positions[:, sl],
            st.read, st.cursor, st.lengths, st.last_logits)
        self._chunks_total += 1
        st.cursor += c
        if st.cursor < st.padded:
            return
        self._finish_prefill(st)

    def _finish_prefill(self, st: _PrefillState):
        """The first token (the lock path's generator recipe), the draft's
        prefill into the same pages of its pool, the prefix insert, and
        each row into the pending list, or complete at admission."""
        req = st.req
        b = len(req.rows)
        p = self.page_len
        gens = row_generators(req.seed, b, self.model.device)
        first, done0 = sample_first(st.last_logits, st.sampling, gens)
        if self._draft_pool is not None:
            # One pass over the whole suffix fills the draft's pool at the
            # same positions, so its future steps see the whole history.
            sl = slice(st.shared * p, st.padded)
            prefill_chunk(self.draft_model, self._draft_pool,
                          st.tokens[:, sl], st.positions[:, sl], st.read,
                          st.shared * p, st.lengths, st.last_logits)
            self._draft_prefills_total += 1
        first_h, done_h, lengths_h = torch.stack(
            [first, done0.long(), st.lengths]).tolist()
        req.t_first = time.perf_counter()
        req.first_token.set()
        if self.prefix is not None:
            for i, r in enumerate(req.rows):
                self.prefix.insert(r, st.pages[i], st.nodes[i], len(r) // p)
        self._prefilling = None
        self._drop_queued(req)
        self._prefills_total += 1
        tel = self._telemetry()
        n = st.n
        eos = req.eos_token
        for i in range(b):
            if n == 1 or done_h[i]:
                # Complete at admission: counted admitted and evicted at
                # once; its pages go back now (the prefix-inserted ones
                # live on under the cache's own references).
                self._admitted_total += 1
                self._evicted_total += 1
                self.allocator.release(st.own_pages[i])
                if self.prefix is not None:
                    self.prefix.release(st.nodes[i])
                if tel is not None:
                    tel.queue_depth.dec(1)
                    tel.scheduler_admitted.inc()
                    tel.scheduler_evicted.inc()
                self._complete_row(req, i, [first_h[i]] + [eos] * (n - 1))
                continue
            slot = _PagedSlot(req, i, token=first_h[i], pos=lengths_h[i],
                              write=st.padded, done=False, budget=n - 1)
            slot.pages = st.pages[i]
            slot.own_pages = st.own_pages[i]
            slot.nodes = st.nodes[i]
            slot._generator = gens[i]
            slot._pad_row = st.pads[i]
            self._pending_rows.append(slot)
        self._update_page_metrics()

    def _place(self, slot: _PagedSlot, idx: int):
        """A row into lane ``idx`` without a cache copy: its K/V already
        live in the pool, so only its page-table row, its generator and
        its pad row move in."""
        self._lane_pages[idx] = slot.pages
        self._pad_rows[idx].copy_(slot._pad_row)
        self._gens[idx] = slot._generator
        self._admitted_total += 1
        tel = self._telemetry()
        if tel is not None:
            tel.queue_depth.dec(1)
            tel.scheduler_admitted.inc()
            tel.slots_active.set(
                1 + sum(s is not None for s in self._slot_state))
        del slot._generator, slot._pad_row
        self._slot_state[idx] = slot
        self._carry = None
        self._update_page_metrics()

    # -- decode -----------------------------------------------------------

    def _spec_ready(self) -> bool:
        """A speculative step needs the draft's pool, every live row
        greedy (the acceptance is exact only against argmax) and k + 1
        slots of headroom on every row."""
        if self._draft_pool is None:
            return False
        k = self.spec_tokens
        live = [s for s in self._slot_state if s is not None]
        return bool(live) and all(
            s.temp == 0.0 and s.write + k + 1 <= self.slot_len for s in live)

    def _pre_dispatch_sync(self) -> bool:
        """On top of the base rule: with a draft attached the pending
        harvest always lands first (the spec decision and step read the
        host's pointers), then a speculative step runs when every live
        row can take one."""
        if self._carry is None or self._draft_pool is not None:
            self._harvest()
        if self._spec_ready():
            self._run_spec_step()
            return True
        return not any(s is not None for s in self._slot_state)

    def _pool_steps(self, dstate, rows, write):
        # The table is refreshed at every dispatch: an eviction zeroed its
        # lane's row, sending that lane's writes to the null page.  A
        # quantum still in flight was enqueued with the table before it:
        # its vacated lane writes the pages its row released, and a new
        # owner of those pages prefills after it on the stream.
        page_rows = self._refresh_page_rows()
        return paged_pool_steps(self.model, dstate, rows, write, page_rows,
                                page_len=self.page_len, quantum=self.quantum)

    def _harvest_handle(self, h):
        super()._harvest_handle(h)
        self._update_page_metrics()

    def _run_spec_step(self):
        """One speculative round: the draft proposes, one target pass
        verifies, the host emits each row's accepted prefix and the token
        after it.  Both pools' pointers advance by accepted + 1; the
        rejected tail needs no rollback (masked above the pointer until
        overwritten)."""
        state = self._slot_state
        k = self.spec_tokens
        dev = self.model.device
        t = lambda vals: torch.tensor(vals, dtype=torch.long, device=dev)
        token = t([s.token if s else 0 for s in state])
        pos = t([s.pos if s else 0 for s in state])
        write = t([s.write if s else 0 for s in state])
        page_rows = self._refresh_page_rows()
        drafts = draft_propose(self.draft_model, self._draft_pool, token, pos,
                               write, self._pad_rows, page_rows, k=k,
                               page_len=self.page_len)
        greedy, accepted = spec_verify(self.model, self._pool, token, drafts,
                                       pos, write, self._pad_rows, page_rows,
                                       page_len=self.page_len)
        out = torch.cat([greedy, accepted[:, None]], dim=1).tolist()
        self._steps_total += 1
        self._spec_steps_total += 1
        tel = self._telemetry()
        if tel is not None:
            active = sum(s is not None for s in state)
            tel.batch_fill_ratio.observe(active / self.slots)
        proposed = accepted_n = 0
        for i, slot in enumerate(state):
            if slot is None:
                continue
            a = out[i][k + 1]
            proposed += k
            accepted_n += a
            for j in range(a + 1):
                if len(slot.collected) >= slot.budget:
                    break
                tok = out[i][j]
                slot.collected.append(tok)
                if slot.has_eos and tok == slot.eos:
                    # EOS ends the row; eviction pads with EOS.
                    slot.done = True
                    break
            slot.token = out[i][a]
            slot.pos += a + 1
            slot.write += a + 1
            if slot.done or len(slot.collected) >= slot.budget:
                self._evict(i)
        self._spec_proposed_total += proposed
        self._spec_accepted_total += accepted_n
        if tel is not None:
            if proposed:
                tel.spec_proposed.inc(proposed)
            if accepted_n:
                tel.spec_accepted.inc(accepted_n)
        # The host moved the pointers: the next quantum rebuilds its carry.
        self._carry = None
        self._update_page_metrics()

    def _evict(self, idx: int):
        slot = self._slot_state[idx]
        super()._evict(idx)
        # The lane's table row goes to zeros (the null page) before its
        # pages can be allocated again.
        self._lane_pages[idx] = []
        self.allocator.release(slot.own_pages)
        if self.prefix is not None:
            self.prefix.release(slot.nodes)
        self._update_page_metrics()

    def _fail_outstanding(self, exc: BaseException):
        st = self._prefilling
        self._prefilling = None
        super()._fail_outstanding(exc)
        # The prefill in progress still held its request in the queue, so
        # the base drain failed it; its pages are released so a dead
        # scheduler's stats still balance.
        if st is not None:
            self._release_prefill(st)
        self._lane_pages = [[] for _ in range(self.slots)]
        self._update_page_metrics()
