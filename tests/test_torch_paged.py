"""The PyTorch port's paged engine (kubeflow_tpu_torch.models.paged) against
the JAX reference's (kubeflow_tpu.models.paged) and the port's own lock
path and fixed-slot pool, on the CPU at llama_debug size.

The contract, as the reference states it: a request generates the tokens
it generates alone on the lock path, whatever shares the pool, whatever
the prefix cache serves, however its prompt is chunked, and with or
without a draft model (greedy; seeded sampling draws from the row's own
torch generator, so seeded requests are held against the port's lock
path).  The host structures (page allocator, prefix trie) run the same
operations as the reference's and must give the same pages, refcounts,
hits, misses and evictions.  Tolerances are stated where a test compares
numbers: f32 logits and cache contents against another route of the
port's within 1e-5, against the reference within 1e-4.
"""
import dataclasses
import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import paged as jax_paged
from kubeflow_tpu.models.generate import generate as jax_generate
from kubeflow_tpu.models.layers import PagedSlots as JaxPagedSlots
from kubeflow_tpu.models.llama import CONFIGS as JAX_CONFIGS
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models import paged
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.generate import (
    generate,
    pad_bias_rows,
    prompt_positions,
    row_generators,
)
from kubeflow_tpu_torch.models.layers import PagedSlots, verify_attention
from kubeflow_tpu_torch.models.paged import (
    PageAllocator,
    PagedDecodeScheduler,
    PrefixCache,
)
from kubeflow_tpu_torch.models.scheduler import (
    PRIORITY_CLASSES,
    DeadlineExceeded,
    DecodeScheduler,
)
from kubeflow_tpu_torch.models.serve import (
    GenerationService,
    create_app,
    load_service,
)

MAX_SEQ = 64
ROWS = [[5, 6, 7, 8, 9], [1, 2, 3], [4, 4, 4, 4, 4, 4, 4, 4, 4]]


@pytest.fixture(scope="module")
def jax_model_and_params():
    cfg = dataclasses.replace(JAX_CONFIGS["llama_debug"], max_seq_len=MAX_SEQ)
    model = JaxLlama(cfg)
    params = model.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))[
        "params"]
    return model, params


@pytest.fixture(scope="module")
def model(jax_model_and_params):
    """The port's llama_debug (f32) with the reference's parameters."""
    _, params = jax_model_and_params
    m = create_model("llama_debug", device="cpu", max_seq_len=MAX_SEQ)
    m.load_state_dict(params_from_jax(jax.device_get(params), m.cfg))
    return m.eval()


@pytest.fixture(scope="module")
def other_draft():
    """A draft that disagrees with the target: the same shape, its own
    random weights (seed 1)."""
    m = create_model("llama_debug", device="cpu", max_seq_len=MAX_SEQ)
    m.reset_parameters(torch.Generator().manual_seed(1))
    return m.eval()


def _padded(rows):
    longest = max(len(r) for r in rows)
    prompt = torch.tensor([r + [0] * (longest - len(r)) for r in rows])
    mask = torch.tensor([[True] * len(r) + [False] * (longest - len(r))
                         for r in rows])
    return prompt, mask


def sequential(model, rows, *, seed=0, **kw):
    """The per-request reference: the lock path's ``generate`` call."""
    prompt, mask = _padded(rows)
    return generate(model, prompt, prompt_mask=mask,
                    generators=row_generators(seed, len(rows), "cpu"),
                    **kw).tolist()


def _paged(model, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("slot_len", 64)
    kw.setdefault("quantum", 4)
    kw.setdefault("page_len", 16)
    kw.setdefault("prefill_chunk", 16)
    return PagedDecodeScheduler(model, **kw)


def _pages_balanced(stats):
    """The drained pool: nothing active, and every page but the null one
    free or in the prefix cache."""
    assert stats["pages_active"] == 0, stats
    assert (stats["pages_free"] + stats["pages_shared"]
            == stats["pages_total"] - 1), stats


def run_concurrently(sched, reqs):
    outs = {}

    def client(i, rows, kw):
        outs[i] = sched.submit(rows, **kw).result()

    threads = [threading.Thread(target=client, args=(i, r, kw))
               for i, (r, kw) in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return [outs[i] for i in range(len(reqs))]


# -- the host structures, trace for trace ------------------------------------


def _drive(allocator_cls, cache_cls, seed, page_len=4, total=24):
    """A seeded random life of a pool: admissions that look a prompt up,
    evict for their pages, allocate, pin and insert; completions that
    release; bare retain/release.  Prompts draw from a few shared
    prefixes so the trie branches and hits.  Returns the trace of every
    result and of the state after every operation."""
    rs = np.random.RandomState(seed)
    alloc = allocator_cls(total)
    cache = cache_cls(alloc, page_len)
    families = [rs.randint(0, 50, size=4 * page_len).tolist()
                for _ in range(3)]
    live, extra, trace = [], [], []
    for _ in range(150):
        op = rs.randint(5)
        if op <= 1 or not live:
            fam = families[rs.randint(len(families))]
            toks = fam[:rs.randint(1, len(fam) + 1)] + rs.randint(
                0, 50, size=rs.randint(0, 2 * page_len)).tolist()
            if not toks:
                continue
            cap = (len(toks) - 1) // page_len
            nodes, pages = cache.lookup(toks, cap)
            need = rs.randint(1, 5)
            cache.evict_for(need)
            own = alloc.alloc(need)
            trace.append(("admit", list(pages), own))
            if own is None:
                continue
            cache.acquire(nodes)
            cache.hits += len(nodes)
            cache.misses += max(cap - len(nodes), 0)
            full = list(pages) + own
            cache.insert(toks, full, nodes,
                         min(len(toks) // page_len, len(full)))
            live.append((nodes, own))
        elif op == 2:
            nodes, own = live.pop(rs.randint(len(live)))
            alloc.release(own)
            cache.release(nodes)
            trace.append(("done", own))
        elif op == 3:
            nodes, own = live[rs.randint(len(live))]
            alloc.retain(own)
            extra.append(own)
            trace.append(("retain", own))
        elif extra:
            own = extra.pop(rs.randint(len(extra)))
            alloc.release(own)
            trace.append(("release", own))
        trace.append((alloc.free_count, alloc.allocated_count,
                      cache.cached_pages, cache.hits, cache.misses,
                      sorted(cache.page_ids()), sorted(alloc._refs.items())))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_and_prefix_cache_traces_equal_the_reference(seed):
    want = _drive(jax_paged.PageAllocator, jax_paged.PrefixCache, seed)
    got = _drive(PageAllocator, PrefixCache, seed)
    assert got == want
    assert any(t[0] == "admit" and t[1] for t in got)      # hits happened
    assert any(t[0] == "admit" and t[2] is None for t in got)  # pressure
    with pytest.raises(ValueError, match="null"):
        PageAllocator(1)


# -- the model's paged modes against the reference's -------------------------


def _pool_and_tables(cfg, rs, b, pages_per_row, page_len, num_pages):
    """A random pool (both packages' layouts) and page tables of distinct
    pages, page 0 left as the null page."""
    pool = num_pages * page_len
    ks = rs.randn(cfg.n_layers, pool, cfg.n_kv_heads, cfg.head_dim)
    vs = rs.randn(cfg.n_layers, pool, cfg.n_kv_heads, cfg.head_dim)
    ids = 1 + rs.permutation(num_pages - 1)[:b * pages_per_row]
    table = ids.reshape(b, pages_per_row)
    return ks.astype(np.float32), vs.astype(np.float32), table


def _jax_cache(cfg, ks, vs):
    return {f"layer_{i}": {"attn": {"paged_key": jnp.asarray(ks[i]),
                                    "paged_value": jnp.asarray(vs[i])}}
            for i in range(cfg.n_layers)}


def _torch_cache(model, ks, vs):
    cache = model.new_paged_cache(ks.shape[1])
    for i in range(len(cache.k)):
        cache.k[i].copy_(torch.from_numpy(ks[i]))
        cache.v[i].copy_(torch.from_numpy(vs[i]))
    return cache


def _assert_pools_close(cache, jstate, n_layers, tol, skip=()):
    """Every pool position but ``skip`` (pad slots, whose K/V past the
    first layer depend on what a pad query sees, hidden from every valid
    query on both sides) within ``tol``."""
    keep = np.ones(cache.pool_positions, bool)
    keep[list(skip)] = False
    for i in range(n_layers):
        attn = jstate["cache"][f"layer_{i}"]["attn"]
        np.testing.assert_allclose(cache.k[i].numpy()[keep],
                                   np.asarray(attn["paged_key"])[keep],
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(cache.v[i].numpy()[keep],
                                   np.asarray(attn["paged_value"])[keep],
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("chunk", [5, 8, 0])
def test_chunked_prefill_logits_match_one_pass_and_the_reference(
        jax_model_and_params, model, chunk):
    """A right-padded 2-row prompt (23 and 17 tokens) prefilled in chunks
    over scattered pages: the last valid token's logits equal a one-pass
    prefill's within 1e-5 and the reference's ``_prefill_chunk`` within
    1e-4, and the pool holds the reference's K/V within 1e-4 (but at the
    short row's pad slots)."""
    jm, params = jax_model_and_params
    cfg = model.cfg
    rs = np.random.RandomState(7)
    page_len, L, num_pages = 8, 32, 12
    rows = [rs.randint(0, cfg.vocab_size, size=n).tolist() for n in (23, 17)]
    prompt, mask = _padded(rows)
    b, padded = prompt.shape
    ks, vs, table = _pool_and_tables(cfg, rs, b, L // page_len, page_len,
                                     num_pages)
    read = paged.read_indices(torch.from_numpy(table).long(), page_len)
    positions, lengths = prompt_positions(mask)
    pads = pad_bias_rows(mask, L)
    cache = _torch_cache(model, ks, vs)
    jcache = _jax_cache(cfg, ks, vs)
    step = chunk or padded
    got = torch.zeros(b, cfg.vocab_size)
    jlast = jnp.zeros((b, cfg.vocab_size), jnp.float32)
    with torch.inference_mode():
        for start in range(0, padded, step):
            sl = slice(start, start + step)
            got = paged.prefill_chunk(model, cache, prompt[:, sl],
                                      positions[:, sl], read, start,
                                      lengths, got)
            c = prompt[:, sl].shape[1]
            ps = JaxPagedSlots(
                write=jnp.asarray(read[:, start:start + c].numpy(),
                                  jnp.int32),
                read=jnp.asarray(read.numpy(), jnp.int32),
                pool_positions=num_pages * page_len)
            jcache, jlast = jax_paged._prefill_chunk(
                jm, jcache, params, jnp.asarray(prompt[:, sl].numpy()),
                jnp.asarray(positions[:, sl].numpy()), ps, jnp.int32(start),
                jnp.asarray(pads.numpy()), jnp.asarray(lengths.numpy()),
                jlast)
        one_pass = model(prompt, positions=positions,
                         cache=model.new_cache(b, L), pad_bias=pads,
                         logits_at=lengths - 1)
    np.testing.assert_allclose(got.numpy(), one_pass.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlast), atol=1e-4,
                               rtol=1e-4)
    pad_slots = read[1, len(rows[1]):padded].tolist()
    _assert_pools_close(cache, {"cache": jcache}, cfg.n_layers, 1e-4,
                        skip=pad_slots)


@pytest.mark.parametrize("s", [1, 4])
def test_paged_step_matches_the_reference_paged_mode(
        jax_model_and_params, model, s):
    """One paged step with rows at different depths, s = 1 (decode: K5's
    route) and s = 4 (a verify pass: ``verify_attention``), writes
    through the page table, reads the gathered view, hides the null page
    and the pad slots: logits and the written pool equal the reference's
    ``PagedSlots`` mode within 1e-5."""
    jm, params = jax_model_and_params
    cfg = model.cfg
    rs = np.random.RandomState(11 + s)
    b, page_len, L, num_pages = 3, 4, 16, 14
    ks, vs, table = _pool_and_tables(cfg, rs, b, L // page_len, page_len,
                                     num_pages)
    table[2, 3] = 0                   # an unallocated page: the null page
    write0 = np.array([0, 6, 9])
    slots = np.minimum(write0[:, None] + np.arange(s)[None], L - 1)
    flat_w = table[np.arange(b)[:, None], slots // page_len] * page_len \
        + slots % page_len
    read = paged.read_indices(torch.from_numpy(table).long(), page_len)
    tokens = rs.randint(0, cfg.vocab_size, size=(b, s))
    pos = np.array([0, 4, 9])[:, None] + np.arange(s)[None]
    pad = np.zeros((b, L), np.float32)
    pad[1, 2:4] = -1e30                # a prompt's padding slots
    allowed = np.arange(L)[None, None, :] <= slots[:, :, None]
    bias = np.where(allowed, 0.0, -1e30).astype(np.float32) + pad[:, None]
    ps = JaxPagedSlots(write=jnp.asarray(flat_w, jnp.int32),
                       read=jnp.asarray(read.numpy(), jnp.int32),
                       pool_positions=num_pages * page_len)
    want, jstate = jm.apply(
        {"params": params, "cache": _jax_cache(cfg, ks, vs)},
        jnp.asarray(tokens), positions=jnp.asarray(pos), decode=True,
        mask_bias=jnp.asarray(bias)[:, None], cache_len=L, cache_slots=ps,
        mutable=["cache"])
    cache = _torch_cache(model, ks, vs)
    calls = verify_attention.calls
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens).long(),
                    positions=torch.from_numpy(pos).long(), cache=cache,
                    pad_bias=torch.from_numpy(pad),
                    cache_slots=PagedSlots(
                        write=torch.from_numpy(flat_w).long(), read=read,
                        slots=torch.from_numpy(slots).long(),
                        pool_positions=num_pages * page_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    _assert_pools_close(cache, jstate, cfg.n_layers, 1e-5)
    assert verify_attention.calls - calls == (cfg.n_layers if s > 1 else 0)
    with pytest.raises(ValueError, match="together"):
        model(torch.from_numpy(tokens).long(), cache=model.new_cache(b, L),
              cache_slots=PagedSlots(torch.zeros(b, s, dtype=torch.long),
                                     read, None, num_pages * page_len))


# -- the engine's token contract ----------------------------------------------


def test_paged_greedy_matrix_token_equal(model, jax_model_and_params):
    """paged == the reference's paged engine == the fixed pool == the
    lock path, for a mixed-length greedy request whose rows span page
    boundaries (12 new tokens over 16-token pages)."""
    jm, params = jax_model_and_params
    ref = sequential(model, ROWS, max_new_tokens=12)
    want = jax_paged.PagedDecodeScheduler(
        jm, params, slots=4, slot_len=64, quantum=4, page_len=16,
        prefill_chunk=16).submit(ROWS, max_new_tokens=12).result()
    assert want == ref
    fixed = DecodeScheduler(model, slots=4, slot_len=64, quantum=4)
    assert fixed.submit(ROWS, max_new_tokens=12).result() == ref
    sched = _paged(model)
    assert sched.submit(ROWS, max_new_tokens=12).result() == ref
    _pages_balanced(sched.stats())
    assert sched.stats()["prefill_chunks_total"] == 1


def test_paged_seeded_topk_equals_the_lock_path(model):
    kw = dict(max_new_tokens=12, temperature=0.8, top_k=5, seed=7)
    sched = _paged(model, prefill_chunk=4)
    assert sched.submit(ROWS, **kw).result() == sequential(model, ROWS, **kw)
    assert sched.stats()["prefill_chunks_total"] == 3


def test_paged_shared_prefix_cow_divergence(model):
    """Rows sharing a prompt prefix map to the same pages and still
    diverge after it; the sharing is across requests: the first fills
    the cache (misses only), a follow-up hits it."""
    sys_prompt = [9, 8, 7, 6, 5, 4, 3, 2, 1] * 4        # 36 tokens
    chats = [sys_prompt + [10 + i] for i in range(3)]
    sched = _paged(model)
    assert sched.submit(chats, max_new_tokens=8).result() == sequential(
        model, chats, max_new_tokens=8)
    st = sched.stats()
    assert st["pages_shared"] > 0 and st["prefix_hits"] == 0
    assert st["prefix_misses"] > 0
    tail = [sys_prompt + [50]]
    assert sched.submit(tail, max_new_tokens=8).result() == sequential(
        model, tail, max_new_tokens=8)
    st2 = sched.stats()
    assert st2["prefix_hits"] == 2                      # 2 pages of 16
    _pages_balanced(st2)
    snap = sched.debug_pages()
    assert snap["lanes"] == {} and snap["shared"]


def test_prefix_hit_equals_the_cache_off(model):
    """A request served from cached prefix pages equals the same request
    on an engine with the prefix cache off."""
    base = [(i * 13 + 5) % 250 for i in range(40)]
    first, again = [base + [1, 2]], [base + [3, 4, 5], base + [6]]
    on = _paged(model, page_len=8)
    off = _paged(model, page_len=8, prefix_cache=False)
    for sched in (on, off):
        sched.submit(first, max_new_tokens=6).result()
    got = on.submit(again, max_new_tokens=9).result()
    assert on.stats()["prefix_hits"] == 2 * 5            # 5 pages a row
    assert got == off.submit(again, max_new_tokens=9).result()
    assert got == sequential(model, again, max_new_tokens=9)
    assert off.stats()["prefix_hits"] == off.stats()["pages_shared"] == 0
    _pages_balanced(on.stats())
    _pages_balanced(off.stats())


def _interleave_reqs(model):
    long_prompt = [(i * 7 + 3) % 250 + 1 for i in range(40)]   # 5 chunks
    eos = sequential(model, [[5, 9, 2, 7]], max_new_tokens=10)[0][4]
    return [
        ([long_prompt], dict(max_new_tokens=12)),
        ([[5, 9, 2, 7]], dict(max_new_tokens=10, eos_token=eos)),
        ([[1, 2, 3]], dict(max_new_tokens=12)),
        ([[4, 4]], dict(max_new_tokens=6, temperature=0.5, top_k=4,
                        seed=3)),
        ([[9, 7, 5]], dict(max_new_tokens=4, eos_token=eos)),
        ([long_prompt[:23]], dict(max_new_tokens=8)),
    ]


def test_chunked_prefill_interleaves_with_eviction(model):
    """A long prompt prefills in page-sized chunks between decode quanta
    while short requests end (EOS and budget) and refill freed lanes: 2
    lanes, 6 requests at once, every output token-equal, the pool drains
    balanced."""
    sched = _paged(model, slots=2, quantum=2, page_len=8, prefill_chunk=8)
    reqs = _interleave_reqs(model)
    for (rows, kw), out in zip(reqs, run_concurrently(sched, reqs)):
        assert out == sequential(model, rows, **kw), (rows, kw)
    st = sched.stats()
    assert st["admitted_total"] == st["evicted_total"] == 6
    assert st["prefill_chunks_total"] >= 5 + 3
    _pages_balanced(st)


def test_page_pressure_waits_for_evictions(model):
    """A pool of 7 usable pages: requests whose pages are short wait in
    the queue while decode frees pages, then run; every output
    token-equal, the pool drains balanced."""
    sched = _paged(model, slots=4, slot_len=32, page_len=8, num_pages=8)
    reqs = [([[(i * 11 + j) % 200 + 1 for j in range(6 + 2 * i)]],
             dict(max_new_tokens=12)) for i in range(5)]
    for (rows, kw), out in zip(reqs, run_concurrently(sched, reqs)):
        assert out == sequential(model, rows, **kw)
    _pages_balanced(sched.stats())


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_page_pressure_keeps_a_prefix_hit_pinned(model, prefix_cache):
    """Page pressure with a prefix hit: the hit's chain is the only
    evictable leaf when the request admits, so making room must not evict
    (and hand back as an own page) a page the request reads as its
    prefix.  7 usable pages: a 17-token prompt caches 2; a long request
    holds 4 pages while a second prompt with the same 16-token prefix
    needs 2 of its own, 1 more than are free.  It waits for pages, and every
    output equals the lock path's and the cache-off engine's."""
    base = [(i * 13 + 5) % 250 + 1 for i in range(16)]
    sched = _paged(model, slots=4, slot_len=32, page_len=8, num_pages=8,
                   prefix_cache=prefix_cache)
    first = ([base + [3]], dict(max_new_tokens=6))
    holder = ([[7, 1, 9]], dict(max_new_tokens=29))
    hit = ([base + [11]], dict(max_new_tokens=15))
    outs = [sched.submit(first[0], **first[1]).result()]
    futs = [sched.submit(rows, **kw) for rows, kw in (holder, hit)]
    outs += [f.result() for f in futs]
    for (rows, kw), out in zip((first, holder, hit), outs):
        assert out == sequential(model, rows, **kw), (rows, kw)
    st = sched.stats()
    assert st["page_waits_total"] >= 1, st
    assert st["prefix_hits"] == (2 if prefix_cache else 0), st
    _pages_balanced(st)


def test_pipeline_on_and_off_give_equal_tokens(model):
    reqs = _interleave_reqs(model)
    outs = []
    for pipeline in (True, False):
        sched = _paged(model, slots=3, quantum=2, page_len=8,
                       prefill_chunk=8, pipeline=pipeline)
        outs.append(run_concurrently(sched, reqs))
        _pages_balanced(sched.stats())
        sched.stop()
    assert outs[0] == outs[1]


def test_paged_pool_steps_read_nothing_on_the_host(model, monkeypatch):
    """A paged quantum enqueues its steps without reading a tensor back."""
    sched = _paged(model, slots=2, pipeline=False)
    reads = []
    names = ("tolist", "item", "numpy", "__bool__", "__int__", "__float__",
             "__index__")
    real = {name: getattr(torch.Tensor, name) for name in names}

    def spy(name):
        def wrapped(self, *a, **k):
            reads.append(name)
            return real[name](self, *a, **k)
        return wrapped

    real_steps = paged.paged_pool_steps

    def watched(*a, **k):
        for name in names:
            setattr(torch.Tensor, name, spy(name))
        try:
            return real_steps(*a, **k)
        finally:
            for name in names:
                setattr(torch.Tensor, name, real[name])

    monkeypatch.setattr(paged, "paged_pool_steps", watched)
    got = sched.submit([[5, 9, 2], [1]], max_new_tokens=7).result()
    assert got == sequential(model, [[5, 9, 2], [1]], max_new_tokens=7)
    assert sched.stats()["steps_total"] == 8
    assert reads == []


# -- speculative decoding -----------------------------------------------------


def test_spec_decode_zero_accept_boundary(model, other_draft):
    """A draft that never agrees with the target: each verify still
    emits one correct token."""
    sched = _paged(model, draft_model=other_draft, spec_tokens=3)
    assert sched.submit(ROWS, max_new_tokens=12).result() == sequential(
        model, ROWS, max_new_tokens=12)
    st = sched.stats()
    assert st["spec_proposed"] > 0 and st["spec_accepted"] == 0
    assert st["draft_prefills_total"] == 1
    _pages_balanced(st)


def test_spec_decode_all_accept_boundary(model):
    """draft == target accepts every proposal: each step emits k + 1
    tokens, and the output is still the target's greedy stream."""
    sched = _paged(model, draft_model=model, spec_tokens=3)
    calls = verify_attention.calls
    assert sched.submit(ROWS, max_new_tokens=12).result() == sequential(
        model, ROWS, max_new_tokens=12)
    st = sched.stats()
    assert st["spec_proposed"] > 0
    assert st["spec_accepted"] == st["spec_proposed"]
    assert st["spec_steps_total"] == st["steps_total"] == 3   # 11 / 4
    assert verify_attention.calls - calls == model.cfg.n_layers * 3


def test_spec_decode_eos_inside_draft_window(model):
    """An accepted draft token that is the EOS stops its row there;
    tokens the verify scored past it are dropped."""
    rows = [[5, 9, 2, 7]]
    ref = sequential(model, rows, max_new_tokens=10)
    p = next(i for i in range(1, 4) if ref[0][i] not in ref[0][:i])
    eos = ref[0][p]
    sched = _paged(model, draft_model=model, spec_tokens=3)
    got = sched.submit(rows, max_new_tokens=10, eos_token=eos).result()
    assert got == sequential(model, rows, max_new_tokens=10, eos_token=eos)
    assert got[0][p + 1:] == [eos] * (9 - p)


def test_spec_decode_with_sampled_rows_takes_the_quantum(model, other_draft):
    """A sampled row in the pool holds speculation off (the normal
    quantum serves every row); greedy rows still equal their stream."""
    sched = _paged(model, draft_model=other_draft, spec_tokens=2)
    reqs = [(ROWS, dict(max_new_tokens=10)),
            ([[4, 4, 1]], dict(max_new_tokens=9, temperature=0.9, seed=5))]
    for (rows, kw), out in zip(reqs, run_concurrently(sched, reqs)):
        assert out == sequential(model, rows, **kw)
    _pages_balanced(sched.stats())


# -- configuration ------------------------------------------------------------


def test_env_gate_falls_back_to_the_fixed_pool(model, monkeypatch):
    """An instrumented service grows the paged engine; KFT_SERVE_PAGED=0
    gives the fixed-slot pool, with the fallback recorded and counted."""
    on = GenerationService(model)
    app_on = create_app(on, model_name="m")
    assert isinstance(on._scheduler_or_none(), PagedDecodeScheduler)
    assert on.scheduler_fallback is None
    info = json.loads(app_on.handle("GET", "/debug/serve", {}, b"")[2])
    assert info["engine"] == "PagedDecodeScheduler"
    assert info["paged_fallback"] is None
    assert info["scheduler"]["pages_total"] == 8 * 1 + 1
    monkeypatch.setenv("KFT_SERVE_PAGED", "0")
    off = GenerationService(model)
    app = create_app(off, model_name="m")
    sched = off._scheduler_or_none()
    assert type(sched) is DecodeScheduler
    assert off.scheduler_fallback["reason"] == "env-disabled"
    text = app.handle("GET", "/metrics", {}, b"")[2].decode()
    assert 'serve_paged_fallback_total{reason="env-disabled"} 1.0' in text
    info = json.loads(app.handle("GET", "/debug/serve", {}, b"")[2])
    assert info["paged_fallback"]["reason"] == "env-disabled"
    assert sched.submit([[5, 9]], max_new_tokens=4).result() == sequential(
        model, [[5, 9]], max_new_tokens=4)


def test_page_len_must_divide_slot_len(model):
    with pytest.raises(ValueError, match="divisor"):
        PagedDecodeScheduler(model, slots=2, slot_len=64, page_len=24)
    with pytest.raises(ValueError, match="full-length row"):
        PagedDecodeScheduler(model, slots=2, slot_len=64, page_len=16,
                             num_pages=4)


def test_knob_validation_raises(model, monkeypatch):
    """The integer knobs are strict: an unparseable or out-of-range value
    raises naming the knob instead of serving the default."""
    monkeypatch.setenv("KFT_SERVE_PAGE_LEN", "banana")
    with pytest.raises(ValueError, match="not a valid int"):
        PagedDecodeScheduler(model, slots=2, slot_len=64)
    monkeypatch.setenv("KFT_SERVE_PAGE_LEN", "8192")
    with pytest.raises(ValueError, match=r"must be in \[1, 4096\]"):
        PagedDecodeScheduler(model, slots=2, slot_len=64)
    monkeypatch.delenv("KFT_SERVE_PAGE_LEN")
    for name, bad, msg in (("KFT_SERVE_SPEC_TOKENS", "-1", r"\[0, 64\]"),
                           ("KFT_SERVE_SPEC_TOKENS", "65", r"\[0, 64\]"),
                           ("KFT_SERVE_PAGES", "-2", ">= 0"),
                           ("KFT_SERVE_PREFILL_CHUNK", "-1", ">= 0")):
        monkeypatch.setenv(name, bad)
        with pytest.raises(ValueError, match=f"{name}=.*{msg}"):
            PagedDecodeScheduler(model, slots=2, slot_len=64)
        monkeypatch.delenv(name)
    monkeypatch.setenv("KFT_SERVE_PAGE_LEN", "16")
    monkeypatch.setenv("KFT_SERVE_PAGES", "40")
    monkeypatch.setenv("KFT_SERVE_PREFILL_CHUNK", "0")
    monkeypatch.setenv("KFT_SERVE_SPEC_TOKENS", "2")
    monkeypatch.setenv("KFT_SERVE_PREFIX_CACHE", "0")
    sched = PagedDecodeScheduler(model, slots=2, slot_len=64)
    assert (sched.page_len, sched.num_pages, sched.prefill_chunk,
            sched.spec_tokens, sched.prefix) == (16, 40, 0, 2, None)
    with pytest.raises(ValueError, match="outside"):
        PagedDecodeScheduler(model, slots=2, slot_len=64, spec_tokens=65)


def test_submit_over_page_capacity_raises(model):
    sched = PagedDecodeScheduler(model, slots=2, slot_len=64, quantum=2,
                                 page_len=16, num_pages=6)
    with pytest.raises(ValueError, match="KV pages"):
        sched.submit([[1, 2]] * 4, max_new_tokens=30)
    with pytest.raises(ValueError, match="slot length"):
        sched.submit([[1] * 40], max_new_tokens=30)


def test_draft_model_loads_and_checks_its_vocab(model):
    """``load_service(draft_model_name=)`` builds the draft on the
    target's device; a draft of another vocabulary, or too short for the
    slots, fails at construction."""
    service = load_service("llama_debug", device="cpu", max_seq_len=MAX_SEQ,
                           draft_model_name="llama_debug", seed=0)
    assert service.draft_model is not None
    for a, b in zip(service.model.parameters(),
                    service.draft_model.parameters()):
        assert torch.equal(a, b)            # the same seed draws the same
    create_app(service, model_name="m")
    sched = service._scheduler_or_none()
    assert sched.draft_model is service.draft_model
    out = service.generate([[5, 9, 2]], max_new_tokens=6)
    assert out == sequential(service.model, [[5, 9, 2]], max_new_tokens=6)
    assert sched.stats()["spec_accepted"] == sched.stats()["spec_proposed"] > 0
    sched.stop()
    with pytest.raises(ValueError, match="vocab"):
        load_service("llama_debug", device="cpu",
                     draft_model_name="llama_125m")
    short = create_model("llama_debug", device="cpu", max_seq_len=32)
    with pytest.raises(ValueError, match="max_seq_len"):
        PagedDecodeScheduler(model, slots=2, slot_len=64, draft_model=short)


# -- lifecycle ----------------------------------------------------------------


def test_deadline_and_priority_ride_through(model):
    sched = _paged(model)
    fut = sched.submit([[5, 9]], max_new_tokens=3,
                       deadline=time.monotonic() - 0.001)
    with pytest.raises(DeadlineExceeded):
        fut.result()
    assert sched.alive
    rows = [[5, 9, 2, 7]]
    got = sched.submit(rows, max_new_tokens=4,
                       priority=PRIORITY_CLASSES["interactive"],
                       deadline=time.monotonic() + 60.0).result()
    assert got == sequential(model, rows, max_new_tokens=4)
    _pages_balanced(sched.stats())


def test_crash_fails_requests_and_releases_pages(model, monkeypatch):
    """A crash in the loop fails the outstanding request; the prefill in
    progress gives its pages back."""
    sched = _paged(model, prefill_chunk=4)

    def boom(*a, **k):
        raise RuntimeError("injected scheduler fault")

    monkeypatch.setattr(sched, "_run_quantum", boom)
    with pytest.raises(RuntimeError, match="injected"):
        sched.submit([[5, 9, 2, 7, 1, 1, 2, 3, 4]],
                     max_new_tokens=4).result()
    assert not sched.alive
    st = sched.stats()
    assert st["admitted_total"] == st["evicted_total"]


def _metric(text, name, labels=""):
    line = next(ln for ln in text.splitlines()
                if ln.startswith(name + labels + " "))
    return float(line.rsplit(" ", 1)[1])


def test_soak_shared_prefix_over_http_keeps_pages_balanced(model):
    """Concurrent HTTP clients send chats sharing one system prompt, in
    three waves: every response equals its request's lock-path run, two
    live lanes share pages only inside the prefix cache's (checked while
    they decode), hits accrue, and after each drain the pages and the
    serve counters balance."""
    service = GenerationService(model)
    app = create_app(service, model_name="llama_debug")
    sched = PagedDecodeScheduler(
        model, slots=4, slot_len=64, quantum=2, page_len=8,
        prefill_chunk=16, telemetry=lambda: service.telemetry)
    service._scheduler = sched
    overlaps = []
    real_harvest = sched._harvest_handle

    def checked(h):
        snap = sched.debug_pages()
        lanes = list(snap["lanes"].values())
        for i in range(len(lanes)):
            for j in range(i + 1, len(lanes)):
                overlaps.append(set(lanes[i]) & set(lanes[j])
                                - snap["shared"])
        return real_harvest(h)

    sched._harvest_handle = checked
    srv = app.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    sys_prompt = [9, 8, 7, 6, 5, 4, 3, 2, 1] * 2        # 18 tokens

    def call(i):
        body = {"tokens": [sys_prompt + [10 + i]], "max_new_tokens": 6}
        req = urllib.request.Request(base + "/v1/generate",
                                     data=json.dumps(body).encode())
        with opener.open(req, timeout=60) as resp:
            return json.loads(resp.read())["tokens"]

    try:
        for wave in range(3):
            with ThreadPoolExecutor(max_workers=6) as pool:
                got = list(pool.map(call, range(6 * wave, 6 * wave + 6)))
            for i, out in zip(range(6 * wave, 6 * wave + 6), got):
                assert out == sequential(model, [sys_prompt + [10 + i]],
                                         max_new_tokens=6), i
            deadline = time.time() + 10
            while sched._inflight is not None and time.time() < deadline:
                time.sleep(0.01)
            st = sched.stats()
            _pages_balanced(st)
            text = app.handle("GET", "/metrics", {}, b"")[2].decode()
            free = _metric(text, "serve_kv_pages", '{state="free"}')
            active = _metric(text, "serve_kv_pages", '{state="active"}')
            shared = _metric(text, "serve_kv_pages", '{state="shared"}')
            assert active == 0.0 and shared > 0
            assert free + active + shared == sched.num_pages - 1
            assert _metric(text, "serve_kv_page_fragmentation_ratio") == 0.0
            assert (_metric(text, "serve_scheduler_admitted_rows_total")
                    == _metric(text, "serve_scheduler_evicted_rows_total")
                    == 6 * (wave + 1))
            assert _metric(text, "serve_decode_slots_active") == 0.0
            assert _metric(text, "serve_queue_depth") == 0.0
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert overlaps and not any(overlaps)
    st = sched.stats()
    assert st["prefix_hits"] > 0
    assert (_metric(text, "serve_prefix_cache_hits_total"),
            _metric(text, "serve_prefix_cache_misses_total")) == (
        st["prefix_hits"], st["prefix_misses"])
    assert _metric(text, "serve_page_pool_shards") == 1.0


def test_telemetry_spec_counters_balance(model, other_draft):
    """accepted <= proposed, both on the serve registry: equal with the
    target as its own draft, zero accepted with a disagreeing draft."""
    for draft, all_accept in ((model, True), (other_draft, False)):
        service = GenerationService(model)
        app = create_app(service, model_name="m")
        service._scheduler = _paged(model, draft_model=draft, spec_tokens=3,
                                    telemetry=lambda s=service: s.telemetry)
        out = service.generate([[5, 9, 2, 7]], max_new_tokens=10)
        assert out == sequential(model, [[5, 9, 2, 7]], max_new_tokens=10)
        text = app.handle("GET", "/metrics", {}, b"")[2].decode()
        proposed = _metric(text, "serve_spec_decode_proposed_tokens_total")
        accepted = _metric(text, "serve_spec_decode_accepted_tokens_total")
        assert proposed > 0
        assert accepted == (proposed if all_accept else 0.0)
        st = service._scheduler.stats()
        assert (proposed, accepted) == (st["spec_proposed"],
                                        st["spec_accepted"])
        service._scheduler.stop()


def test_greedy_tokens_equal_the_jax_paged_engine_across_requests(
        model, jax_model_and_params):
    """Greedy requests one after another through both packages' paged
    engines (same lanes, pages, chunk and quantum; later requests hit the
    prefix the earlier ones cached): equal tokens."""
    jm, params = jax_model_and_params
    sys_prompt = [7, 3, 9, 1] * 5
    reqs = [([sys_prompt + [5, 9], [1, 2]], dict(max_new_tokens=7)),
            ([sys_prompt + [8, 8, 8]], dict(max_new_tokens=11)),
            ([[3, 1, 4, 1, 5, 9, 2, 6]], dict(max_new_tokens=5)),
            ([sys_prompt + [7]], dict(max_new_tokens=9))]
    kw = dict(slots=3, slot_len=64, quantum=4, page_len=8, prefill_chunk=8)
    jsched = jax_paged.PagedDecodeScheduler(jm, params, **kw)
    want = [jsched.submit(rows, **k).result() for rows, k in reqs]
    assert jsched.stats()["prefix_hits"] > 0
    sched = PagedDecodeScheduler(model, **kw)
    got = [sched.submit(rows, **k).result() for rows, k in reqs]
    assert got == want
    assert sched.stats()["prefix_hits"] > 0
    for (rows, k), out in zip(reqs, got):
        assert out == sequential(model, rows, **k)
    jax_want = jax.device_get(jax_generate(
        jm, params, jnp.array([reqs[2][0][0]], jnp.int32),
        rng=jax.random.key(0), max_new_tokens=5)).tolist()
    assert got[2] == jax_want
