"""``chip_smoke.py``'s paged phase, its constants held on the CPU: the
geometry it serves at (lanes, slot length, pages, chunk, speculative
tokens) against the paged engine's knob defaults and checks, and each
request set against what it is there to exercise (two prefill chunks, a
prefix the trie can serve, a pool too small for the mix, headroom for
speculation).  A bad constant fails here, not on the card."""
from __future__ import annotations

import math

import pytest

import chip_smoke as cs
from kubeflow_tpu_torch import config
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models.llama import CONFIGS
from kubeflow_tpu_torch.models.paged import PagedDecodeScheduler

PAGED_KNOBS = ("KFT_SERVE_PAGE_LEN", "KFT_SERVE_PAGES",
               "KFT_SERVE_PREFILL_CHUNK", "KFT_SERVE_SPEC_TOKENS",
               "KFT_SERVE_PREFIX_CACHE", "KFT_SERVE_SLOTS",
               "KFT_SERVE_SLOT_LEN", "KFT_SERVE_DECODE_QUANTUM")


@pytest.fixture
def engine(monkeypatch):
    """A paged engine at a given slot length on a CPU stand-in model
    (llama_debug stretched to llama3_8b's max_seq_len; no pool is made
    until a request), every knob at its default."""
    for name in PAGED_KNOBS:
        monkeypatch.delenv(name, raising=False)
    model = create_model("llama_debug", device="cpu",
                         max_seq_len=CONFIGS["llama3_8b"].max_seq_len)

    def make(slot_len, **kw):
        return PagedDecodeScheduler(model, slots=cs.POOL_SLOTS,
                                    slot_len=slot_len,
                                    quantum=cs.POOL_QUANTUM, **kw)
    return make


@pytest.mark.parametrize("knob,value", [
    (config.SERVE_PAGE_LEN, cs.PAGED_PAGE_LEN),
    (config.SERVE_PREFILL_CHUNK, cs.PAGED_CHUNK),
    (config.SERVE_SPEC_TOKENS, cs.SPEC_TOKENS),
])
def test_phase_knobs_are_the_defaults_and_valid(knob, value):
    name, default, validate = knob
    assert value == default, name
    assert validate(value) is None, name


@pytest.mark.parametrize("slot_len,pages", [
    (cs.POOL_SLOT_LEN, cs.PAGED_PAGES),
    (cs.DEEP_SLOT_LEN, cs.POOL_SLOTS * cs.DEEP_SLOT_LEN // cs.PAGED_PAGE_LEN
     + 1),
])
def test_engine_geometry_at_the_phase_slot_lengths(engine, slot_len, pages):
    sched = engine(slot_len)
    assert (sched.page_len, sched.num_pages, sched.prefill_chunk,
            sched.spec_tokens) == (cs.PAGED_PAGE_LEN, pages, cs.PAGED_CHUNK,
                                   cs.SPEC_TOKENS)
    assert sched.max_pages_row == slot_len // cs.PAGED_PAGE_LEN
    assert cs.paged_pool_bytes(CONFIGS["llama3_8b"], pages) == (
        2 * 32 * pages * cs.PAGED_PAGE_LEN * 8 * 128 * 2)


def test_deep_slot_len_is_the_model_max_seq_len():
    assert cs.DEEP_SLOT_LEN == CONFIGS["llama3_8b"].max_seq_len
    assert cs.POOL_SLOT_LEN % cs.PAGED_PAGE_LEN == 0
    assert cs.DEEP_SLOT_LEN % cs.PAGED_PAGE_LEN == 0


def test_the_long_row_prefills_in_two_chunks_and_k2_takes_its_second():
    longest = max(max(lens) for lens, _, _ in cs.SCHEDULE_REQUESTS.values())
    assert math.ceil(longest / cs.PAGED_CHUNK) == 2
    assert (cs.CHUNK_B, cs.CHUNK_SQ, cs.CHUNK_SK) == (
        1, longest - cs.PAGED_CHUNK, longest)


def test_shared_prefix_set_is_served_by_the_trie():
    """The prefix is whole pages, every request's lookup may reach all of
    them (the cap leaves a suffix token), and each request fits a row."""
    p = cs.PAGED_PAGE_LEN
    assert cs.PREFIX_LEN % p == 0
    for m in cs.PREFIX_SUFFIXES:
        assert (cs.PREFIX_LEN + m - 1) // p >= cs.PREFIX_LEN // p
        assert cs.PREFIX_LEN + m + cs.PREFIX_NEW_TOKENS <= cs.POOL_SLOT_LEN


def test_pressure_pool_fits_each_request_but_not_the_mix(engine):
    sched = engine(cs.POOL_SLOT_LEN, num_pages=cs.PRESSURE_PAGES)
    usable = cs.PRESSURE_PAGES - 1
    needs = {}
    for name, (lens, n_new, _) in cs.SCHEDULE_REQUESTS.items():
        need = cs.pages_needed(lens, n_new, cs.PAGED_PAGE_LEN)
        assert need == sched._pages_per_row(max(lens), n_new) * len(lens)
        needs[name] = need
    assert max(needs.values()) <= usable, needs
    assert sum(needs.values()) > usable, needs
    assert cs.PRESSURE_PAGES >= sched.max_pages_row + 1


def test_pressure_holder_makes_a_prefix_hit_wait(engine):
    """The cache-on pressure run: the first shared-prefix request caches
    only the prefix's pages, the holder then leaves fewer free pages than
    the next request's own, and everything fits once the holder is gone.
    The same sequence through the engine waits for pages and still hits
    the whole prefix on every later request."""
    sched = engine(cs.POOL_SLOT_LEN, num_pages=cs.PRESSURE_PAGES)
    p = cs.PAGED_PAGE_LEN
    prefix_pages = cs.PREFIX_LEN // p
    assert (cs.PREFIX_LEN + cs.PREFIX_SUFFIXES[0]) // p == prefix_pages
    n_rows, length, new = cs.PRESSURE_HOLDER
    assert n_rows <= cs.POOL_SLOTS and length + new <= cs.POOL_SLOT_LEN
    holder = cs.pages_needed([length] * n_rows, new, p)
    assert holder == sched._pages_per_row(length, new) * n_rows
    free = cs.PRESSURE_PAGES - 1 - prefix_pages - holder
    own = [sched._pages_per_row(cs.PREFIX_LEN + m, cs.PREFIX_NEW_TOKENS)
           - prefix_pages for m in cs.PREFIX_SUFFIXES[1:]]
    assert 0 <= free < own[0], (free, own)
    assert sum(own) <= cs.PRESSURE_PAGES - 1 - prefix_pages

    vocab = sched.model.cfg.vocab_size
    shared = cs.prefix_bodies(vocab)
    holder_body = {"tokens": [[(i * 7 + r) % vocab for i in range(length)]
                              for r in range(n_rows)],
                   "max_new_tokens": new, "temperature": 0.0}
    cs.submit_body(sched, shared[0]).result()
    cs.wait_drained(sched)
    futs = [cs.submit_body(sched, b) for b in [holder_body] + shared[1:]]
    for f in futs:
        f.result()
    st = cs.wait_drained(sched)
    sched.stop()
    assert st["page_waits_total"] >= 1, st
    assert st["prefix_hits"] == (len(shared) - 1) * prefix_pages, st
    cs.check_pages_balanced("pressure with prefix hits", st)


def test_spec_rows_have_headroom_and_fit_the_pool(engine):
    """Every greedy request can take speculative steps to its end (k + 1
    slots past its last token), and its pages with the spec slack fit."""
    sched = engine(cs.POOL_SLOT_LEN, spec_tokens=cs.SPEC_TOKENS,
                   draft_model=create_model(
                       "llama_debug", device="cpu",
                       max_seq_len=cs.POOL_SLOT_LEN))
    total = 0
    for name, (lens, n_new, kw) in cs.SCHEDULE_REQUESTS.items():
        if kw.get("temperature", 0.0):
            continue
        assert max(lens) + n_new + cs.SPEC_TOKENS <= cs.POOL_SLOT_LEN, name
        need = cs.pages_needed(lens, n_new, cs.PAGED_PAGE_LEN,
                               cs.SPEC_TOKENS)
        assert need == sched._pages_per_row(max(lens), n_new) * len(lens)
        total += need
    assert total <= sched.num_pages - 1
    assert sum(len(lens) for lens, _, kw in cs.SCHEDULE_REQUESTS.values()
               if not kw.get("temperature")) <= cs.POOL_SLOTS


def test_null_page_k5_rows_fit_the_lanes():
    assert len(cs.POOL_LENS) + 1 == cs.POOL_SLOTS
    assert max(cs.POOL_LENS) <= cs.POOL_SLOT_LEN


def test_paged_launch_accounting():
    """The launches the phase expects from the engine's stats: a chunk
    or pool step one target forward, a spec step one verify pass and
    k + 1 draft steps, a draft prefill one draft forward."""
    target, draft = CONFIGS["llama3_8b"], CONFIGS["llama_debug"]
    st = {"steps_total": 10, "spec_steps_total": 3,
          "prefill_chunks_total": 4, "draft_prefills_total": 2}
    want, verify = cs.paged_launches(target, st, draft, k=4)
    n, d = target.n_layers, draft.n_layers
    assert want["flash_decode"] == n * 7 + d * 15
    assert want["flash_attention_fwd"] == n * 4 + d * 2
    assert want["rms_norm"] == (2 * n + 1) * 14 + (2 * d + 1) * 17
    assert verify == n * 3
    assert want["rms_norm_bwd"] == want["flash_attention_dq"] == 0
