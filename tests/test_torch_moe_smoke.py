"""``chip_smoke.py``'s int8 and Mixtral phases, their constants held on
the CPU: the depth cut fits the card with what the phases keep beside it,
the requests fit the paged geometry and reach a second prefill chunk, and
the MoE layer's lengths give the capacities the phase reports.  A bad
constant fails here, not on the card."""
from __future__ import annotations

import torch

import chip_smoke as cs
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models.llama import CONFIGS
from kubeflow_tpu_torch.models.moe import capacity_of
from kubeflow_tpu_torch.models.quantize import quantized_bytes

CARD_BYTES = 80e9


def _weight_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def test_mixtral_depth_cut_fits_one_card_and_the_full_depth_does_not():
    full = create_model(cs.MOE_MODEL, device="meta")
    cut = create_model(cs.MOE_MODEL, device="meta",
                       n_layers=cs.MOE_SERVE_LAYERS)
    assert (cut.cfg.dim, cut.cfg.ffn_dim, cut.cfg.n_experts) == (
        full.cfg.dim, full.cfg.ffn_dim, full.cfg.n_experts)
    assert _weight_bytes(full) > CARD_BYTES         # 93.7 GB
    assert round(_weight_bytes(cut) / 1e9, 1) == 24.0
    assert round(sum(p.numel() for p in cut.parameters()) / 1e9, 2) == 11.87
    train = create_model(cs.MOE_MODEL, device="meta",
                         n_layers=cs.MOE_TRAIN_LAYERS,
                         param_dtype=torch.float32)
    n = sum(p.numel() for p in train.parameters())
    # f32 masters, both AdamW moments, bf16 copies and bf16 gradients.
    assert n * (4 * 3 + 2 + 2) < 0.5 * CARD_BYTES


def test_mixtral_requests_fit_the_paged_geometry():
    cfg = CONFIGS[cs.MOE_MODEL]
    lens = [n for spec in cs.MOE_REQUESTS.values() for n in spec[0]]
    assert max(lens) > cs.PAGED_CHUNK                # two prefill chunks
    assert max(lens) + cs.NEW_TOKENS <= cs.POOL_SLOT_LEN
    need = sum(cs.pages_needed(spec[0], spec[1], cs.PAGED_PAGE_LEN)
               for spec in cs.MOE_REQUESTS.values())
    assert need <= cs.PAGED_PAGES - 1
    assert len(cs.MOE_REQUESTS) <= cs.POOL_SLOTS
    assert any(spec[2].get("temperature") for spec in
               cs.MOE_REQUESTS.values())             # a seeded sampled row
    assert cfg.max_seq_len >= cs.POOL_SLOT_LEN


def test_moe_layer_lengths_reach_the_training_length():
    cfg = CONFIGS[cs.MOE_MODEL]
    for s in cs.MOE_LAYER_SEQS:
        c = capacity_of(s, cfg.top_k, cfg.capacity_factor, cfg.n_experts)
        assert c == int(s * 2 * 1.25 / 8)
    assert 2048 in cs.MOE_LAYER_SEQS and cs.MOE_TRAIN_SEQ == 2048


def test_int8_phase_quantizes_the_served_model():
    model = create_model(cs.INT8_MODEL, device="meta")
    bf16 = quantized_bytes(model)
    assert round(bf16 / 1e9, 2) == 17.11
    params = sum(p.numel() for p in model.parameters())
    # int8 values and (small) f32 scales: about half the bf16 bytes.
    assert 0.45 < params / bf16 < 0.5
