"""Carry the JAX package's Llama parameters into the port's modules.

``params_from_jax`` takes the reference's flax param tree as nested dicts
of numpy arrays (the caller fetches it from JAX, e.g. with
``jax.device_get``; nothing here imports JAX) and returns a state dict for
``kubeflow_tpu_torch.models.llama.Llama``.  The unrolled layout only
(``layer_i``); the ``layers_scan`` layout is still to be ported.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def expected_leaves(cfg) -> Dict[str, tuple]:
    """Reference leaf path -> shape, for a dense Llama config."""
    d, hd = cfg.dim, cfg.head_dim
    leaves = {"embed/embedding": (cfg.vocab_size, d),
              "final_norm/scale": (d,),
              "lm_head/kernel": (d, cfg.vocab_size)}
    for i in range(cfg.n_layers):
        p = f"layer_{i}"
        leaves.update({
            f"{p}/attn_norm/scale": (d,),
            f"{p}/mlp_norm/scale": (d,),
            f"{p}/attn/q_proj/kernel": (d, cfg.n_heads, hd),
            f"{p}/attn/k_proj/kernel": (d, cfg.n_kv_heads, hd),
            f"{p}/attn/v_proj/kernel": (d, cfg.n_kv_heads, hd),
            f"{p}/attn/o_proj/kernel": (cfg.n_heads, hd, d),
            f"{p}/mlp/gate_proj/kernel": (d, cfg.ffn_dim),
            f"{p}/mlp/up_proj/kernel": (d, cfg.ffn_dim),
            f"{p}/mlp/down_proj/kernel": (cfg.ffn_dim, d),
        })
    return leaves


def _target(path: str) -> str:
    """Reference leaf path -> port state-dict key."""
    if path == "embed/embedding":
        return "embed.embedding"
    if path == "lm_head/kernel":
        return "lm_head.weight"
    parts = path.split("/")
    if parts[0].startswith("layer_"):
        parts[0] = f"layers.{parts[0][len('layer_'):]}"
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def _convert(path: str, arr: np.ndarray) -> np.ndarray:
    """Reference layout -> torch layout (Linear weights are [out, in])."""
    if not path.endswith("/kernel"):
        return arr
    if arr.ndim == 3 and path.endswith("o_proj/kernel"):      # (H, hd, D)
        return arr.reshape(-1, arr.shape[-1]).T
    if arr.ndim == 3:                                         # (D, H, hd)
        return arr.reshape(arr.shape[0], -1).T
    return arr.T                                              # (in, out)


def params_from_jax(tree: Mapping, cfg,
                    param_dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
    """State dict for ``Llama(cfg)`` from the reference's param tree.
    Dense and embedding weights are stored in ``param_dtype`` (default
    ``cfg.param_dtype``, else ``cfg.dtype``: the reference casts them at
    use); norm scales and ``lm_head`` stay f32.  With f32 every leaf is
    the reference's master weight exactly.  Raises ``KeyError`` on a
    missing or extra leaf and ``ValueError`` on a shape mismatch."""
    dense_dtype = param_dtype or cfg.param_dtype or cfg.dtype
    flat = _flatten(tree)
    want = expected_leaves(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"param tree mismatch: missing {missing}, "
                       f"extra {extra}")
    state = {}
    for path, shape in want.items():
        arr = flat[path]
        if tuple(arr.shape) != shape:
            raise ValueError(f"{path}: shape {arr.shape}, expected {shape}")
        dtype = (torch.float32 if path.endswith("/scale")
                 or path == "lm_head/kernel" else dense_dtype)
        t = torch.from_numpy(np.ascontiguousarray(
            _convert(path, arr).astype(np.float32)))
        state[_target(path)] = t.to(dtype)
    return state
