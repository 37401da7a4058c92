"""Carry the JAX package's Llama parameters into the port's modules.

``params_from_jax`` takes the reference's flax param tree as nested dicts
of numpy arrays (the caller fetches it from JAX, e.g. with
``jax.device_get``; nothing here imports JAX) and returns a state dict for
``kubeflow_tpu_torch.models.llama.Llama``.  It takes either layout of
the reference's blocks: unrolled (``layer_i``, one subtree a layer) or
stacked (``layers_scan/block``, every leaf with a leading layer axis, the
tree of ``scan_layers=True``), whose layer axis it unstacks into the
port's per-layer modules.
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


SCAN_PREFIX = "layers_scan/block/"


def _block_leaves(cfg) -> Dict[str, tuple]:
    """One block's leaf path (below the block) -> shape."""
    d, hd = cfg.dim, cfg.head_dim
    return {
        "attn_norm/scale": (d,),
        "mlp_norm/scale": (d,),
        "attn/q_proj/kernel": (d, cfg.n_heads, hd),
        "attn/k_proj/kernel": (d, cfg.n_kv_heads, hd),
        "attn/v_proj/kernel": (d, cfg.n_kv_heads, hd),
        "attn/o_proj/kernel": (cfg.n_heads, hd, d),
        "mlp/gate_proj/kernel": (d, cfg.ffn_dim),
        "mlp/up_proj/kernel": (d, cfg.ffn_dim),
        "mlp/down_proj/kernel": (cfg.ffn_dim, d),
    }


def expected_leaves(cfg, *, scan_layers: bool = False) -> Dict[str, tuple]:
    """Reference leaf path -> shape, for a dense Llama config, in the
    unrolled layout or (``scan_layers``) the stacked one."""
    leaves = {"embed/embedding": (cfg.vocab_size, cfg.dim),
              "final_norm/scale": (cfg.dim,),
              "lm_head/kernel": (cfg.dim, cfg.vocab_size)}
    block = _block_leaves(cfg)
    if scan_layers:
        leaves.update({SCAN_PREFIX + k: (cfg.n_layers,) + shape
                       for k, shape in block.items()})
        return leaves
    for i in range(cfg.n_layers):
        leaves.update({f"layer_{i}/{k}": shape for k, shape in block.items()})
    return leaves


def _unstack(flat: Dict[str, np.ndarray], n_layers: int
             ) -> Dict[str, np.ndarray]:
    """The stacked layout's leaves as the unrolled layout's: leaf
    ``layers_scan/block/<path>`` [n_layers, ...] becomes ``layer_i/<path>``
    for each i (the other leaves pass through)."""
    out = {}
    for path, arr in flat.items():
        if not path.startswith(SCAN_PREFIX):
            out[path] = arr
            continue
        rest = path[len(SCAN_PREFIX):]
        for i in range(n_layers):
            out[f"layer_{i}/{rest}"] = arr[i]
    return out


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
    the reference's master weight exactly.  The tree may be in either
    layout (``layers_scan`` is told by its top-level key).  Raises
    ``KeyError`` on a missing or extra leaf and ``ValueError`` on a shape
    mismatch."""
    dense_dtype = param_dtype or cfg.param_dtype or cfg.dtype
    flat = _flatten(tree)
    scan_layers = "layers_scan" in tree
    want = expected_leaves(cfg, scan_layers=scan_layers)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"param tree mismatch: missing {missing}, "
                       f"extra {extra}")
    for path, shape in want.items():
        if tuple(flat[path].shape) != shape:
            raise ValueError(
                f"{path}: shape {flat[path].shape}, expected {shape}")
    if scan_layers:
        flat = _unstack(flat, cfg.n_layers)
        want = expected_leaves(cfg)
    state = {}
    for path in want:
        arr = flat[path]
        dtype = (torch.float32 if path.endswith("/scale")
                 or path == "lm_head/kernel" else dense_dtype)
        t = torch.from_numpy(np.ascontiguousarray(
            _convert(path, arr).astype(np.float32)))
        state[_target(path)] = t.to(dtype)
    return state
