"""Carry the JAX package's parameters into the port's modules.

``params_from_jax`` takes the reference's flax param tree as nested dicts
of numpy arrays (the caller fetches it from JAX, e.g. with
``jax.device_get``; nothing here imports JAX) and returns a state dict for
``kubeflow_tpu_torch.models.llama.Llama``.  It takes either layout of
the reference's blocks: unrolled (``layer_i``, one subtree a layer) or
stacked (``layers_scan/block``, every leaf with a leading layer axis, the
tree of ``scan_layers=True``), whose layer axis it unstacks into the
port's per-layer modules.

``state_from_flax`` does the same for ResNet (``params`` and
``batch_stats``), ViT, BERT and T5, from the flax variable tree (T5's
``DenseGeneral`` q/k/v kernels [dim, h, hd] and o kernels [h, hd, dim]
become [out, in] weights, as Llama's do).
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
    """One block's leaf path (below the block) -> shape: the SwiGLU's
    three kernels, or with ``n_experts`` the MoE router and the batched
    expert tensors."""
    d, hd, f = cfg.dim, cfg.head_dim, cfg.ffn_dim
    leaves = {
        "attn_norm/scale": (d,),
        "mlp_norm/scale": (d,),
        "attn/q_proj/kernel": (d, cfg.n_heads, hd),
        "attn/k_proj/kernel": (d, cfg.n_kv_heads, hd),
        "attn/v_proj/kernel": (d, cfg.n_kv_heads, hd),
        "attn/o_proj/kernel": (cfg.n_heads, hd, d),
    }
    e = cfg.n_experts
    if e > 0:
        leaves.update({"mlp/router/kernel": (d, e),
                       "mlp/w_gate": (e, d, f), "mlp/w_up": (e, d, f),
                       "mlp/w_down": (e, f, d)})
    else:
        leaves.update({"mlp/gate_proj/kernel": (d, f),
                       "mlp/up_proj/kernel": (d, f),
                       "mlp/down_proj/kernel": (f, d)})
    return leaves


def expected_leaves(cfg, *, scan_layers: bool = False) -> Dict[str, tuple]:
    """Reference leaf path -> shape, for a Llama config (dense or MoE),
    in the unrolled layout or (``scan_layers``) the stacked one."""
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


def reference_path(key: str) -> str:
    """Port state-dict key -> reference leaf path (``_target`` inverted)."""
    if key == "embed.embedding":
        return "embed/embedding"
    parts = key.split(".")
    if parts[0] == "layers":
        parts = [f"layer_{parts[1]}"] + parts[2:]
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


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
                    param_dtype: Optional[torch.dtype] = None, *,
                    mesh=None, rules=None) -> Dict[str, torch.Tensor]:
    """State dict for ``Llama(cfg)`` from the reference's param tree.
    Dense, expert and embedding weights are stored in ``param_dtype``
    (default ``cfg.param_dtype``, else ``cfg.dtype``: the reference casts
    them at use); norm scales, ``lm_head`` and the MoE router (transposed,
    as the head is) stay f32.  With f32 every leaf is
    the reference's master weight exactly.  The tree may be in either
    layout (``layers_scan`` is told by its top-level key).  Raises
    ``KeyError`` on a missing or extra leaf and ``ValueError`` on a shape
    mismatch.

    With ``mesh`` and ``rules`` (``parallel/sharding.py``) the whole set
    is converted, then each tensor is cut to this process's slice by the
    rules: a sharded model takes them as they are
    (``sharding.shard_for_serving(source=...)``)."""
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
        dtype = (torch.float32 if path.endswith(("/scale", "/router/kernel"))
                 or path == "lm_head/kernel" else dense_dtype)
        t = torch.from_numpy(np.ascontiguousarray(
            _convert(path, arr).astype(np.float32)))
        state[_target(path)] = t.to(dtype)
    if mesh is not None:
        from kubeflow_tpu_torch.parallel.sharding import (
            layout_for,
            local_shard,
        )

        state = {k: local_shard(v, layout_for(k, v.shape, rules, mesh), mesh)
                 for k, v in state.items()}
    return state


# -- ResNet, ViT, BERT, T5 --------------------------------------------------

# A flax block name's prefix (before its index) -> the port's ModuleList.
_BLOCK_PREFIXES = {"BottleneckBlock_": "blocks", "BasicBlock_": "blocks",
                   "block_": "blocks", "layer_": "layers",
                   "encoder_": "encoder_blocks", "decoder_": "decoder_blocks"}


def _flax_key(path: str) -> str:
    """A flax variable path of ResNet, ViT, BERT or T5 -> the port's
    state-dict key: ``BottleneckBlock_i``/``BasicBlock_i``/``block_i`` ->
    ``blocks.i``, ``layer_i`` -> ``layers.i``, T5's ``encoder_i`` and
    ``decoder_i`` -> ``encoder_blocks.i`` and ``decoder_blocks.i``, a
    block's ``Conv_j``/``BatchNorm_j`` -> ``convs.j``/``norms.j``,
    ``kernel`` -> ``weight``."""
    out = []
    for part in path.split("/"):
        for prefix, group in _BLOCK_PREFIXES.items():
            if part.startswith(prefix) and part[len(prefix):].isdigit():
                part = f"{group}.{part[len(prefix):]}"
                break
        else:
            if part.startswith("Conv_"):
                part = f"convs.{part[len('Conv_'):]}"
            elif part.startswith("BatchNorm_"):
                part = f"norms.{part[len('BatchNorm_'):]}"
            elif part == "kernel":
                part = "weight"
        out.append(part)
    return ".".join(out)


def _flax_array(path: str, arr: np.ndarray) -> np.ndarray:
    """Reference layout -> torch layout: conv kernels HWIO -> OIHW, dense
    kernels transposed (``_convert``), everything else as it is."""
    if path.endswith("/kernel") and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return _convert(path, arr)


def state_from_flax(variables: Mapping, module) -> Dict[str, torch.Tensor]:
    """State dict for ``module`` (a port ResNet, ViT, Bert or T5) from the
    reference's variable tree as nested dicts of numpy arrays:
    ``{"params": ..., "batch_stats": ...}`` (ResNet's running stats go to
    the norms' ``mean``/``var`` buffers).  Every tensor is f32, on the
    module's device.  Raises ``KeyError`` on a missing or extra leaf and
    ``ValueError`` on a shape mismatch."""
    own = module.state_dict()
    state = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})).items():
            key = _flax_key(path)
            if key in state:
                raise KeyError(f"two leaves map to {key}")
            state[key] = _flax_array(path, arr)
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"variable tree mismatch: missing {missing}, "
                       f"extra {extra}")
    out = {}
    for key, arr in state.items():
        if tuple(arr.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)}, expected "
                             f"{tuple(own[key].shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(
            arr.astype(np.float32))).to(own[key].device)
    return out
