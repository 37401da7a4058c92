"""Model registry, so servers and harnesses build models by name."""
from __future__ import annotations

from typing import Any, Callable, Dict

from kubeflow_tpu_torch import resolve_device

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_model(name: str):
    """Decorator: register a model factory under ``name``."""

    def deco(fn: Callable[..., Any]):
        if name in _REGISTRY:
            raise ValueError(f"model {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def _register_families() -> None:
    """Import every model family for its registrations."""
    from kubeflow_tpu_torch.models import (  # noqa: F401
        bert,
        llama,
        resnet,
        t5,
        vit,
    )


def create_model(name: str, *, device="cuda", **overrides) -> Any:
    """Build a registered model on ``device`` (default the card; raises
    without one) with config ``overrides``.  Its parameters are
    uninitialised: call ``reset_parameters`` or ``load_state_dict``."""
    _register_families()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](device=resolve_device(device), **overrides)


def list_models() -> list:
    """The registered model names, sorted."""
    _register_families()
    return sorted(_REGISTRY)
