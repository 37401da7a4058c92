"""Synthetic LM and image data and a loader that moves each batch to the
device.

The port's copy of ``kubeflow_tpu/data/loader.py`` for one process: the
synthetic streams draw the same numpy numbers as the reference's for the
same seed at process index 0 (``np.random.default_rng((seed, 0, i))``), so
a run of either package sees the same tokens.  ``DeviceLoader`` takes the
place of ``ShardedLoader``: no mesh, no sharding, one device.
"""
from __future__ import annotations

from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

# The reference stitches a global batch from per-host slices; the port
# runs one process, which is host 0.
PROCESS_INDEX = 0


def synthetic_lm_batches(*, global_batch: int, seq_len: int, vocab_size: int,
                         seed: int = 0, steps: Optional[int] = None,
                         start: int = 0) -> Iterator[np.ndarray]:
    """Random token batches [global_batch, seq_len] int32.  Step-indexed:
    batch ``i`` depends only on ``(seed, i)``; ``start`` and ``steps`` are
    absolute step indices, as in the reference."""
    i = start
    while steps is None or i < steps:
        rng = np.random.default_rng((seed, PROCESS_INDEX, i))
        yield rng.integers(0, vocab_size, (global_batch, seq_len),
                           dtype=np.int32)
        i += 1


def synthetic_lm_documents(*, vocab_size: int, seed: int = 0,
                           min_len: int = 8, max_len: int = 256,
                           docs: Optional[int] = None) -> Iterator[np.ndarray]:
    """Variable-length random token documents (ids >= 1; 0 is the pad id),
    the input of ``data/packing.py`` ``packed_lm_batches``."""
    rng = np.random.default_rng((seed, PROCESS_INDEX))
    i = 0
    while docs is None or i < docs:
        n = int(rng.integers(min_len, max_len + 1))
        yield rng.integers(1, vocab_size, n, dtype=np.int32)
        i += 1


def synthetic_image_batches(*, global_batch: int, image_size: int = 224,
                            num_classes: int = 1000, channels: int = 3,
                            seed: int = 0, steps: Optional[int] = None,
                            start: int = 0):
    """Random ``(images [b, H, W, C] f32 NHWC, labels [b] int32)`` batches,
    standard-normal pixels.  Step-indexed like ``synthetic_lm_batches``
    (``start`` and ``steps`` are absolute step indices), so a resumed run
    replays the stream."""
    i = start
    while steps is None or i < steps:
        rng = np.random.default_rng((seed, PROCESS_INDEX, i))
        images = rng.standard_normal(
            (global_batch, image_size, image_size, channels)).astype(
                np.float32)
        labels = rng.integers(0, num_classes, (global_batch,),
                              dtype=np.int32)
        yield images, labels
        i += 1


class DeviceLoader:
    """Iterate numpy batches (an array or a tuple of arrays) as tensors on
    ``device``.  The copy is issued without a host sync (pinned memory on
    the card), so it overlaps the previous step's device work."""

    def __init__(self, batches: Iterable[Any], device):
        self._it = iter(batches)
        self._device = torch.device(device)

    def _move(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def __iter__(self):
        for batch in self._it:
            if isinstance(batch, (tuple, list)):
                yield tuple(self._move(x) for x in batch)
            else:
                yield self._move(batch)
