"""Synthetic LM and image data and a loader that moves each batch to the
device.

The port's copy of ``kubeflow_tpu/data/loader.py``: the synthetic streams
draw the same numpy numbers as the reference's.  The reference's process
r draws its rows of the global batch from ``np.random.default_rng((seed,
r, i))``; here one process drives one device, and process r is this
process's index over the active mesh's data axes (dp, fsdp, ep;
``parallel/sharding.py`` ``data_coordinates``), so processes that differ
only in tp or sp draw the same rows, and without a mesh it is 0 of 1.
``DeviceLoader`` takes the place of ``ShardedLoader``: each process's
rows go to its own device.
"""
from __future__ import annotations

from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from kubeflow_tpu_torch.parallel.context import get_global_mesh


def data_process() -> tuple:
    """``(index, count)`` of this process over the active mesh's data axes
    ((0, 1) without a mesh)."""
    mesh = get_global_mesh()
    if mesh is None:
        return 0, 1
    from kubeflow_tpu_torch.parallel.sharding import data_coordinates

    return data_coordinates(mesh)


def _local_rows(global_batch: int) -> tuple:
    """``(rows, index)``: this process's rows of a global batch and its
    data index; a batch the processes do not divide raises."""
    index, count = data_process()
    if global_batch % count:
        raise ValueError(
            f"global batch {global_batch} not divisible by {count} hosts")
    return global_batch // count, index


def synthetic_lm_batches(*, global_batch: int, seq_len: int, vocab_size: int,
                         seed: int = 0, steps: Optional[int] = None,
                         start: int = 0) -> Iterator[np.ndarray]:
    """This process's random token rows [global_batch / processes, seq_len]
    int32.  Step-indexed: batch ``i`` depends only on ``(seed, process,
    i)``; ``start`` and ``steps`` are absolute step indices, as in the
    reference.  The process is read when the stream is made."""
    local, host = _local_rows(global_batch)

    def stream():
        i = start
        while steps is None or i < steps:
            rng = np.random.default_rng((seed, host, i))
            yield rng.integers(0, vocab_size, (local, seq_len),
                               dtype=np.int32)
            i += 1

    return stream()


def synthetic_lm_documents(*, vocab_size: int, seed: int = 0,
                           min_len: int = 8, max_len: int = 256,
                           docs: Optional[int] = None) -> Iterator[np.ndarray]:
    """Variable-length random token documents of this process (ids >= 1;
    0 is the pad id), the input of ``data/packing.py``
    ``packed_lm_batches``."""
    host, _ = data_process()

    def stream():
        rng = np.random.default_rng((seed, host))
        i = 0
        while docs is None or i < docs:
            n = int(rng.integers(min_len, max_len + 1))
            yield rng.integers(1, vocab_size, n, dtype=np.int32)
            i += 1

    return stream()


def synthetic_image_batches(*, global_batch: int, image_size: int = 224,
                            num_classes: int = 1000, channels: int = 3,
                            seed: int = 0, steps: Optional[int] = None,
                            start: int = 0):
    """This process's random ``(images [l, H, W, C] f32 NHWC, labels [l]
    int32)`` batches, standard-normal pixels.  Step-indexed like
    ``synthetic_lm_batches`` (``start`` and ``steps`` are absolute step
    indices), so a resumed run replays the stream."""
    local, host = _local_rows(global_batch)

    def stream():
        i = start
        while steps is None or i < steps:
            rng = np.random.default_rng((seed, host, i))
            images = rng.standard_normal(
                (local, image_size, image_size, channels)).astype(
                    np.float32)
            labels = rng.integers(0, num_classes, (local,), dtype=np.int32)
            yield images, labels
            i += 1

    return stream()


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
