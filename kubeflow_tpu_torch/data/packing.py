"""Sequence packing: variable-length documents into fixed [rows, seq_len]
token matrices with segment ids.

The port's copy of ``kubeflow_tpu/data/packing.py``.  The bin packing,
best fit decreasing, runs in the platform's native engine
(``platform/csrc/packer.cc`` through ``platform/native.py``) when the
process has already loaded it, in Python otherwise: the same assignment.
Packing never builds the engine itself, so a training worker does not
run ``g++`` or load the control plane to pack.  Segment ids start at 1
per row; 0 marks padding.  Attention masks cross-segment pairs, and the
LM step masks cross-document and pad targets out of the loss.
"""
from __future__ import annotations

import bisect
from typing import List, Sequence, Tuple

import numpy as np


def pack_documents(lengths: Sequence[int], row_len: int
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Assign documents to rows, best-fit decreasing.  Returns
    ``(row_assignment, row_offset, n_rows)``: document i goes to row
    ``row_assignment[i]`` at slot ``row_offset[i]``.  Raises ValueError if
    a length is < 1 or > row_len."""
    from kubeflow_tpu_torch.platform import native

    lengths = np.asarray(lengths, dtype=np.int64)
    if native.loaded():
        return native.native_pack(lengths, row_len)
    return _pack_python(lengths, row_len)


def _pack_python(lengths: np.ndarray, row_len: int
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The Python best-fit decreasing, the engine's semantic reference."""
    if any(n < 1 or n > row_len for n in lengths):
        raise ValueError(f"invalid document lengths for row_len={row_len}")
    order = sorted(range(len(lengths)), key=lambda i: -int(lengths[i]))
    assignment = np.empty(len(lengths), dtype=np.int64)
    offset = np.empty(len(lengths), dtype=np.int64)
    open_rows: List[Tuple[int, int]] = []  # sorted (remaining, row_id)
    used: List[int] = []
    for i in order:
        length = int(lengths[i])
        j = bisect.bisect_left(open_rows, (length, -1))
        if j == len(open_rows):
            row = len(used)
            used.append(0)
        else:
            row = open_rows[j][1]
            del open_rows[j]
        assignment[i] = row
        offset[i] = used[row]
        used[row] += length
        rem = row_len - used[row]
        if rem > 0:
            bisect.insort(open_rows, (rem, row))
    return assignment, offset, len(used)


def pack_tokens(docs: Sequence[np.ndarray], row_len: int, *, pad_id: int = 0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack token documents into ``(tokens, segment_ids)`` [n_rows, row_len].
    A document longer than row_len raises."""
    lengths = [len(d) for d in docs]
    assignment, offset, n_rows = pack_documents(lengths, row_len)
    tokens, segments, _ = _materialize_rows(
        docs, lengths, assignment, offset, n_rows, row_len, pad_id)
    return tokens, segments


def _materialize_rows(window, lengths, assignment, offset, keep_rows: int,
                      seq_len: int, pad_id: int):
    """Token and segment matrices for rows < keep_rows, plus the documents
    placed in later rows (carried into the next window, never dropped)."""
    tokens = np.full((keep_rows, seq_len), pad_id, dtype=np.int32)
    segments = np.zeros((keep_rows, seq_len), dtype=np.int32)
    seg_counter = np.zeros(keep_rows, dtype=np.int32)
    carry: List[np.ndarray] = []
    for i, doc in enumerate(window):
        r, o = int(assignment[i]), int(offset[i])
        if r >= keep_rows:
            carry.append(doc)
            continue
        seg_counter[r] += 1
        tokens[r, o:o + lengths[i]] = np.asarray(doc, dtype=np.int32)
        segments[r, o:o + lengths[i]] = seg_counter[r]
    return tokens, segments, carry


def packed_lm_batches(docs, *, batch_rows: int, seq_len: int,
                      pad_id: int = 0, drop_remainder: bool = True):
    """Generator: a stream of token documents -> ``(tokens, segment_ids)``
    batches [batch_rows, seq_len], packed over a rolling window; documents
    placed beyond batch_rows carry into the next window."""
    window: List[np.ndarray] = []
    total = 0
    for doc in docs:
        doc = np.asarray(doc)
        window.append(doc)
        total += len(doc)
        if total < batch_rows * seq_len:
            continue
        lengths = [len(d) for d in window]
        assignment, offset, _ = pack_documents(lengths, seq_len)
        tokens, segments, carry = _materialize_rows(
            window, lengths, assignment, offset, batch_rows, seq_len, pad_id)
        yield tokens, segments
        window = carry
        total = sum(len(d) for d in carry)
    while window and not drop_remainder:
        lengths = [len(d) for d in window]
        assignment, offset, _ = pack_documents(lengths, seq_len)
        tokens, segments, carry = _materialize_rows(
            window, lengths, assignment, offset, batch_rows, seq_len, pad_id)
        yield tokens, segments
        window = carry
