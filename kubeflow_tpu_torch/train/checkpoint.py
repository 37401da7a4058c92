"""Checkpoints of the port's train state on ``torch.save``: save every N
steps, keep the newest few, resume from the latest, restore the
parameters alone for serving.

Counterpart of ``kubeflow_tpu/train/checkpoint.py`` (Orbax there).

    mgr = CheckpointManager(directory, max_to_keep=3)
    mgr.save(step, state)                # snapshot now, write in the background
    mgr.restore(state)                   # into the state's module/optimizer
    mgr.restore_params(template=model)   # parameters only, model's dtype

One directory per step::

    <directory>/<step>/params.pt     state-dict key -> tensor (parameters,
                                     and buffers: a ResNet's batch stats)
    <directory>/<step>/optimizer.pt  optimizer state keyed by parameter name
    <directory>/<step>/meta.json     {"step": ..., "format": 1}

A step is written under a temporary name (``.tmp-...``) and renamed once
every file is flushed to disk, so ``all_steps`` never lists a half-written
step.  The parameters sit in their own file, so ``restore_params`` never
reads the optimizer state (twice the parameters for AdamW).  Optimizer
state is keyed by parameter name, not by its position in the optimizer.

A state sharded over a mesh (``parallel/train.py``) is saved whole, in
the same files as a one-process run: every process takes part in
gathering the full parameters and optimizer state
(``ShardedTrainState.full_state``), and rank 0 writes them.  ``restore``
reads the full state on every process and keeps each process's shards,
so a checkpoint moves between a mesh and one process bit for bit, either
way.  In a
process group the step list is rank 0's (broadcast), so every process
takes the same decisions; the directory must be shared.

The port's train step updates the state in place (``train/steps.py``),
so ``save`` takes its snapshot on the caller's thread before it returns:
device tensors are copied into pinned host buffers (kept for the next
save) on the caller's stream, which orders the copy before any later
update; CPU tensors are cloned (``host_snapshot``).  A background thread
waits for the copy, then writes the files; ``wait`` joins it and raises
what it raised.  A sharded state's ``full_state`` copies its gathered
tensors the same way, once each, into the same buffers, on the process
that writes, and waits for the device itself.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import uuid
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

log = logging.getLogger("kubeflow_tpu_torch.train.checkpoint")

PARAMS_FILE = "params.pt"
OPTIMIZER_FILE = "optimizer.pt"
META_FILE = "meta.json"
FORMAT = 1


def _flat_params(optimizer) -> list:
    """The optimizer's parameters in ``state_dict`` index order."""
    return [p for g in optimizer.param_groups for p in g["params"]]


def optimizer_state_by_name(module, optimizer) -> dict:
    """``optimizer.state_dict()`` with each parameter index replaced by
    the parameter's name in ``module`` (tensors are the live ones)."""
    names = {id(p): n for n, p in module.named_parameters()}
    index_name = {i: names[id(p)]
                  for i, p in enumerate(_flat_params(optimizer))}
    sd = optimizer.state_dict()
    return {"state": {index_name[i]: v for i, v in sd["state"].items()},
            "param_groups": [dict(g, params=[index_name[i]
                                             for i in g["params"]])
                             for g in sd["param_groups"]]}


def load_optimizer_state_by_name(module, optimizer, saved: dict) -> None:
    """Load a state from ``optimizer_state_by_name`` into ``optimizer``,
    matching by name; torch moves each tensor to its parameter's device
    and floating dtype."""
    names = {id(p): n for n, p in module.named_parameters()}
    groups = optimizer.param_groups
    if len(saved["param_groups"]) != len(groups):
        raise ValueError(f"checkpoint has {len(saved['param_groups'])} "
                         f"param groups, the optimizer {len(groups)}")
    index = {names[id(p)]: i for i, p in enumerate(_flat_params(optimizer))}
    param_groups = []
    for g_saved, g in zip(saved["param_groups"], groups):
        own = [names[id(p)] for p in g["params"]]
        if set(g_saved["params"]) != set(own):
            raise KeyError(
                "optimizer param group mismatch: missing "
                f"{sorted(set(own) - set(g_saved['params']))}, extra "
                f"{sorted(set(g_saved['params']) - set(own))}")
        param_groups.append(dict(g_saved, params=[index[n] for n in own]))
    optimizer.load_state_dict({
        "state": {index[n]: v for n, v in saved["state"].items()},
        "param_groups": param_groups})


def load_params(module, params: Dict[str, torch.Tensor]) -> None:
    """Copy ``params`` into ``module``'s own tensors (its device and
    dtype).  Raises ``KeyError`` on a missing or extra name and
    ``ValueError`` on a shape mismatch."""
    own = module.state_dict()
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"checkpoint parameters mismatch: missing {missing}, "
                       f"extra {extra}")
    with torch.no_grad():
        for name, t in own.items():
            src = params[name]
            if src.shape != t.shape:
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(src.shape)}, model {tuple(t.shape)}")
            t.copy_(src)


def _group_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_snapshot(buffers: Optional[Dict[str, torch.Tensor]], key: str,
                  t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` that training in place cannot change: a CPU tensor
    cloned; a CUDA tensor copied once to the host, into the pinned buffer
    ``buffers[key]`` without waiting (made on the first save and kept for
    the next; the caller waits for the device before it reads the copy)
    or, with no ``buffers``, into a new tensor."""
    t = t.detach()
    if t.device.type != "cuda":
        return t.clone()
    if buffers is None:
        return t.cpu()
    buf = buffers.get(key)
    if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buffers[key] = buf
    buf.copy_(t, non_blocking=True)
    return buf


def is_sharded(state) -> bool:
    """Whether ``state`` holds shards over a mesh
    (``parallel/train.py`` ``ShardedTrainState``)."""
    return getattr(state, "mesh", None) is not None


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(path: str, obj) -> int:
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())
    return os.path.getsize(path)


class CheckpointManager:
    """Steps of one run under ``directory``.  ``save_interval_steps``
    skips steps that are not a multiple of it (unless ``force``);
    ``max_to_keep`` (None keeps all) deletes the oldest steps past it;
    ``async_save=False`` writes before ``save`` returns."""

    def __init__(self, directory: str, *, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1, async_save: bool = True):
        if save_interval_steps < 1:
            raise ValueError(
                f"save_interval_steps must be >= 1, got {save_interval_steps}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        self._host: Dict[str, torch.Tensor] = {}   # pinned snapshot buffers
        self._thread: Optional[threading.Thread] = None
        self._pending_step: Optional[int] = None
        self._error: Optional[BaseException] = None
        # The last completed save: step, bytes, snapshot_seconds (on the
        # caller's thread), write_seconds (the background write).
        self.last_save: Optional[dict] = None

    # -- steps ------------------------------------------------------------

    def _disk_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(
                    os.path.join(self.directory, name, META_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def all_steps(self) -> List[int]:
        """Complete steps on disk, plus the one being written (rank 0's
        list in a process group, where every process must call it)."""
        steps = self._disk_steps()
        if self._pending_step is not None and \
                self._pending_step not in steps:
            steps = sorted(steps + [self._pending_step])
        if _group_size() > 1:
            box = [steps]
            dist.broadcast_object_list(box, src=0)
            steps = box[0]
        return steps

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    # -- save -------------------------------------------------------------

    def _snapshot(self, key: str, t: torch.Tensor) -> torch.Tensor:
        return host_snapshot(self._host, key, t)

    def save(self, step: int, state, *, force: bool = False) -> bool:
        """Snapshot ``state`` (a ``TrainState``: module, optimizer, step)
        and write it as ``step``.  Returns False when the interval skips
        the step or a step at or past it is already saved (unless
        ``force``).  Waits for the previous write first."""
        step = int(step)
        self.wait()
        latest = self.latest_step()
        if not force and (step % self.save_interval_steps
                          or (latest is not None and latest >= step)):
            return False
        if step in self.all_steps():
            raise FileExistsError(f"checkpoint step {step} already exists "
                                  f"under {self.directory}")
        t0 = time.perf_counter()
        event = None
        if is_sharded(state):
            # Every process gathers; only the one that writes copies.
            if _rank() != 0:
                state.full_state(to_host=False)
                return True
            params, optim = state.full_state(self._host)
        else:
            params = {name: self._snapshot(f"params/{name}", t)
                      for name, t in state.module.state_dict().items()}
            optim = None
            if state.optimizer is not None:
                optim = optimizer_state_by_name(state.module,
                                                state.optimizer)
                optim["state"] = {
                    name: {k: (self._snapshot(f"optim/{name}/{k}", v)
                               if isinstance(v, torch.Tensor) else v)
                           for k, v in per.items()}
                    for name, per in optim["state"].items()}
            if any(p.is_cuda for p in state.module.parameters()):
                event = torch.cuda.Event()
                event.record()
        meta = {"step": step, "format": FORMAT,
                "train_step": int(state.step)}
        snapshot_s = time.perf_counter() - t0
        self._pending_step = step
        self._error = None
        self._thread = threading.Thread(
            target=self._write_step,
            args=(step, params, optim, meta, event, snapshot_s),
            name="kft-checkpoint-writer", daemon=True)
        self._thread.start()
        if not self.async_save:
            self.wait()
        return True

    def _write_step(self, step, params, optim, meta, event, snapshot_s):
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory,
                           f".tmp-{step}-{uuid.uuid4().hex[:12]}")
        try:
            if event is not None:
                event.synchronize()
            os.makedirs(tmp)    # and the directory, on the first save
            nbytes = _write(os.path.join(tmp, PARAMS_FILE), params)
            if optim is not None:
                nbytes += _write(os.path.join(tmp, OPTIMIZER_FILE), optim)
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            os.rename(tmp, self._step_dir(step))
            _fsync_dir(self.directory)
            self._prune()
            self.last_save = {"step": step, "bytes": nbytes,
                              "snapshot_seconds": snapshot_s,
                              "write_seconds": time.perf_counter() - t0}
            log.info("checkpoint step %d: %d bytes in %.3f s", step, nbytes,
                     self.last_save["write_seconds"])
        except BaseException as exc:  # noqa: BLE001 — re-raised by wait()
            self._error = exc
            shutil.rmtree(tmp, ignore_errors=True)

    def _prune(self) -> None:
        if self.max_to_keep is None:
            return
        steps = self._disk_steps()
        for step in steps[:max(len(steps) - self.max_to_keep, 0)]:
            shutil.rmtree(self._step_dir(step))

    def wait(self) -> None:
        """Block until the write in flight (if any) is on disk; raise the
        error it stopped with."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._pending_step = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    # -- restore ----------------------------------------------------------

    def _resolve(self, step: Optional[int]) -> Optional[int]:
        self.wait()
        return int(step) if step is not None else self.latest_step()

    def _load(self, step: int, name: str, *, mmap: bool = True):
        return torch.load(os.path.join(self._step_dir(step), name),
                          map_location="cpu", weights_only=True, mmap=mmap)

    def restore(self, template, *, step: Optional[int] = None):
        """Load ``step`` (default the latest) into ``template``, a
        ``TrainState``: its module's parameters and buffers (the batch
        stats the reference's ``TrainState.batch_stats`` carries), its
        optimizer's state and its step count, each tensor on the
        template's device and in its dtype.  Returns the template, or
        None when there is no checkpoint."""
        step = self._resolve(step)
        if step is None:
            return None
        params = self._load(step, PARAMS_FILE)
        optim = (None if template.optimizer is None
                 else self._load(step, OPTIMIZER_FILE, mmap=False))
        if is_sharded(template):
            params, optim = template.load_full_state(params, optim)
        load_params(template.module, params)
        if optim is not None:
            load_optimizer_state_by_name(template.module, template.optimizer,
                                         optim)
        with open(os.path.join(self._step_dir(step), META_FILE)) as f:
            template.step = int(json.load(f)["train_step"])
        return template

    def restore_params(self, *, step: Optional[int] = None, template=None):
        """The parameters of ``step`` (default the latest) alone, without
        reading the optimizer state.  With ``template`` (a module) they
        are loaded into it, in its dtype and on its device, and its state
        dict is returned; without, the CPU tensors as saved.  None when
        there is no checkpoint."""
        step = self._resolve(step)
        if step is None:
            return None
        params = self._load(step, PARAMS_FILE)
        if template is None:
            return params
        load_params(template, params)
        return template.state_dict()

    def close(self) -> None:
        """Wait for the write in flight and free the snapshot buffers."""
        try:
            self.wait()
        finally:
            self._host.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
