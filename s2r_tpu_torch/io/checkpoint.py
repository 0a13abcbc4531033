"""Checkpoint save and restore (s2r_tpu/io/checkpoint.py), in the port's own
format: ``torch.save`` of {epoch, best_pred, state, extra}, written to a
temporary file and moved into place with ``os.replace``.

``state`` holds what a train step mutates (train/state.py): {step, G, D,
opt_state, generator} as the two modules' state_dicts (BatchNorm
statistics included; D the discriminator or the domain classifier), the
flat optimizer buffers of the method's layout and the dropout generator's
``get_state()``.  A checkpoint restores only into a state of its own
method's layout.

The port updates parameters in place, so an asynchronous save first copies
the state on the device (``snapshot``: clones, then an event on the
current stream) and returns; the writer thread waits on that event before
it moves the copies to the host, on a stream of its own.  The next step can
then run at once without racing the writer.  This is the counterpart of
the JAX package's ``_snapshot``.

A JAX msgpack ``.ckpt`` or a reference ``.pth`` raises NotImplementedError:
reading those is ROADMAP A.3.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Callable, Dict, Optional

import torch

from s2r_tpu_torch.train.state import TrainState

_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's archive


class AsyncWriter:
    """One ordered background thread for checkpoint writes.

    Jobs run FIFO (the best-promotion rule reads files earlier jobs
    wrote); an error is re-raised on the next submit() or wait(), so a
    checkpoint that failed to persist never looks saved.  The daemon
    thread starts at the first submit.
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self._lock = threading.Lock()

    def _run(self):
        while True:
            job = self._q.get()
            try:
                job()
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                with self._lock:
                    if self._err is None:
                        self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        with self._lock:
            err, self._err = self._err, None
        if err is not None:
            raise err

    def submit(self, job: Callable[[], None]) -> None:
        self._raise_pending()
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="s2r-ckpt-writer", daemon=True)
            self._thread.start()
        self._q.put(job)

    def wait(self) -> None:
        """Block until every submitted write is on disk; raise any error."""
        self._q.join()
        self._raise_pending()


def _map_tensors(tree, fn, memo=None):
    """`tree` with fn applied to each tensor; tensors that view the same
    memory (the backbone's alias keys) map to one result."""
    memo = {} if memo is None else memo
    if torch.is_tensor(tree):
        key = (tree.device, tree.data_ptr(), tree.dtype, tuple(tree.shape),
               tree.stride())
        if key not in memo:
            memo[key] = fn(tree)
        return memo[key]
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn, memo) for k, v in tree.items()}
    return tree


def state_tree(state: TrainState) -> Dict[str, Any]:
    """The live state as a tree of tensors (views of the modules' memory)."""
    return {"step": int(state.step), "G": state.G.state_dict(),
            "D": state.D.state_dict(), "opt_state": state.opt_state,
            "generator": state.generator.get_state()}


class Snapshot:
    """Device copies of a state tree, and the event after the copies."""

    def __init__(self, state: TrainState):
        self.tree = _map_tensors(state_tree(state),
                                 lambda t: t.detach().clone())
        self.device, self.event = state.generator.device, None
        if self.device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(self.device))

    def to_host(self) -> Dict[str, Any]:
        """The copies on the host; blocks until they exist."""
        if self.event is None:
            return self.tree
        self.event.synchronize()
        with torch.cuda.stream(torch.cuda.Stream(self.device)):
            return _map_tensors(self.tree, lambda t: t.to("cpu"))


def host_tree(state: TrainState) -> Dict[str, Any]:
    """A host copy of the state now (synchronous)."""
    return _map_tensors(state_tree(state),
                        lambda t: t.detach().to("cpu", copy=True))


def write_checkpoint(path: str, tree: Dict[str, Any], epoch: int,
                     best_pred: float,
                     extra: Optional[Dict[str, Any]] = None) -> None:
    payload = {"epoch": int(epoch), "best_pred": float(best_pred),
               "state": tree, "extra": extra or {}}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # atomic: no torn checkpoint on a crash


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    best_pred: float,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write `state` to `path` now."""
    write_checkpoint(path, host_tree(state), epoch, best_pred, extra)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """{'epoch', 'best_pred', 'state', 'extra'} of a checkpoint the port
    wrote, on the CPU."""
    if path.endswith((".pth", ".pth.tar")):
        raise NotImplementedError(
            f"s2r_tpu_torch: {path}: importing a reference torch checkpoint "
            "is not ported (ROADMAP A.3)")
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic != _ZIP_MAGIC:
        raise NotImplementedError(
            f"s2r_tpu_torch: {path} is not a checkpoint of the port (the "
            "JAX package's msgpack checkpoints are ROADMAP A.3)")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state(state: TrainState, saved: Dict[str, Any],
                  full: bool = True) -> TrainState:
    """Load a saved state tree into `state`: G and D (weights and BatchNorm
    statistics) always; with `full`, also the optimizer buffers, the step
    and the dropout generator (the JAX package's ``ft`` off).  Raises
    ValueError when the checkpoint holds another method's layout."""
    if sorted(saved["opt_state"]) != sorted(state.opt_state):
        raise ValueError(
            f"checkpoint optimizer states {sorted(saved['opt_state'])} do "
            f"not match this method's {sorted(state.opt_state)}: it was "
            "written by another training method")
    state.G.load_state_dict(saved["G"], strict=True)
    state.D.load_state_dict(saved["D"], strict=True)
    if full:
        dev = state.generator.device
        state.opt_state = _map_tensors(saved["opt_state"],
                                       lambda t: t.to(dev, copy=True))
        state.step = int(saved["step"])
        state.generator.set_state(saved["generator"])
    return state
