"""Checkpoint save and restore (s2r_tpu/io/checkpoint.py).

The port's own format is ``torch.save`` of {epoch, best_pred, state,
extra}, written to a temporary file and moved into place with
``os.replace``.  ``load_checkpoint`` also reads the two foreign formats,
telling the three apart by their first bytes and contents, never by the
file's name:

- the port's: a zip archive (``torch.save``) holding those four keys;
- the JAX package's: flax ``msgpack_serialize`` of the same four keys, so
  a 4-entry msgpack map (first byte 0x84), read by io/msgpack_io.py and
  converted to the port's state tree (io/convert.py
  ``state_tree_from_jax``);
- the reference's ``.pth``/``.pth.tar`` (a zip or a legacy torch pickle
  holding ``state_dict`` or ``backbone_model_state_dict``), imported by
  io/torch_import.py.

``save_jax_checkpoint`` writes the JAX format from a port state
(io/convert.py ``train_state_to_jax``), which the JAX package resumes; what
JAX has no place for (the dropout generator's state and each BatchNorm's
num_batches_tracked) goes under ``extra['s2r_tpu_torch']``, which JAX
ignores, so port -> .ckpt -> port is bit-equal.

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

"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from s2r_tpu_torch.io import msgpack_io
from s2r_tpu_torch.io.convert import state_tree_from_jax, train_state_to_jax
from s2r_tpu_torch.io.torch_import import (import_reference_checkpoint,
                                           torch_load)
from s2r_tpu_torch.train.state import TrainState
from s2r_tpu_torch.utils.tree import map_tensors

_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's archive
_PICKLE_MAGIC = 0x80          # a legacy (pre-zip) torch.save pickle
_JAX_MAGIC = 0x84             # msgpack fixmap of 4 entries
PORT_EXTRA = "s2r_tpu_torch"  # extra's entry for what JAX has no place for


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


def state_tree(state: TrainState) -> Dict[str, Any]:
    """The live state as a tree of tensors (views of the modules' memory)."""
    return {"step": int(state.step), "G": state.G.state_dict(),
            "D": state.D.state_dict(), "opt_state": state.opt_state,
            "generator": state.generator.get_state()}


class Snapshot:
    """Device copies of a state tree, and the event after the copies."""

    def __init__(self, state: TrainState):
        self.tree = map_tensors(state_tree(state),
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
            return map_tensors(self.tree, lambda t: t.to("cpu"))


def host_tree(state: TrainState) -> Dict[str, Any]:
    """A host copy of the state now (synchronous)."""
    return map_tensors(state_tree(state),
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


def checkpoint_format(path: str) -> str:
    """'torch' (the port's or a reference file: a zip archive or a legacy
    pickle) or 'jax' (a 4-entry msgpack map), by the first bytes; anything
    else raises ValueError."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == _ZIP_MAGIC or head[:1] == bytes((_PICKLE_MAGIC,)):
        return "torch"
    if head[:1] == bytes((_JAX_MAGIC,)):
        return "jax"
    raise ValueError(f"{path}: not a checkpoint (first bytes {head!r}: "
                     "neither a torch file nor a JAX msgpack checkpoint)")


def read_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The raw payload of a JAX-format checkpoint: {'epoch', 'best_pred',
    'state': the TrainState's state dict of numpy leaves (bfloat16 leaves
    as torch tensors), 'extra'}."""
    with open(path, "rb") as f:
        payload = msgpack_io.unpackb(f.read())
    if not (isinstance(payload, dict)
            and {"epoch", "best_pred", "state", "extra"} <= set(payload)):
        raise ValueError(f"{path}: a msgpack file without the JAX "
                         "checkpoint's epoch, best_pred, state and extra")
    return payload


def _port_extra(state: TrainState) -> Dict[str, Any]:
    """What a JAX-format checkpoint keeps under extra[PORT_EXTRA]."""
    def counts(module):
        return {k: int(v) for k, v in module.state_dict().items()
                if k.endswith("num_batches_tracked")}

    return {"generator": state.generator.get_state().numpy().copy(),
            "num_batches_tracked": {"G": counts(state.G),
                                    "D": counts(state.D)}}


def save_jax_checkpoint(path: str, state: TrainState, epoch: int,
                        best_pred: float, seed: int = 1,
                        prng_impl: str = "rbg") -> None:
    """Write `state` as s2r_tpu/io/checkpoint.py ``save_checkpoint`` does
    (the JAX TrainState of the same method; its rng the bits of
    PRNGKey(seed) under `prng_impl`, by default the JAX Config's 'rbg'),
    atomically."""
    payload = {"epoch": int(epoch), "best_pred": float(best_pred),
               "state": train_state_to_jax(state, seed, prng_impl),
               "extra": {PORT_EXTRA: _port_extra(state)}}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_io.packb(payload))
    os.replace(tmp, path)


def _from_jax(payload: Dict[str, Any], backbone: str) -> Dict[str, Any]:
    """A JAX payload with its state converted to the port's tree."""
    js = payload["state"]
    tree = state_tree_from_jax(js["params"], js["batch_stats"],
                               js["opt_state"], js["step"], backbone)
    mine = (payload.get("extra") or {}).get(PORT_EXTRA)
    if mine:
        tree["generator"] = torch.from_numpy(
            np.asarray(mine["generator"], np.uint8).copy())
        for net in ("G", "D"):
            for k, v in mine["num_batches_tracked"][net].items():
                if k in tree[net]:
                    tree[net][k] = torch.tensor(int(v), dtype=torch.long)
    return {"format": "jax", "epoch": int(payload["epoch"]),
            "best_pred": float(payload["best_pred"]), "state": tree,
            "extra": payload.get("extra") or {}}


def load_checkpoint(path: str, backbone: str = "mobilenet"
                    ) -> Dict[str, Any]:
    """A checkpoint of any of the three formats of a DeepLab on `backbone`
    (the JAX and reference files do not name it), on the CPU: {'format':
    'port', 'jax' or 'reference', 'epoch', 'best_pred', ...}.  The port's
    and the JAX package's hold 'state', the port's state tree (the JAX
    one's 'generator' None unless the port wrote the file), and 'extra';
    a reference file holds 'reference', what io/torch_import.py
    ``import_reference_checkpoint`` returns."""
    if checkpoint_format(path) == "jax":
        return _from_jax(read_jax_checkpoint(path), backbone)
    obj = torch_load(path)
    if isinstance(obj, dict) and {"epoch", "best_pred", "state",
                                  "extra"} <= set(obj):
        return {"format": "port", **obj}
    if isinstance(obj, dict) and ("state_dict" in obj or
                                  "backbone_model_state_dict" in obj):
        ref = import_reference_checkpoint(obj, backbone)
        return {"format": "reference", "epoch": ref["epoch"],
                "best_pred": ref["best_pred"], "reference": ref}
    raise ValueError(f"{path}: a torch file that is neither a checkpoint of "
                     "the port nor a reference checkpoint")


def restore_state(state: TrainState, saved: Dict[str, Any],
                  full: bool = True) -> TrainState:
    """Load a saved state tree into `state`: G and D (weights and BatchNorm
    statistics) always; with `full`, also the optimizer buffers, the step
    and the dropout generator (the JAX package's ``ft`` off; a tree from a
    JAX file written by JAX has no generator, and the state's stays).
    Raises ValueError when the checkpoint holds another method's layout,
    naming both."""
    if sorted(saved["opt_state"]) != sorted(state.opt_state):
        raise ValueError(
            f"checkpoint optimizer states {sorted(saved['opt_state'])} "
            f"({_layout_name(saved['opt_state'])}) do not match this "
            f"method's {sorted(state.opt_state)} "
            f"({_layout_name(state.opt_state)}): it was written by another "
            "training method")
    state.G.load_state_dict(saved["G"], strict=True)
    state.D.load_state_dict(saved["D"], strict=True)
    if full:
        dev = state.generator.device
        state.opt_state = map_tensors(saved["opt_state"],
                                      lambda t: t.to(dev, copy=True))
        state.step = int(saved["step"])
        if saved.get("generator") is not None:
            state.generator.set_state(saved["generator"])
    return state


def _layout_name(opt_state) -> str:
    if "task" in opt_state:
        return "the feature_adapt / source_only layout"
    if "G" in opt_state:
        return "the output_adapt layout"
    return "an unknown layout"
