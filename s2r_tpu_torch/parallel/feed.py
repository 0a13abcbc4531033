"""Host -> device feeding with overlap (s2r_tpu/parallel/feed.py).

The reference pays a synchronous ``.cuda()`` copy at the top of every step
(train_adapt.py:129).  Here each host batch is copied into pinned memory
and sent to the card with ``non_blocking=True`` on a side stream while the
previous steps run, keeping `size` batches in flight.  The consuming
stream waits on the copy's event, and each tensor is ``record_stream``-ed
to it so the allocator does not hand its memory out early.  A pinned
buffer is kept alive until its copy's event has completed.

String-valued keys (e.g. 'name') pass through on the host.  On the CPU the
batches are only converted to tensors.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, Iterator, Union

import numpy as np
import torch


def _passthrough(v) -> bool:
    return isinstance(v, (list, str))


def _to_tensors(batch: Dict) -> Dict:
    return {k: v if _passthrough(v) else torch.as_tensor(v)
            for k, v in batch.items()}


def prefetch_to_device(iterator: Iterable[Dict],
                       device: Union[str, torch.device],
                       size: int = 2) -> Iterator[Dict]:
    """Yield the batches of `iterator` as tensors on `device`."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield _to_tensors(batch)
        return
    stream = torch.cuda.Stream(device)

    def put(batch: Dict):
        out, pinned = {}, []
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                if _passthrough(v):
                    out[k] = v
                    continue
                host = torch.as_tensor(np.ascontiguousarray(v)).pin_memory()
                out[k] = host.to(device, non_blocking=True)
                pinned.append(host)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event, pinned

    it = iter(iterator)
    buf = collections.deque()
    retired = []  # (event, pinned buffers) of copies that may still run
    try:
        for batch in it:
            buf.append(put(batch))
            if len(buf) == size:
                break
        while buf:
            out, event, pinned = buf.popleft()
            nxt = next(it, None)
            if nxt is not None:
                buf.append(put(nxt))
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for v in out.values():
                if torch.is_tensor(v):
                    v.record_stream(consumer)
            retired = [r for r in retired if not r[0].query()]
            retired.append((event, pinned))
            yield out
    finally:
        for event, _ in retired + [(e, p) for _, e, p in buf]:
            event.synchronize()
