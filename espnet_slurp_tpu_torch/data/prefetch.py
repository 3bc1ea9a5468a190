"""Background batch prefetching: overlap host-side IO with device steps.
Port of espnet_slurp_tpu/data/prefetch.py (``prefetch_iter`` and
``prefetch_factory`` are copies; ``prefetch_to_device`` copies through
pinned host memory to an explicit device).

Parity target: the reference's DataLoader worker processes
(abs_task.py num_workers; SURVEY §3.1 'DataLoader worker procs'). Here the
audio decode is already native C++ threads (native/wavio.cpp), so a single
Python producer thread with a bounded queue suffices to hide collation +
decode behind the device step — the step's kernels run asynchronously on
the card while the producer thread works, so the two genuinely overlap.

Usage: wrap any iter factory —

    train_if = prefetch_factory(train_if, depth=2)
    trainer.run(state, train_if, valid_if)
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable

import numpy as np

_END = object()


def prefetch_iter(it: Iterable, depth: int = 2):
    """Iterate ``it`` on a daemon producer thread, ``depth`` batches ahead.

    Exceptions in the producer re-raise at the consumer's next pull, so
    failures keep their stack context instead of vanishing in a thread.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    err = []

    def produce():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            if err:
                raise err[0]
            return
        yield item


def prefetch_factory(factory: Callable[[int], Iterable],
                     depth: int = 2) -> Callable[[int], Iterable]:
    """Wrap an epoch-indexed iter factory with background prefetching."""
    def wrapped(epoch: int):
        return prefetch_iter(factory(epoch), depth)
    return wrapped


def to_device(batch, device):
    """A numpy batch {name: array} as tensors on ``device``: for a CUDA
    device each array is copied once into pinned host memory and sent with
    a ``non_blocking`` copy, so the transfer overlaps what the device is
    running (the reference's pin_memory + non_blocking copy). A value that
    is already a tensor (a device-resident speech batch) is moved, or kept
    where it is."""
    import torch
    device = torch.device(device)
    pin = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device, non_blocking=True)
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if pin:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=pin)
    return out


def prefetch_to_device(it: Iterable, device):
    """prefetch_iter + ``to_device``: batches are decoded, collated AND
    issued to ``device`` two steps ahead on the producer thread, so the
    host->device copy overlaps the previous device step.

    Yields {name: tensor on device}.
    """
    return prefetch_iter((to_device(b, device) for b in it), depth=2)
