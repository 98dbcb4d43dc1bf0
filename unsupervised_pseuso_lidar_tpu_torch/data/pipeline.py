"""Host-async prefetching: overlap batch making with the card's work.

Counterpart of unsupervised_pseuso_lidar_tpu/data/pipeline.py
(prefetch_to_device :57-106). A background thread takes host batches from
the iterator and turns their arrays into tensors — in page-locked (pinned)
memory when the device is a CUDA card — into a bounded queue. The copy to
the device happens on the CONSUMER's side, as a non-blocking copy on its
current stream: the step that uses the batch is queued behind the copy on
the same stream, so no event or side-stream synchronization is needed,
and the host does not wait for it. (A copy on a side stream that the step
does not wait for would race the step.) The caching host allocator keeps a
pinned buffer alive until the copy that reads it has finished.

Under a data mesh the producer takes this rank's rows of each batch
(parallel/mesh.shard_batch) BEFORE the pinned copy, so a rank copies
only its own rows.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import Mesh, ShardedBatch, shard_batch
from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device


def _host_tensors(batch: Dict[str, Any], pin: bool) -> Dict[str, torch.Tensor]:
    out = {}
    for key, value in batch.items():
        t = value if torch.is_tensor(value) else torch.from_numpy(np.ascontiguousarray(value))
        out[key] = t.pin_memory() if pin else t
    return out


def prefetch_to_device(
    batch_iter: Iterator[Dict[str, Any]],
    size: int = 2,
    device: str | torch.device = "cuda",
    mesh: Optional[Mesh] = None,
    accum_steps: int = 1,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches of `batch_iter` (dicts of numpy arrays or tensors)
    as tensors on `device`, made `size` batches ahead by a daemon thread.
    A loader error is raised in the consumer.

    Under a data `mesh` (the JAX CLI's device_put=partial(shard_batch,
    mesh)) the producer keeps this rank's rows (shard_batch with the
    step's accum_steps) and the batches come out as ShardedBatch."""
    device = resolve_device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    error: list = []

    def producer():
        try:
            for batch in batch_iter:
                if mesh is not None:
                    batch = shard_batch(mesh, batch, accum_steps)
                tensors = _host_tensors(batch, pin)
                if isinstance(batch, ShardedBatch):
                    tensors = batch.with_values(tensors)
                q.put(tensors)
        except BaseException as exc:  # re-raised in the consumer
            error.append(exc)
        finally:
            q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if error:
                raise error[0]
            return
        out = {k: v.to(device, non_blocking=True) for k, v in item.items()}
        yield item.with_values(out) if isinstance(item, ShardedBatch) else out
