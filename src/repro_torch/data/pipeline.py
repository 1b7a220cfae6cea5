"""Shard-aware data pipeline with futurized double-buffered prefetch
(``src/repro/data/pipeline.py`` on PyTorch).

The paper's partition benchmark (Fig. 4) pattern as a feature: host batch
construction and the host->device copy of batch i+1 overlap the device
compute of batch i, orchestrated through ``repro_torch.core`` futures on a
dedicated work queue.  A straggling producer is absorbed by the prefetch
depth.  On a card, each batch is pinned on the host and copied with
``non_blocking=True`` on the current stream of the producing thread (the
device's default stream), so the step that reads it is ordered after the
copy.  Under a device mesh (``shardings``) each batch key becomes a
``DTensor`` on its sharding.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.executor import get_runtime
from repro_torch.core.futures import Future

__all__ = ["Pipeline", "SyntheticTokens"]


class SyntheticTokens:
    """Deterministic synthetic LM batches, indexable for exact resume.

    batch(i) is a pure function of (seed, i), numpy arrays bit-equal to the
    reference's: after restart, resuming at cursor c reproduces the
    identical stream.
    """

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed

    def batch(self, index: int) -> "dict[str, np.ndarray]":
        rng = np.random.default_rng((self.seed, index))
        toks = rng.integers(
            0, self.vocab_size, size=(self.batch_size, self.seq_len + 1), dtype=np.int32
        )
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _to_device(v, device: "torch.device") -> "torch.Tensor":
    t = torch.as_tensor(np.ascontiguousarray(v))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Pipeline:
    """Futurized prefetching loader.

    ``get()`` returns the next device-resident batch (a dict of tensors on
    ``device``, the card unless the caller asks for another), while
    ``depth`` future batches are already in flight on the
    ``data-pipeline`` work queue.  ``shardings`` maps batch keys to
    ``distribution.sharding.NamedSharding``s: such a key is placed with
    ``distribute_tensor`` on its mesh, each rank slicing its shard out of
    its own copy of the batch (the source is a pure function of the index,
    so every rank builds the same one), with no communication on the
    prefetch thread.
    """

    def __init__(
        self,
        source,
        *,
        start: int = 0,
        depth: int = 2,
        shardings: "dict[str, Any] | None" = None,
        transform: "Optional[Callable]" = None,
        device="cuda",
    ):
        self.shardings = dict(shardings or {})
        self.source = source
        self.cursor = start
        self.depth = depth
        self.transform = transform
        self.device = torch.device(device)
        self._queue = get_runtime().queue("data-pipeline")
        self._inflight: "deque[tuple[int, Future]]" = deque()
        self._lock = threading.Lock()
        for _ in range(depth):
            self._issue()

    def _issue(self) -> None:
        idx = self.cursor
        self.cursor += 1

        def produce():
            host = self.source.batch(idx)
            if self.transform is not None:
                host = self.transform(host)
            out = {k: _to_device(v, self.device) for k, v in host.items()}
            for k, sh in self.shardings.items():
                out[k] = sh.distribute(out[k], src_data_rank=None)
            return out

        self._inflight.append((idx, self._queue.submit(produce)))

    def get(self) -> "tuple[int, dict]":
        """(index, device batch) — blocks only if prefetch fell behind."""
        with self._lock:
            idx, fut = self._inflight.popleft()
            self._issue()
        return idx, fut.get()

    def get_async(self) -> "tuple[int, Future]":
        with self._lock:
            idx, fut = self._inflight.popleft()
            self._issue()
        return idx, fut

    def state(self) -> dict:
        """Checkpointable cursor (first not-yet-consumed index)."""
        with self._lock:
            first_inflight = self._inflight[0][0] if self._inflight else self.cursor
        return {"cursor": first_inflight}

    def close(self) -> None:
        """Tear down prefetch: stop issuing and settle every in-flight
        batch (producer failures are swallowed — the pipeline is going
        away).  Safe to call more than once; ``get()`` after close raises
        from the empty deque."""
        with self._lock:
            inflight, self._inflight = list(self._inflight), deque()
        for _, fut in inflight:
            try:
                fut.wait()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass
