"""LM token pipeline: a deterministic synthetic corpus with prefetch.

Port of ``repro/data/tokens.py``: ``_synth_batch`` (a seeded markov-ish
stream) and ``token_pipeline``, an iterator of (tokens, targets) batches
whose host batches a producer thread makes ahead of the consumer.  The same
seed gives the same integers as the JAX generator.  The producer starts at
the first batch and stops when the iterator is closed or collected.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.backend import resolve_device


def _synth_batch(rng, batch: int, seq: int, vocab: int):
    # markov-ish stream: cheap but non-uniform (exercises the softmax)
    base = rng.integers(0, vocab, size=(batch, 1), dtype=np.int32)
    steps = rng.integers(-32, 33, size=(batch, seq), dtype=np.int32)
    toks = (base + np.cumsum(steps, axis=1)) % vocab
    return toks.astype(np.int32)


def token_pipeline(*, batch: int, seq: int, vocab: int, seed: int = 0,
                   device=None, prefetch: int = 2) -> Iterator:
    """Yields (tokens, targets) forever, each (batch, seq) int32 on
    ``device`` (default ``cuda``); targets are the next-token shift of one
    (batch, seq + 1) draw."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        while not stop.is_set():
            toks = _synth_batch(rng, batch, seq + 1, vocab)
            while not stop.is_set():
                try:
                    q.put(toks, timeout=0.1)
                    break
                except queue.Full:
                    continue

    th = threading.Thread(target=producer, daemon=True,
                          name="token_pipeline")
    th.start()
    try:
        while True:
            toks = torch.from_numpy(q.get())
            yield (toks[:, :-1].contiguous().to(dev),
                   toks[:, 1:].contiguous().to(dev))
    finally:
        stop.set()
        th.join()
