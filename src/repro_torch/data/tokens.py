"""Synthetic LM token batches from a numpy seed.

Port of ``repro/data/tokens.py::_synth_batch`` (the trainer's prefetching
``token_pipeline`` comes with the training slice).
"""
from __future__ import annotations

import numpy as np


def _synth_batch(rng, batch: int, seq: int, vocab: int):
    # markov-ish stream: cheap but non-uniform (exercises the softmax)
    base = rng.integers(0, vocab, size=(batch, 1), dtype=np.int32)
    steps = rng.integers(-32, 33, size=(batch, seq), dtype=np.int32)
    toks = (base + np.cumsum(steps, axis=1)) % vocab
    return toks.astype(np.int32)
