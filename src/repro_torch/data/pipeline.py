"""Token data pipeline: synthetic corpus, sharded host loading, prefetch.

The corpus is a deterministic synthetic language (Zipfian unigrams mixed
with repeated n-gram 'phrases') so LM training has learnable structure
without external data. Each host loads only its shard (host_id, n_hosts);
a background thread keeps `prefetch` batches ready so device steps never
wait on host-side generation — the straggler monitor's data-skip path
pulls from this buffer.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticCorpus:
    """Deterministic pseudo-text: Zipf unigrams + phrase bank repetitions."""

    def __init__(self, vocab: int, seed: int = 0, n_phrases: int = 512, phrase_len: int = 8):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        probs = 1.0 / ranks**1.1
        self.probs = probs / probs.sum()
        self.phrases = rng.integers(0, vocab, size=(n_phrases, phrase_len))
        self.seed = seed

    def tokens(self, n: int, stream_seed: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, stream_seed))
        out = np.empty(n, np.int32)
        i = 0
        while i < n:
            if rng.random() < 0.3:  # drop in a phrase (learnable structure)
                ph = self.phrases[rng.integers(0, len(self.phrases))]
                m = min(len(ph), n - i)
                out[i : i + m] = ph[:m]
                i += m
            else:
                m = min(int(rng.integers(4, 32)), n - i)
                out[i : i + m] = rng.choice(self.vocab, size=m, p=self.probs)
                i += m
        return out


class TokenLoader:
    """Sharded batch iterator with background prefetch."""

    def __init__(
        self,
        vocab: int,
        batch_size: int,
        seq_len: int,
        *,
        host_id: int = 0,
        n_hosts: int = 1,
        seed: int = 0,
        prefetch: int = 2,
        extras: Optional[Dict] = None,
    ):
        assert batch_size % n_hosts == 0, "global batch must divide hosts"
        self.local_batch = batch_size // n_hosts
        self.seq_len = seq_len
        self.corpus = SyntheticCorpus(vocab, seed)
        self.host_id = host_id
        self.extras = extras or {}
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._counter = 0
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _make_batch(self, step: int) -> Dict[str, np.ndarray]:
        toks = np.stack(
            [
                self.corpus.tokens(
                    self.seq_len, stream_seed=step * 100003 + self.host_id * 131 + b
                )
                for b in range(self.local_batch)
            ]
        )
        batch = {"tokens": toks, "loss_mask": np.ones_like(toks, np.float32)}
        batch.update({k: f(self.local_batch, self.seq_len) for k, f in self.extras.items()})
        return batch

    def _produce(self):
        step = 0
        while not self._stop.is_set():
            try:
                self._q.put(self._make_batch(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
