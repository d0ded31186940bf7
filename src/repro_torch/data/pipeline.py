"""Token data pipeline: synthetic + file-backed sources, document packing,
data-parallel sharded iteration.

The port's own copy of ``repro.data.pipeline`` (numpy only, batch for
batch the same tokens), so that the port imports nothing of the reference.

At 1000+ node scale each host reads only its slice (host_id/host_count);
``global_batch`` below is the per-step global batch — the loader yields the
full global arrays here (single-host container) but slices by host in
multi-host settings, matching a per-host loader's usage.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    pack: bool = True
    source: str = "synthetic"       # synthetic | file
    path: Optional[str] = None      # token .bin (uint16/uint32) for "file"
    host_id: int = 0
    host_count: int = 1


class _SyntheticDocs:
    """Deterministic zipf-ish documents: reproducible across restarts
    (resume-safe: stream position is (seed, step))."""

    def __init__(self, cfg: DataConfig, step0: int = 0):
        self.cfg = cfg
        self.step = step0

    def docs(self, rng: np.random.Generator) -> Iterator[np.ndarray]:
        V = self.cfg.vocab_size
        # Zipf over the vocab, shifted off the EOS id.
        ranks = np.arange(1, V)
        probs = 1.0 / ranks ** 1.1
        probs /= probs.sum()
        while True:
            n = int(rng.integers(8, max(self.cfg.seq_len, 9)))
            yield rng.choice(ranks, size=n, p=probs).astype(np.int32)


class TokenStream:
    def __init__(self, cfg: DataConfig, step0: int = 0):
        self.cfg = cfg
        self.step = step0
        if cfg.source == "file":
            raw = np.memmap(cfg.path, dtype=np.uint16, mode="r")
            self._file = raw
        else:
            self._file = None

    def _batch_rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed, step, self.cfg.host_id))

    def _pack_batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = self._batch_rng(step)
        rows = cfg.global_batch // cfg.host_count
        out = np.full((rows, cfg.seq_len + 1), cfg.eos_id, np.int32)
        if self._file is not None:
            total = len(self._file) - (cfg.seq_len + 1)
            starts = rng.integers(0, total, size=rows)
            for i, s in enumerate(starts):
                out[i] = self._file[s:s + cfg.seq_len + 1]
            return out
        gen = _SyntheticDocs(cfg).docs(rng)
        for i in range(rows):
            pos = 0
            while pos < cfg.seq_len + 1:
                doc = next(gen)
                take = min(len(doc), cfg.seq_len + 1 - pos)
                out[i, pos:pos + take] = doc[:take]
                pos += take + 1          # EOS gap between docs
                if not cfg.pack:
                    break
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            seq = self._pack_batch(self.step)
            self.step += 1
            yield {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def state(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.cfg.seed}

    def restore(self, state: Dict[str, int]) -> None:
        self.step = int(state["step"])
