"""Tuning cache (subset of ``repro.core.cache``).

An in-process ``TuningCache`` keyed by (kernel name, kernel version, space
hash, context signature). Given a ``cache_dir`` it also persists to
``tuning_db.json`` there (atomic replace); point it at a git-ignored
directory. Every entry records the environment it was measured in — the
card's name, the NVIDIA driver version, CUDA, ``torch`` and ``triton``.

Given an ``overlay_path`` it also reads a read-only overlay, the shipped
tuning DB (``configs/shipped_tuning_db.json``): a lookup takes the
process's own entry first, then the overlay's, and ``put`` never writes
the overlay. The two follow different environment rules:

  * an entry the process tuned (or loaded from ``cache_dir``) is a hit
    only in the environment it was measured in — every fingerprint field
    the lookup names must match, so a lookup from another driver, CUDA,
    ``torch`` or ``triton`` is a miss, never a silent reuse;
  * an overlay entry is a hit on the card it was tuned on and by the same
    backend, as the reference matches its shipped entries: the card's
    name is in the key (the context's chip), and of the fingerprint only
    ``OVERLAY_MATCH`` must match. Its versions stay in the entry as a
    record of where it was tuned; a driver or ``torch`` update does not
    turn the whole DB cold.

Either way the stored config must still be valid for the context.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.metadata
import json
import math
import os
import subprocess
import tempfile
import threading
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.core.config_space import Config, ConfigSpace, TuningContext

_DB_BASENAME = "tuning_db.json"

# The fingerprint fields an overlay entry must match (the card is the key's).
OVERLAY_MATCH = ("backend",)


@functools.lru_cache(maxsize=1)
def _gpu_identity() -> Dict[str, str]:
    if not torch.cuda.is_available():
        return {"gpu": "none", "driver": "none"}
    driver = "unknown"
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=driver_version",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        if res.returncode == 0 and res.stdout.strip():
            driver = res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"gpu": torch.cuda.get_device_name(0), "driver": driver}


def _package_version(name: str) -> str:
    try:
        return importlib.metadata.version(name)
    except importlib.metadata.PackageNotFoundError:
        return "none"


def env_fingerprint(backend_name: str) -> Dict[str, str]:
    return {**_gpu_identity(),
            "cuda": str(torch.version.cuda),
            "torch": torch.__version__,
            "triton": _package_version("triton"),
            "backend": backend_name,
            "schema": "1"}


@dataclasses.dataclass
class CacheEntry:
    config: Config
    metric: float            # seconds per call of the winner; inf = failed
    n_evaluated: int
    strategy: str
    fingerprint: Dict[str, str]
    timestamp: float
    measure_s: float = 0.0   # wall seconds the search took

    def failed(self) -> bool:
        return not math.isfinite(self.metric)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "CacheEntry":
        return CacheEntry(
            config=dict(d["config"]), metric=float(d["metric"]),
            n_evaluated=int(d["n_evaluated"]), strategy=str(d["strategy"]),
            fingerprint=dict(d["fingerprint"]),
            timestamp=float(d["timestamp"]),
            measure_s=float(d.get("measure_s", 0.0)))


def cache_key(kernel_name: str, kernel_version: int, space: ConfigSpace,
              ctx: TuningContext) -> str:
    return json.dumps({"kernel": kernel_name,
                       "kernel_version": kernel_version,
                       "space": space.space_hash(),
                       "ctx": ctx.signature()}, sort_keys=True)


class TuningCache:
    """key -> CacheEntry, in process; persisted when ``cache_dir`` is set;
    over a read-only overlay when ``overlay_path`` names a file."""

    def __init__(self, cache_dir: Optional[str] = None,
                 overlay_path: Optional[str] = None):
        self.cache_dir = cache_dir
        self._lock = threading.Lock()
        self._db: Dict[str, Dict[str, Any]] = {}
        self._overlay: Dict[str, Dict[str, Any]] = {}
        if cache_dir is not None:
            try:
                with open(os.path.join(cache_dir, _DB_BASENAME)) as f:
                    self._db = json.load(f)
            except FileNotFoundError:
                pass
        if overlay_path is not None and os.path.exists(overlay_path):
            with open(overlay_path) as f:
                self._overlay = json.load(f)

    def _flush(self) -> None:
        os.makedirs(self.cache_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._db, f, indent=1, sort_keys=True)
            os.replace(tmp, os.path.join(self.cache_dir, _DB_BASENAME))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, kernel_name: str, kernel_version: int, space: ConfigSpace,
            ctx: TuningContext, *,
            require_fingerprint: Optional[Dict[str, str]] = None
            ) -> Optional[CacheEntry]:
        """The entry for this scenario: the process's own if it matches
        every field of ``require_fingerprint``, else the overlay's if it
        matches the ``OVERLAY_MATCH`` fields; None when neither does, or
        when the config no longer fits the space."""
        key = cache_key(kernel_name, kernel_version, space, ctx)
        need = require_fingerprint or {}
        with self._lock:
            found = [(self._db.get(key), need),
                     (self._overlay.get(key),
                      {k: v for k, v in need.items() if k in OVERLAY_MATCH})]
        for raw, fields in found:
            if raw is None:
                continue
            entry = CacheEntry.from_json(raw)
            if any(entry.fingerprint.get(k) != v for k, v in fields.items()):
                continue
            if space.is_valid(entry.config, ctx):
                return entry
        return None

    def put(self, kernel_name: str, kernel_version: int, space: ConfigSpace,
            ctx: TuningContext, entry: CacheEntry) -> None:
        key = cache_key(kernel_name, kernel_version, space, ctx)
        with self._lock:
            self._db[key] = entry.to_json()
            if self.cache_dir is not None:
                self._flush()

    def __len__(self) -> int:
        with self._lock:
            return len(self._db)

    def items(self):
        """(key fields, entry) for every scenario the process stored (the
        overlay's are not among them)."""
        with self._lock:
            raw = dict(self._db)
        return [(json.loads(k), CacheEntry.from_json(v))
                for k, v in raw.items()]

    def entries(self) -> Dict[str, CacheEntry]:
        """key -> entry over the overlay and the process's own entries, its
        own where both hold a key."""
        with self._lock:
            raw = {**self._overlay, **self._db}
        return {k: CacheEntry.from_json(v) for k, v in raw.items()}


def make_entry(config: Config, metric: float, n_evaluated: int,
               strategy: str, backend_name: str,
               measure_s: float = 0.0) -> CacheEntry:
    return CacheEntry(config=dict(config), metric=float(metric),
                      n_evaluated=int(n_evaluated), strategy=strategy,
                      fingerprint=env_fingerprint(backend_name),
                      timestamp=time.time(), measure_s=float(measure_s))
