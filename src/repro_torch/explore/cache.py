"""Persistent evaluation cache for the mapping auto-tuner.

Every measured evaluation is stored under the canonical config hash
(:meth:`repro_torch.explore.space.MappingConfig.key` scoped by target + machine +
mode), so re-running the same search — the ``ci.sh`` smoke refresh, an
interrupted sweep, a second target sharing configs — pays only for configs
it has never simulated.  Failures (deadlocks, placement overflows) are
cached too: a config known to deadlock is not re-simulated.

The store is a single JSON file, loaded eagerly and written atomically
(tmp + rename), so a crashed search never corrupts it.  A schema bump
invalidates old files wholesale — entries are measurements, never worth a
migration.
"""
from __future__ import annotations

import json
import os
import tempfile

SCHEMA = "explore-cache/v1"


class EvalCache:
    """Dict-like JSON-backed store: canonical config hash -> eval record."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = os.fspath(path) if path is not None else None
        self.data: dict[str, dict] = {}
        self.hits = 0
        self.misses = 0
        self.failure_hits = 0           # replayed known-bad configs (free)
        if self.path and os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    raw = json.load(f)
                if raw.get("schema") == SCHEMA:
                    self.data = dict(raw.get("entries", {}))
            except (OSError, ValueError):
                self.data = {}          # unreadable cache = empty cache

    def get(self, key: str) -> dict | None:
        ent = self.data.get(key)
        if ent is None:
            self.misses += 1
        else:
            self.hits += 1
            if "failed" in ent:
                self.failure_hits += 1
        return ent

    def put(self, key: str, value: dict) -> None:
        self.data[key] = value

    def stats(self) -> dict:
        """Hit/miss accounting for this process (the persistent store only
        grows; ``entries`` is its current size)."""
        return {"hits": self.hits, "misses": self.misses,
                "failures_replayed": self.failure_hits,
                "entries": len(self.data)}

    def save(self) -> None:
        if not self.path:
            return
        payload = {"schema": SCHEMA, "entries": self.data}
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".explore_cache.", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __len__(self) -> int:
        return len(self.data)
