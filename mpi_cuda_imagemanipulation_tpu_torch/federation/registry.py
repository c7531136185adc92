"""Durable tenant/spec registry — the federation state that must
survive a full restart.

The counterpart of the JAX package's ``federation/registry.py``: the same
journal, line for line, for the same writes.

A pod router holds tenant configs and pipeline specs only in memory: a
pod restart is recovered by the front door re-pushing stored state
before the first forward. But if the FRONT DOOR restarts, that stored
state must come from somewhere other than client re-registration — so
every accepted registration (tenant config, pipeline spec, session
binding) is appended here first, in the BatchJournal style
(resilience/journal.py): append-only JSONL, one record per line,
flush + fsync per append, a torn trailing line from a mid-write kill
terminated on the next append and skipped on load, later lines winning.

Record schema (one JSON object per line):

    {"kind": "tenant" | "pipeline" | "session",
     "key": "<tenant id>" | "<tenant>/<pipeline id>" | "<session id>",
     "payload": {...} | null,          (null = tombstone)
     "t_unix_s": <float>}

Re-appending an identical record is harmless (idempotent re-push is a
registration API guarantee, and load keeps only the last record per
(kind, key)), and a tombstone (payload null) deletes on replay.
"""

from __future__ import annotations

import json
import os
import threading
import time

KINDS = ("tenant", "pipeline", "session")

DEFAULT_NAME = ".mcim_fed_registry.jsonl"


class DurableRegistry:
    """The front door's fsync'd state journal + its in-memory view.

    `load()` replays the file into the in-memory maps; `put()`/`delete()`
    append THEN update memory, so an acknowledged registration is on
    disk before any client sees a 200 — a front-door crash between the
    two loses nothing a client was told succeeded."""

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self._lock = threading.Lock()
        # kind -> key -> payload (the replayed later-lines-win view)
        self._state: dict[str, dict[str, dict]] = {k: {} for k in KINDS}
        self.loaded_records = 0
        self.skipped_lines = 0  # torn/corrupt lines tolerated on load

    # -- load (replay) -----------------------------------------------------

    def load(self) -> "DurableRegistry":
        """Replay the journal into memory. Tolerates a missing file, torn
        trailing line, and corrupt interior lines (each skipped line is
        counted, never fatal — a registry that refuses to start over one
        bad line turns a crash into an outage)."""
        state: dict[str, dict[str, dict]] = {k: {} for k in KINDS}
        loaded = skipped = 0
        try:
            f = open(self.path, encoding="utf-8")
        except FileNotFoundError:
            f = None
        if f is not None:
            with f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        skipped += 1  # torn write from a mid-append kill
                        continue
                    if (
                        not isinstance(rec, dict)
                        or rec.get("kind") not in KINDS
                        or not isinstance(rec.get("key"), str)
                    ):
                        skipped += 1
                        continue
                    payload = rec.get("payload")
                    if payload is None:
                        state[rec["kind"]].pop(rec["key"], None)
                    else:
                        state[rec["kind"]][rec["key"]] = payload
                    loaded += 1
        with self._lock:
            self._state = state
            self.loaded_records = loaded
            self.skipped_lines = skipped
        return self

    # -- append ------------------------------------------------------------

    def _append(self, rec: dict) -> None:
        line = json.dumps(rec, sort_keys=True)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a+", encoding="utf-8") as f:
            # a torn line from a mid-write kill must only lose ITSELF:
            # terminate an unterminated final line so this record starts
            # fresh and stays parseable (resilience/journal.py idiom)
            f.seek(0, os.SEEK_END)
            if f.tell() > 0:
                f.seek(f.tell() - 1)
                if f.read(1) != "\n":
                    f.write("\n")
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    def put(self, kind: str, key: str, payload: dict) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown record kind {kind!r}")
        with self._lock:
            self._append(
                {
                    "kind": kind,
                    "key": key,
                    "payload": payload,
                    "t_unix_s": time.time(),
                }
            )
            self._state[kind][key] = payload

    def delete(self, kind: str, key: str) -> None:
        """Append a tombstone (payload null) and drop the key."""
        if kind not in KINDS:
            raise ValueError(f"unknown record kind {kind!r}")
        with self._lock:
            self._append(
                {
                    "kind": kind,
                    "key": key,
                    "payload": None,
                    "t_unix_s": time.time(),
                }
            )
            self._state[kind].pop(key, None)

    # -- views -------------------------------------------------------------

    def get(self, kind: str, key: str) -> dict | None:
        with self._lock:
            return self._state[kind].get(key)

    def items(self, kind: str) -> dict[str, dict]:
        with self._lock:
            return dict(self._state[kind])

    def counts(self) -> dict[str, int]:
        with self._lock:
            return {k: len(v) for k, v in self._state.items()}
