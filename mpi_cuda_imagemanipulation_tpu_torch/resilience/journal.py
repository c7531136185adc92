"""Batch journal: append-only JSONL that makes `batch --resume` possible.
The counterpart of the JAX package's ``resilience/journal.py``, with the
same schema, for the port's batch command to come.

A batch that restarts from scratch after a crash wastes every finished
input. The journal records one line per *finished* input
(output written, or decode/compute failure) so a resumed run skips work
that is provably done and re-attempts only failures and never-reached
inputs.

Record schema (one JSON object per line):

    {"input": "<path relative to input dir>",
     "digest": "<sha256 of the input file bytes, hex>",
     "status": "ok" | "failed",
     "output": "<path relative to output dir>",   (ok only)
     "error": "<message>",                        (failed only)
     "t_unix_s": <float>}

Resume trusts a record only when status == "ok" AND the stored digest
matches the input's current content — an input edited after the crash is
reprocessed, never served stale. Later lines win (a re-run of a failure
appends its new outcome; nothing is ever rewritten in place), and a
truncated final line from a mid-write kill is skipped, not fatal. Each
append is flushed + fsync'd: a journal that can lose acknowledged lines
would make --resume silently drop outputs.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time

DEFAULT_NAME = ".mcim_batch_journal.jsonl"


def content_digest(path: str | os.PathLike) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class BatchJournal:
    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        # appends may come from the engine's encode workers concurrently
        # (cli.py cmd_batch); the torn-line repair + write must not
        # interleave between threads of one process
        self._lock = threading.Lock()

    def load(self) -> dict[str, dict]:
        """input-relpath -> last record. Tolerates a missing file and a
        torn trailing line (crash mid-append)."""
        records: dict[str, dict] = {}
        try:
            f = open(self.path, encoding="utf-8")
        except FileNotFoundError:
            return records
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn write from a mid-append kill
                if isinstance(rec, dict) and "input" in rec:
                    records[rec["input"]] = rec
        return records

    def _append(self, rec: dict) -> None:
        line = json.dumps(rec, sort_keys=True)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with self._lock, open(self.path, "a+", encoding="utf-8") as f:
            # a torn line from a mid-write kill must only lose ITSELF: if
            # the file doesn't end in a newline, terminate the torn line
            # first so this record starts fresh and stays parseable
            f.seek(0, os.SEEK_END)
            if f.tell() > 0:
                f.seek(f.tell() - 1)
                if f.read(1) != "\n":
                    f.write("\n")
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    def record_ok(self, input_rel: str, digest: str, output_rel: str) -> None:
        self._append(
            {
                "input": input_rel,
                "digest": digest,
                "status": "ok",
                "output": output_rel,
                "t_unix_s": time.time(),
            }
        )

    def record_failed(self, input_rel: str, digest: str | None, error: str) -> None:
        self._append(
            {
                "input": input_rel,
                "digest": digest,
                "status": "failed",
                "error": error,
                "t_unix_s": time.time(),
            }
        )

    def completed(self, input_rel: str, path: str | os.PathLike) -> bool:
        """Is this input journaled ok with a digest matching its current
        bytes? (Per-call load keeps the API stateless; cmd_batch loads
        once up front instead.)"""
        rec = self.load().get(input_rel)
        return bool(
            rec
            and rec.get("status") == "ok"
            and rec.get("digest") == content_digest(path)
        )
