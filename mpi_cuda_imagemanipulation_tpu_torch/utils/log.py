"""Logging and the JSON metrics line. The counterpart of the JAX package's
``utils/log.py``.

Verbosity comes from ``MCIM_LOG_LEVEL`` (a level name or number:
``DEBUG``..``CRITICAL`` or ``10``..``50``; default INFO), read when
`get_logger` first sets the logger up.

`get_logger` returns a `logging.LoggerAdapter` that prefixes each message
with the calling thread's active trace id (``[<trace_id>]``,
obs/trace.py) where there is one, so log lines join ``run --trace-out``
spans by grep; and WARNING+ lines also go to the flight recorder's ring
(obs/recorder.py), so a post-mortem dump carries them.
"""

from __future__ import annotations

import json
import logging
import sys

from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

_FORMAT = "%(asctime)s %(levelname)s %(name)s :: %(message)s"

ENV_LEVEL = "MCIM_LOG_LEVEL"


def _level_from_env(default: int = logging.INFO) -> int:
    raw = (env_registry.get(ENV_LEVEL) or "").strip()
    if not raw:
        return default
    if raw.isdigit():
        return int(raw)
    level = logging.getLevelName(raw.upper())
    return level if isinstance(level, int) else default


class _RecorderHandler(logging.Handler):
    """WARNING+ log lines feed the flight recorder's ring (obs/recorder),
    so a post-mortem dump carries the process's recent warnings next to
    its span and failpoint entries. A failure here never breaks logging."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder

            recorder.note("log", level=record.levelname, msg=record.getMessage()[:300])
        except Exception:  # a broken ring must never kill logging
            pass


class TraceAdapter(logging.LoggerAdapter):
    """Prefixes messages with the active trace id, the log/trace join key.
    Untraced, the lookup is one contextvar read."""

    def process(self, msg, kwargs):
        from mpi_cuda_imagemanipulation_tpu_torch.obs.trace import current_trace_id

        tid = current_trace_id()
        if tid:
            msg = f"[{tid}] {msg}"
        return msg, kwargs


def get_logger(name: str = "mcim_torch", level: int | None = None) -> logging.LoggerAdapter:
    """The shared logger, to stderr and (WARNING+) the flight recorder,
    trace-aware. `level` overrides MCIM_LOG_LEVEL; both override the INFO
    default. The handlers are set up once."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.addHandler(_RecorderHandler(level=logging.WARNING))
        logger.setLevel(level if level is not None else _level_from_env())
        logger.propagate = False
    elif level is not None:
        logger.setLevel(level)
    return TraceAdapter(logger, {})


def emit_json_metrics(record: dict, path: str | None = None) -> str:
    """`record` as one JSON line, appended to `path`, or printed to stdout
    when `path` is None or '-'. Returns the line."""
    line = json.dumps(record, sort_keys=True)
    if path and path != "-":
        with open(path, "a") as f:
            f.write(line + "\n")
    else:
        print(line)
    return line
