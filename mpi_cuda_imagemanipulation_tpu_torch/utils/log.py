"""Logging and the JSON metrics line. The counterpart of the JAX package's
``utils/log.py``.

Verbosity comes from ``MCIM_LOG_LEVEL`` (a level name or number:
``DEBUG``..``CRITICAL`` or ``10``..``50``; default INFO), read when
`get_logger` first sets the logger up. The JAX package's flight-recorder
handler and trace-id prefix wait for the port's ``obs/``.
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


def get_logger(name: str = "mcim_torch", level: int | None = None) -> logging.Logger:
    """The shared logger, to stderr. `level` overrides MCIM_LOG_LEVEL; both
    override the INFO default. The handler is set up once."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(level if level is not None else _level_from_env())
        logger.propagate = False
    elif level is not None:
        logger.setLevel(level)
    return logger


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
