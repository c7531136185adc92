"""The calibration store: measured routing records per device kind. The
counterpart of the JAX package's ``utils/calibration.py``, with the same
file, schema and path resolution, so that both packages read one store.

``python -m mpi_cuda_imagemanipulation_tpu_torch autotune`` measures the
routes a choice could take on the card and records the fastest here,
keyed by the device kind (utils/platform.device_kind, e.g. ``"NVIDIA H100
80GB HBM3"``). The ``auto`` routes then follow the records:

  * ``block_h`` per impl (``"cuda"``: K2's tile height; ``"swar"``: the
    SWAR kernels' K6-K8): the default tile height where the caller gives
    none, for launches on as many channels as the record was taken on, and
    only where it fits the shared memory and the grid
    (ops/cuda_kernels.stencil_launch_shape, ops/swar_kernels
    .swar_tile_shape), so a stale record may cost time but never fails a
    launch;
  * ``backend_choice`` per banded family (``vpu``, ``mxu``, ``hybrid``):
    ``backend='auto'`` sends a stencil to the banded products only behind
    a record (ops/mxu_kernels.use_mxu_for_stencil);
  * ``stage_arm`` per banded family (``vpu``, ``mxu``, ``mxu-int8``): the
    in-stage arm of K4 under the setting 'auto' (stage_arm_for);
  * ``plan_choice`` per pipeline fingerprint: what ``plan='auto'``
    resolves to (plan/planner.resolve_plan_mode).

A record applies within a factor of two of the width it was taken at. The
port ships no records: the tables are filled only by ``autotune`` runs,
and a record under a TPU's kind, written by the JAX package into a shared
store, never steers the card.

The store is one JSON file: ``$MCIM_CALIB_FILE`` if set, else
``.mcim_calibration.json`` in the current directory. ``MCIM_NO_CALIB``
(any non-empty value) turns every lookup off; ``autotune`` sets it for its
sweep. Reads are cached on the file's path and mtime; writes replace the
file atomically (a temporary file, then a rename). Lookups stat the file,
so callers resolve them once per built function and image shape, never
per launch.
"""

from __future__ import annotations

import json
import os
import tempfile
import time as _time

from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
from mpi_cuda_imagemanipulation_tpu_torch.utils import platform

_ENV_FILE = "MCIM_CALIB_FILE"
_ENV_DISABLE = "MCIM_NO_CALIB"
_DEFAULT_NAME = ".mcim_calibration.json"

# (path, mtime_ns) -> parsed dict: a same-process autotune -> run sequence
# stays coherent without an invalidation hook
_cache: dict = {"key": None, "data": None}


def calib_path() -> str:
    return env_registry.get(_ENV_FILE) or os.path.join(os.getcwd(), _DEFAULT_NAME)


def _load() -> dict:
    path = calib_path()
    try:
        key = (path, os.stat(path).st_mtime_ns)
    except OSError:
        return {}
    if _cache["key"] == key:
        return _cache["data"]
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict):
            data = {}
    except (OSError, ValueError):
        data = {}  # a corrupt store never breaks a run; autotune rewrites it whole
    _cache["key"] = key
    _cache["data"] = data
    return data


def entries() -> dict:
    """Every entry, ``{device_kind: {impl or table: record}}``; {} when there
    is no store."""
    e = _load().get("device_kinds")
    return e if isinstance(e, dict) else {}


def current_device_kind(device=None) -> str:
    """The device kind of `device` (None: the current CUDA device where
    there is one, else the CPU): utils/platform.device_kind."""
    if device is None and not platform.is_cuda_device(None):
        device = "cpu"
    return platform.device_kind(device)


def _in_window(rec: dict, width: int | None) -> bool:
    """A record taken at width w applies to widths in [w / 2, 2 w]; one
    with no width, and a caller with none, to all."""
    rec_w = rec.get("width")
    return (
        width is None
        or not isinstance(rec_w, (int, float))
        or rec_w <= 0
        or rec_w / 2 <= width <= rec_w * 2
    )


def _kind_entries(device_kind: str | None) -> dict | None:
    if env_registry.get(_ENV_DISABLE):
        return None
    if device_kind is None:
        device_kind = current_device_kind()
    rec = entries().get(device_kind)
    return rec if isinstance(rec, dict) else None


def _table_entry(table: str, key, device_kind, width) -> dict | None:
    """The width-filtered entry `key` of the kind's `table`, or None."""
    if key is None:
        return None
    rec = _kind_entries(device_kind)
    tab = rec.get(table) if rec is not None else None
    ent = tab.get(key) if isinstance(tab, dict) else None
    return ent if isinstance(ent, dict) and _in_window(ent, width) else None


def block_entry(
    device_kind: str | None = None, impl: str = "cuda", width: int | None = None
) -> dict | None:
    """The whole block_h record of `impl` ('cuda': K2; 'swar': K6-K8) for
    the device kind (block_h, and the channels and width it was taken at),
    if one applies at `width` and its height is in range."""
    rec = _kind_entries(device_kind)
    rec = rec.get(impl) if rec is not None else None
    if not isinstance(rec, dict) or not _in_window(rec, width):
        return None
    bh = rec.get("block_h")
    # 8 is the SWAR kernels' smallest tile; each picker checks its own fit
    return rec if isinstance(bh, int) and 8 <= bh <= 4096 else None


def lookup_block_h(
    device_kind: str | None = None, impl: str = "cuda", width: int | None = None
) -> int | None:
    """The recorded tile height of `impl` for the device kind, if a record
    applies at `width` (`block_entry`)."""
    rec = block_entry(device_kind, impl, width)
    return None if rec is None else rec["block_h"]


def _kind_record(device_kind: str) -> tuple[dict, dict]:
    """(the whole store, the device kind's record to mutate)."""
    data = _load()
    kinds = data.setdefault("device_kinds", {})
    kind_rec = kinds.setdefault(device_kind, {})
    if not isinstance(kind_rec, dict):  # a corrupt entry: replaced
        kind_rec = kinds[device_kind] = {}
    return data, kind_rec


def _write_store(data: dict) -> str:
    path = calib_path()
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", prefix=".mcim_calib_")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _cache["key"] = None
    return path


def record_block_h(device_kind: str, block_h: int, impl: str = "cuda", **extra) -> str:
    """Write or replace the (device kind, impl) tile height; returns the
    store's path. Other kinds' and impls' entries are kept."""
    data, kind_rec = _kind_record(device_kind)
    kind_rec[impl] = {"block_h": int(block_h), **extra}
    return _write_store(data)


def _record_choice(table: str, choices: tuple, device_kind: str, key: str, choice: str,
                   extra: dict) -> str:
    if choice not in choices:
        raise ValueError(f"unknown {table} {choice!r}; known: {choices}")
    data, kind_rec = _kind_record(device_kind)
    tab = kind_rec.setdefault(table, {})
    if not isinstance(tab, dict):  # a corrupt entry: replaced
        tab = kind_rec[table] = {}
    tab[key] = {"choice": choice, **extra}
    return _write_store(data)


def _lookup_choice(table: str, choices: tuple, key, device_kind, width) -> str | None:
    ent = _table_entry(table, key, device_kind, width)
    choice = ent.get("choice") if ent is not None else None
    return choice if choice in choices else None


# -- backend choice: the whole-op banded products against K1/K2 -------------

_BACKEND_KEY = "backend_choice"
BACKEND_CHOICES = ("vpu", "mxu", "hybrid")


def lookup_backend_choice(family: str | None, device_kind: str | None = None,
                          width: int | None = None) -> str | None:
    """The recorded route of a banded family ('vpu', 'mxu' or 'hybrid'), or
    None: the caller keeps its default route."""
    return _lookup_choice(_BACKEND_KEY, BACKEND_CHOICES, family, device_kind, width)


def record_backend_choice(device_kind: str, family: str, choice: str, **extra) -> str:
    return _record_choice(_BACKEND_KEY, BACKEND_CHOICES, device_kind, family, choice, extra)


# -- in-stage arm: K4's VPU arm against K5 in bf16 or int8 ------------------

_STAGE_KEY = "stage_arm"
STAGE_ARM_CHOICES = ("vpu", "mxu", "mxu-int8")


def lookup_stage_arm(family: str | None, device_kind: str | None = None,
                     width: int | None = None) -> str | None:
    """The recorded in-stage arm of a banded family, or None: K4 keeps the
    VPU arm."""
    return _lookup_choice(_STAGE_KEY, STAGE_ARM_CHOICES, family, device_kind, width)


def record_stage_arm(device_kind: str, family: str, choice: str, **extra) -> str:
    return _record_choice(_STAGE_KEY, STAGE_ARM_CHOICES, device_kind, family, choice, extra)


def stage_arm_entries(device_kind: str | None = None) -> dict:
    """The device kind's whole stage_arm table (family -> entry), {} when
    there is none."""
    rec = entries().get(current_device_kind() if device_kind is None else device_kind)
    table = rec.get(_STAGE_KEY) if isinstance(rec, dict) else None
    return table if isinstance(table, dict) else {}


# -- plan choice per pipeline fingerprint ------------------------------------

_PLAN_KEY = "plan_choice"
PLAN_CHOICES = ("off", "pointwise", "fused", "fused-pallas", "fused-pallas-mxu")


def lookup_plan_choice(pipeline_fp: str | None, device_kind: str | None = None,
                       width: int | None = None) -> str | None:
    """The recorded build mode of a pipeline (plan.ir.pipeline_fingerprint),
    or None: the caller keeps its default resolution."""
    return _lookup_choice(_PLAN_KEY, PLAN_CHOICES, pipeline_fp, device_kind, width)


def record_plan_choice(device_kind: str, pipeline_fp: str, choice: str, **extra) -> str:
    """Write or replace a pipeline's plan choice, stamped ``recorded_at``
    (epoch seconds) unless the caller gives one, as the JAX package stamps
    it for its online tuner's newest-wins rule."""
    extra.setdefault("recorded_at", round(_time.time(), 3))
    return _record_choice(_PLAN_KEY, PLAN_CHOICES, device_kind, pipeline_fp, choice, extra)


def plan_entry(pipeline_fp: str | None, device_kind: str | None = None,
               width: int | None = None) -> dict | None:
    """The whole plan-choice entry (choice, width, recorded_at, ...),
    filtered as lookup_plan_choice filters it."""
    ent = _table_entry(_PLAN_KEY, pipeline_fp, device_kind, width)
    return ent if ent is not None and ent.get("choice") in PLAN_CHOICES else None


def raw_store() -> dict:
    """A deep copy of the parsed store ({} when absent or corrupt)."""
    return json.loads(json.dumps(_load()))


def write_raw_store(data: dict) -> str:
    """Replace the whole store file atomically."""
    return _write_store(data)
