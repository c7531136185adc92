"""Shape-bucket function cache: no request pays a first-call cost.
The counterpart of the JAX package's ``serve/cache.py``.

The reachable shape space under bucketing is a finite grid:

    (bucket_h, bucket_w) x channels x batch_bucket

`warmup()` walks the whole grid once at start: it builds each cell's
serving function (serve/padded.py) and runs it once on zeros on the
device, then synchronises, so the caching allocator has grown to the
grid's working set and every per-shape decision (plan resolution, the
banded-product routing) is made before the first request. After that every
`get()` is a dict lookup. PyTorch compiles nothing here; the counterpart
of a JAX trace is the first call of a built function for an input shape,
which the function reports through `on_trace`, so the `traces` counter
lets tests hold the contract ``traces_since_warmup == 0`` under any
admitted load. A `get()` for a key outside the warmed grid still works (it
builds on the spot) but counts as a miss: admission rounds every request
into the grid, so a scheduler should never make one.
"""

from __future__ import annotations

import threading
import time

import torch

from mpi_cuda_imagemanipulation_tpu_torch.obs import cost as obs_cost
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.resilience.retry import RetryPolicy, call_with_retry
from mpi_cuda_imagemanipulation_tpu_torch.serve.padded import check_servable, resolve_serving_plan
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

Key = tuple[int, int, int, int]  # (bucket_h, bucket_w, channels, batch)

# storage key: the grid cell PLUS the resolved fusion-plan fingerprint
# (plan.ir.Plan.fingerprint, or "off" for per-op execution), so that a
# calibration flip while the server is up is a miss that rebuilds, never a
# function built for the previous structure serving on
StoredKey = tuple[int, int, int, int, str]


class CompileCache:
    def __init__(
        self,
        pipe,
        buckets: tuple[tuple[int, int], ...],
        batch_buckets: tuple[int, ...],
        channels: tuple[int, ...] = (3,),
        *,
        backend: str = "torch",
        mesh=None,
        plan: str = "auto",
        device=None,
    ):
        check_servable(pipe)
        self.pipe = pipe
        self.buckets = tuple(buckets)
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.channels = tuple(channels)
        self.backend = backend
        self.mesh = mesh
        self.plan = plan
        # the device the functions take their inputs on: the mesh's slot 0
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        self._fns: dict[StoredKey, object] = {}
        self._lock = threading.Lock()
        self.traces = 0  # first calls per input shape (on_trace)
        self.traces_at_warmup = 0
        self.hits = 0
        self.misses = 0
        # per-shape-bucket hit split ("HxW" -> count), label cardinality
        # capped at the admission grid: off-grid keys fold into "other"
        self.hits_by_bucket: dict[str, int] = {}
        self._tracked_buckets = {f"{h}x{w}" for h, w in self.buckets}
        self.warmup_s: float | None = None
        # a transient failure at warmup (an injected cache.warm failpoint, a
        # card coming up) retries with backoff instead of killing the server
        self.warm_retry_policy = RetryPolicy(max_attempts=3, base_delay_s=0.05)
        self.warm_retries = 0

    def _on_trace(self) -> None:
        # fired from inside a built function's first call, which runs
        # outside self._lock (warmup and get build off-lock)
        with self._lock:
            self.traces += 1

    def plan_fingerprint(self, bucket_w: int) -> str:
        """The fingerprint of the fusion plan resolved now for this bucket
        width ("off" for per-op execution): the storage-key component that
        keeps functions honest across calibration flips. The calibration
        store's reads are cached on its file's mtime."""
        built = resolve_serving_plan(self.pipe, self.plan, self.backend, bucket_w, self.device)
        return "off" if built is None else built.fingerprint

    def _stored_key(self, key: Key) -> StoredKey:
        return (*key, self.plan_fingerprint(key[1]))

    def _build(self, key: Key):
        """Construct (never store) the serving function of one grid cell;
        it resolves the same plan the fingerprint in its storage key
        recorded (serve/padded.resolve_serving_plan)."""
        bh, bw, ch, nb = key
        return self.pipe.serving(
            bh, bw, ch, nb,
            backend=self.backend, mesh=self.mesh, on_trace=self._on_trace,
            plan=self.plan, device=self.device,
        )

    def _out_channels(self, ch: int) -> int:
        chan = ch
        for op in self.pipe.ops:
            chan = op.out_channels or chan
        return chan

    def _modeled_bytes(self, key: Key) -> float:
        """The boundary model of one serving function: the u8 input stack
        in, the u8 output stack out, plus the two true-shape vectors
        (int32 here, as the scheduler stages them), whatever the plan fused.
        The port measures the call's own tensors, the whole stack on a mesh
        too, so nothing is divided per device as in the JAX package."""
        bh, bw, ch, nb = key
        return float(nb * bh * bw * (ch + self._out_channels(ch)) + 2 * 4 * nb)

    def _inputs(self, key: Key) -> tuple:
        bh, bw, ch, nb = key
        shape = (nb, bh, bw, ch) if ch > 1 else (nb, bh, bw)
        imgs = torch.zeros(shape, dtype=torch.uint8, device=self.device)
        true = torch.full((nb,), min(bh, bw), dtype=torch.int32, device=self.device)
        return imgs, true, true

    def _compile_one(self, key: Key) -> None:
        bh, bw, ch, nb = key
        failpoints.maybe_fail("cache.warm", key=key)
        skey = self._stored_key(key)
        fn = self._build(key)
        # the first call runs OUTSIDE the lock (a multi-second first call
        # must never stall get()s on the warmed grid) and through the cost
        # ledger: its boundary bytes against the model, keyed by the grid
        # cell and the resolved plan fingerprint
        _out, cost = obs_cost.measured_call(fn, self._inputs(key))
        if obs_cost.enabled():
            obs_cost.cost_ledger.record(
                "serve", f"{bh}x{bw}x{ch}x{nb}:{skey[-1]}", cost,
                modeled_bytes=self._modeled_bytes(key),
            )
        del _out
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with self._lock:
            self._fns.setdefault(skey, fn)

    def warmup(self) -> float:
        """Build and run the whole shape grid once; returns wall seconds."""
        t0 = time.perf_counter()
        for bh, bw in self.buckets:
            for ch in self.channels:
                for nb in self.batch_buckets:
                    key = (bh, bw, ch, nb)
                    skey = self._stored_key(key)
                    with self._lock:
                        warmed = skey in self._fns
                    if not warmed:
                        call_with_retry(
                            lambda k=key: self._compile_one(k),
                            policy=self.warm_retry_policy,
                            on_retry=lambda a, e, d, k=key: self._on_warm_retry(k, a, e),
                        )
        with self._lock:
            self.traces_at_warmup = self.traces
            self.warmup_s = time.perf_counter() - t0
            return self.warmup_s

    def _on_warm_retry(self, key: Key, attempt: int, exc: Exception) -> None:
        with self._lock:
            self.warm_retries += 1
        get_logger().warning(
            "warmup of %s failed (%s), retry %d", key, type(exc).__name__, attempt,
        )

    @property
    def traces_since_warmup(self) -> int:
        return self.traces - self.traces_at_warmup

    def get(self, bucket_h: int, bucket_w: int, channels: int, batch: int):
        key = (bucket_h, bucket_w, channels, batch)
        # the CURRENT plan fingerprint joins the lookup key: a warmed entry
        # whose plan the store has since flipped away from stops matching
        skey = self._stored_key(key)
        bucket = f"{bucket_h}x{bucket_w}"
        if bucket not in self._tracked_buckets:
            bucket = "other"  # bounded label set: the admission grid + other
        with self._lock:
            fn = self._fns.get(skey)
            if fn is not None:
                self.hits += 1
                self.hits_by_bucket[bucket] = self.hits_by_bucket.get(bucket, 0) + 1
                return fn
            # off-grid key (or a plan flip since warmup): servable, but
            # unexpected in production; count it
            self.misses += 1
        # build OUTSIDE the lock; two racing misses may both build, and
        # setdefault keeps one. The first call attributes lazily
        fn = obs_cost.wrap_cache_fn(
            "serve",
            f"{bucket_h}x{bucket_w}x{channels}x{batch}:{skey[-1]}",
            self._build(key),
            modeled_fn=lambda _args, k=key: self._modeled_bytes(k),
        )
        with self._lock:
            return self._fns.setdefault(skey, fn)

    def warm_buckets(self) -> list[str]:
        """The "HxW" buckets with at least one built function: after warmup
        the whole admission grid."""
        with self._lock:
            return sorted({f"{bh}x{bw}" for (bh, bw, *_rest) in self._fns})

    def stats(self) -> dict:
        with self._lock:
            return {
                "compiled": len(self._fns),
                "traces": self.traces,
                "traces_since_warmup": self.traces_since_warmup,
                "hits": self.hits,
                "misses": self.misses,
                "hits_by_bucket": dict(self.hits_by_bucket),
                "warmup_s": self.warmup_s,
                "warm_retries": self.warm_retries,
            }
