"""Randomized differential soak: random op chains on random shapes, and every
route of the port must give the golden bytes. The counterpart of the JAX
repository's ``tools/soak.py``.

The port's correctness rests on one invariant: the golden PyTorch ops, the
stage walker, the hand-written kernels on every route and the row-sharded
runner give *identical* uint8 images. The tests check it on fixed op lists;
this tool drives it across the whole registry: random chains (channel-count
aware), random parameters, pathological shapes (narrow, sub-halo,
lane-boundary and odd widths), random tile heights and random shard counts,
non-dividing ones included.

    python -m mpi_cuda_imagemanipulation_tpu_torch.tools.soak \\
        [--iters N] [--seconds S] [--seed K] [--device cuda|cpu] [--slots N] \\
        [--repro LINE] [--verbose]

The device is the card unless ``--device cpu`` is given (the kernels' plain
versions); without CUDA the default raises. ``--slots`` (default 8, the
JAX tests' eight CPU devices) stands for the JAX soak's
``len(jax.devices())``: the sharded lanes put that many mesh slots on the
one device.

Every trial makes the JAX soak's draws from the shared ``random.Random``,
in the same order, so the same seed gives the same chains, shapes, tile
heights and shard counts in both packages, and a REPRO line names the same
case in either. Lanes, each held byte-equal to the golden
``Pipeline.parse(spec)(img)`` on the same device:

    xla              Pipeline.jit("torch")           (the stage walker)
    pallas           ops/cuda_kernels.pipeline_cuda  (K1/K2, drawn block_h)
    packed           tools/packed_kernels.pipeline_packed (T1)
    swar-plane       ops/swar_kernels.pipeline_swar on a gray plane
                     (K6-K8, drawn heights)
    swar             pipeline_swar on the trial's image (K6-K8 where
                     eligible, the K1/K2 fallback otherwise)
    batched-B        Pipeline.batched(B) over 2-3 images, B in torch /
                     cuda for the JAX soak's xla / pallas (cuda: each
                     K1/K2 group one launch for the stack), each image
                     against its own golden
    sharded2d-RxC    Pipeline.sharded over a 2-D R x C mesh (with at least
                     4 slots; a mesh too big for the image is skipped, as
                     in the JAX soak)
    dp-KoverN        Pipeline.data_parallel over N slots, K images (uneven
                     K included), the port's default backend (cuda)
    sharded-N-B      Pipeline.sharded over N slots, B in torch / cuda /
                     auto / swar for the JAX soak's xla / pallas / auto /
                     swar (K2g, K3, K6g-K8g and K1 per shard)

After those draws, a plan lane drawn from its own ``random.Random(trial
seed)`` (so that the shared stream stays the JAX soak's) runs the port's
plan routes: ``Pipeline.jit("cuda", plan=p)`` for ``fused-pallas`` (K4)
and ``fused-pallas-mxu`` (K4 with K5), ``Pipeline.jit("mxu")`` (the
whole-op banded products, K1/K2 for the rest) and ``Pipeline.sharded(...,
backend="cuda", plan="fused-pallas")`` (K4g). From the same stream, the
``sharded-swar-plane`` lane runs ``Pipeline.sharded(..., backend="swar")``
on a gray plane of the trial's shape cut to split evenly over the drawn
shard count: the sharded ``swar`` lane's random 3-channel chains almost
never give the SWAR ghost path (K6g-K8g) its one unpadded gray plane.
T1's ghost mode (T1g) has no route: no entry point of either package runs
the packed runner sharded.

Any mismatch or exception prints one REPRO json line (spec, h, w, seed,
backend) and the tool exits 1; ``--repro LINE`` re-runs that case on every
lane. Calibration lookups are off (``MCIM_NO_CALIB``) while it runs, so
that a store cannot steer the routes a REPRO line names.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

import torch

from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.cuda_kernels import pipeline_cuda
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op
from mpi_cuda_imagemanipulation_tpu_torch.ops.swar_kernels import pipeline_swar
from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from mpi_cuda_imagemanipulation_tpu_torch.tools.packed_kernels import pipeline_packed
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device

# the sharded lanes' backends, in the JAX soak's draw order (xla, pallas,
# auto, swar)
SHARDED_BACKENDS = ("torch", "cuda", "auto", "swar")
# the plan lane's routes
PLAN_ROUTES = ("fused-pallas", "fused-pallas-mxu", "mxu", "sharded-fused-pallas")
# the batched lane's backends, in the JAX soak's draw order (xla, pallas)
BATCHED_BACKENDS = ("torch", "cuda")
# the 2-D lane's mesh shapes, in the JAX soak's draw order
MESHES_2D = ((2, 2), (2, 4), (4, 2), (2, 3))
# every lane a soak should reach: chip_smoke fails a soak that misses one
LANES = (
    ("xla", "pallas", "packed", "swar-plane", "swar")
    + tuple(f"batched-{b}" for b in BATCHED_BACKENDS)
    + ("sharded2d", "data-parallel")
    + tuple(f"sharded-{b}" for b in SHARDED_BACKENDS)
    + tuple(f"plan-{r}" for r in PLAN_ROUTES)
    + ("sharded-swar-plane",)
)


def _rand_filter(rng: random.Random) -> str:
    k = rng.choice((3, 5))
    vals = [str(rng.randint(-4, 4)) for _ in range(k * k)]
    return "filter:" + "/".join(vals)


# spec templates, the JAX soak's; channel compatibility is derived from
# the op instances themselves in random_chain (make_op)
_POOL = [
    lambda r: "grayscale",
    lambda r: "grayscale601",
    lambda r: "sepia",
    lambda r: "gray2rgb",
    lambda r: f"contrast:{r.uniform(0.5, 6):.1f}",
    lambda r: f"brightness:{r.randint(-80, 80)}",
    lambda r: "invert",
    lambda r: f"threshold:{r.randint(1, 254)}",
    lambda r: f"gamma:{r.uniform(0.3, 4):.2f}",
    lambda r: f"posterize:{r.randint(1, 8)}",
    lambda r: f"solarize:{r.randint(1, 254)}",
    lambda r: f"emboss:{r.choice((3, 5))}",
    lambda r: f"emboss101:{r.choice((3, 5))}",
    lambda r: f"gaussian:{r.choice((3, 5, 7))}",
    lambda r: f"box:{r.choice((3, 5, 7))}",
    lambda r: "sobel",
    lambda r: "prewitt",
    lambda r: "scharr",
    lambda r: f"laplacian:{r.choice((4, 8))}",
    lambda r: "sharpen",
    lambda r: "unsharp",
    _rand_filter,
    lambda r: f"erode:{r.choice((3, 5, 7))}",
    lambda r: f"dilate:{r.choice((3, 5, 7))}",
    lambda r: f"median:{r.choice((3, 5))}",
    lambda r: r.choice(("fliph", "flipv", "transpose")),
    lambda r: f"rot:{r.choice((90, 180, 270))}",
    lambda r: f"rotate:{r.uniform(-170, 170):.1f}"
    + (":nearest" if r.random() < 0.5 else ""),
    lambda r: f"pad:{r.randint(1, 6)}:{r.choice(('zero', 'edge', 'reflect101'))}",
    lambda r: f"resize:{r.randint(10, 90)}x{r.randint(10, 90)}"
    + (":nearest" if r.random() < 0.5 else ""),
    lambda r: f"scale:{r.uniform(0.4, 2.2):.2f}"
    + (":nearest" if r.random() < 0.5 else ""),
    lambda r: "equalize",
    lambda r: "autocontrast",
    lambda r: "otsu",
]

# the swar-plane lane's chains, the JAX soak's
_PLANE_SPECS = (
    "gaussian:3",
    "gaussian:5",
    "gaussian:3,gaussian:5",
    "gaussian:7",
    "box:3",
    "box:5",
    "contrast:3.5,gaussian:5",
    "gaussian:5,invert",
    "brightness:20,gaussian:7,invert",
    "emboss:3",
    "emboss:5",
    "emboss101:3",
    "sharpen",
    "laplacian:8",
    "contrast:3.5,emboss:3",
)


# the sharded plane lane's specs: the plane lane's and K8's
_SHARDED_PLANE_SPECS = _PLANE_SPECS + ("sobel", "unsharp", "contrast:3.5,scharr")


def _sharded_plane_shape(h: int, w: int, shards: int) -> tuple[int, int]:
    """The trial's (h, w) cut to a plane the sharded SWAR ghost path takes
    over `shards` rows: a height that divides evenly, at least 8 rows a
    shard (past every halo of the plane specs), and a width that is a
    multiple of 4, at least 32 (W / 4 >= 2 * halo + 1)."""
    return shards * max(h // shards, 8), max(w & ~3, 32)


def random_chain(rng: random.Random, max_len: int = 5) -> str:
    """A registry-wide random chain, valid for a 3-channel input. Channel
    compatibility comes from the op instances themselves (make_op)."""
    chan = 3
    parts: list[str] = []
    for _ in range(rng.randint(1, max_len)):
        for _attempt in range(30):
            build = rng.choice(_POOL)
            spec = build(rng)
            op = make_op(spec)
            need = getattr(op, "in_channels", 0)
            if need and need != chan:
                continue
            parts.append(spec)
            out = getattr(op, "out_channels", 0)
            chan = out or need or chan
            break
    return ",".join(parts) or "invert"


def _crop_for(rng: random.Random, h: int, w: int) -> str:
    ch = rng.randint(max(1, h // 2), h)
    cw = rng.randint(max(1, w // 2), w)
    return f"crop:{rng.randint(0, h - ch)}:{rng.randint(0, w - cw)}:{ch}:{cw}"


def random_shape(rng: random.Random) -> tuple[int, int]:
    kind = rng.random()
    if kind < 0.25:  # tiny / sub-halo heights
        return rng.randint(9, 24), rng.randint(9, 40)
    if kind < 0.5:  # lane-boundary widths
        return rng.randint(20, 90), rng.choice((127, 128, 129, 255, 256, 257))
    if kind < 0.75:  # generic small; half the time a word-aligned width so
        # that the packed path's eligible branch (W % 4 == 0, W/4 >= 8)
        # soaks as often as its fallback
        w = rng.randint(25, 160)
        if rng.random() < 0.5:
            w = max(32, w & ~3)
        return rng.randint(25, 120), w
    return rng.randint(120, 300), rng.randint(40, 120)  # tall, shardable


def _image(h: int, w: int, channels: int, seed: int, device) -> torch.Tensor:
    return torch.from_numpy(synthetic_image(h, w, channels=channels, seed=seed)).to(device)


def _same(got: torch.Tensor, want: torch.Tensor) -> bool:
    return got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want)


def _mesh(n: int, device):
    return make_mesh(n, devices=[device] * n)


def _stack(h: int, w: int, k: int, seed: int, device) -> torch.Tensor:
    """The JAX soak's stacks: k RGB images seeded seed, seed + 1, ..."""
    return torch.stack([_image(h, w, 3, seed + t, device) for t in range(k)])


def _per_image_lane(fn, pipe, stack) -> str | None:
    """None when `fn()` gives, image by image, the golden output of each
    image of `stack`, else what went wrong."""
    out = fn()
    for t in range(stack.shape[0]):
        if not _same(out[t], pipe(stack[t])):
            return f"mismatch at image {t}"
    return None


def _count(stats: dict | None, group: str, name: str) -> None:
    if stats is not None:
        table = stats.setdefault(group, {})
        table[name] = table.get(name, 0) + 1


def _run_sharded(pipe, img, n: int, device, stats, **kw):
    """`pipe.sharded` over `n` slots on `img`: (output, slots used). A mesh
    too tall for the image ("below the minimum") falls back to 2 slots, and
    then, still too tall, gives (None, 2) with the skip counted in
    stats['shard_skips'] (the JAX soak's count)."""
    while True:
        try:
            return pipe.sharded(_mesh(n, device), **kw)(img), n
        except ValueError as e:
            if "below the minimum" not in str(e):
                raise
            if n > 2:
                n = 2
                continue
            if stats is not None:
                stats["shard_skips"] = stats.get("shard_skips", 0) + 1
            return None, n


def run_trial(
    rng: random.Random,
    trial_seed: int,
    verbose: bool,
    stats: dict | None = None,
    *,
    device="cuda",
    slots: int = 8,
) -> dict | None:
    """One trial: a random chain on a random shape through every lane. None
    when every lane agrees with golden, else the REPRO dict of the first
    that does not. `stats['lanes']` counts the lanes that ran and agreed,
    `stats['shard_skips']` the trials too short for any sharded lane."""
    device = torch.device(device)
    h, w = random_shape(rng)
    spec = random_chain(rng)
    if rng.random() < 0.2:  # crop needs in-bounds params for this shape
        spec = _crop_for(rng, h, w) + "," + spec
    img = _image(h, w, 3, trial_seed, device)
    pipe = Pipeline.parse(spec)

    def repro(backend, detail="", **extra):
        return {
            "spec": spec, "h": h, "w": w, "seed": trial_seed,
            "backend": backend, "detail": detail[:300], **extra,
        }

    def lane(name, fn, want, **extra):
        """None and the lane counted when fn() gives `want`, else REPRO."""
        try:
            got = fn()
        except Exception as e:  # noqa: BLE001 - any crash is a finding
            return repro(name, f"raised {type(e).__name__}: {e}", **extra)
        if not _same(got, want):
            return repro(name, "mismatch", **extra)
        _count(stats, "lanes", name)
        return None

    golden = pipe(img)
    if verbose:
        print(f"  {spec!r} ({h}x{w}) -> {tuple(golden.shape)}", flush=True)

    bad = lane("xla", lambda: pipe.jit("torch", device=device)(img), golden)
    if bad:
        return bad

    # a random explicit tile height (None, the default, weighted 2x): the
    # bytes must not depend on the tile
    bh = rng.choice((None, None, 32, 64, 96))
    bh_extra = {} if bh is None else {"block_h": bh}
    bad = lane("pallas", lambda: pipeline_cuda(pipe.ops, img, block_h=bh), golden, **bh_extra)
    if bad:
        return bad

    if rng.random() < 0.5:  # the archival packed path (T1)
        bad = lane("packed", lambda: pipeline_packed(pipe.ops, img, block_h=bh), golden,
                   **bh_extra)
        if bad:
            return bad

    if rng.random() < 0.4:  # the SWAR path
        # the random 3-channel pipeline mostly runs pipeline_swar's fallback
        # (the SWAR kernels take one u8 plane with W % 4 == 0), so first a
        # plane trial that reaches K6-K8 on fuzzed shapes and heights
        w4 = w - (w % 4)
        if w4 >= 24 and h >= 8:
            sbh = rng.choice((None, 8, 16, 24, 32, 64))
            gimg = _image(h, w4, 1, trial_seed + 77, device)
            gspec = rng.choice(_PLANE_SPECS)
            gpipe = Pipeline.parse(gspec)
            bad = lane("swar-plane", lambda: pipeline_swar(gpipe.ops, gimg, block_h=sbh),
                       gpipe(gimg), plane_spec=gspec, plane_block_h=sbh)
            if bad:
                bad["detail"] = f"{gspec} bh={sbh}: {bad['detail']}"[:300]
                return bad
        bad = lane("swar", lambda: pipeline_swar(pipe.ops, img, block_h=bh), golden,
                   **bh_extra)
        if bad:
            return bad

    def stack_lane(name, count, fn, stack):
        """A stack's lane: every image against its own golden; the launches
        its call made are added to stats['lane_launches'][count]."""
        before = ck.launch_counts()
        try:
            bad = _per_image_lane(fn, pipe, stack)
        except Exception as e:  # noqa: BLE001
            return repro(name, f"raised {type(e).__name__}: {e}")
        if bad:
            return repro(name, bad)
        _count(stats, "lanes", count)
        if stats is not None:
            table = stats.setdefault("lane_launches", {}).setdefault(count, {})
            for k, v in ck.launch_counts().items():
                if v > before[k]:
                    table[k] = table.get(k, 0) + v - before[k]
        return None

    if rng.random() < 0.35:  # the batched path: per-image byte equality
        k = rng.randint(2, 3)
        backend_b = rng.choice(BATCHED_BACKENDS)  # the JAX soak's xla / pallas
        imgs = _stack(h, w, k, trial_seed, device)
        bad = stack_lane(f"batched-{backend_b}", f"batched-{backend_b}",
                         lambda: pipe.batched(backend_b, device=device)(imgs), imgs)
        if bad:
            return bad

    if rng.random() < 0.3 and slots >= 4:
        # the 2-D tile mesh (parallel/api2d): the corner-carrying exchange
        r, c = rng.choice(MESHES_2D)
        if r * c <= slots:
            mesh2 = make_mesh_2d(r, c, devices=[device] * (r * c))
            try:
                got = pipe.sharded(mesh2, backend="torch")(img)
            except ValueError as e:
                if "below the minimum" not in str(e):
                    return repro(f"sharded2d-{r}x{c}", f"raised ValueError: {e}")
                got = None  # the image is too small for this mesh: skipped
            except Exception as e:  # noqa: BLE001
                return repro(f"sharded2d-{r}x{c}", f"raised {type(e).__name__}: {e}")
            if got is not None:
                if not _same(got, golden):
                    return repro(f"sharded2d-{r}x{c}", "mismatch")
                _count(stats, "lanes", "sharded2d")

    if rng.random() < 0.25 and slots >= 2:
        # a data-parallel stack (Pipeline.data_parallel), uneven K included
        k = rng.randint(2, 5)
        n_dp = rng.choice([s for s in (2, 4) if s <= slots])
        dimgs = _stack(h, w, k, trial_seed, device)
        bad = stack_lane(f"dp-{k}over{n_dp}", "data-parallel",
                         lambda: pipe.data_parallel(_mesh(n_dp, device))(dimgs), dimgs)
        if bad:
            return bad

    def sharded_lane(name, count, n, skips, **kw):
        """`pipe.sharded` over `n` slots (`_run_sharded`) as a lane; `name`
        takes the slots used as {n}."""
        try:
            got, n = _run_sharded(pipe, img, n, device, skips, **kw)
        except Exception as e:  # noqa: BLE001
            return repro(name.format(n=n), f"raised {type(e).__name__}: {e}")
        if got is None:
            return None
        if not _same(got, golden):
            return repro(name.format(n=n), "mismatch")
        _count(stats, "lanes", count)
        return None

    if slots >= 2:
        shards = rng.choice([s for s in (2, 3, 5, slots) if s <= slots])
        # the JAX soak's draw over (xla, pallas, auto, swar), same index
        backend = rng.choice(SHARDED_BACKENDS)
        bad = sharded_lane(f"sharded-{{n}}-{backend}", f"sharded-{backend}", shards, stats,
                           backend=backend)
        if bad:
            return bad

    # the port's plan routes, their tile height, shard count and halo mode
    # drawn from a stream of their own
    prng = random.Random(trial_seed)
    pbh = prng.choice((None, None, 16, 32, 48))
    for plan in ("fused-pallas", "fused-pallas-mxu"):
        bad = lane(f"plan-{plan}", lambda plan=plan: pipe.jit("cuda", pbh, device=device,
                                                              plan=plan)(img),
                   golden, plan_block_h=pbh)
        if bad:
            return bad
    bad = lane("plan-mxu", lambda: pipe.jit("mxu", device=device)(img), golden)
    if bad or slots < 2:
        return bad
    shards = prng.choice(range(2, slots + 1))
    halo_mode = prng.choice(("serial", "overlap"))
    bad = sharded_lane(f"plan-sharded-{{n}}-fused-pallas-{halo_mode}",
                       "plan-sharded-fused-pallas", shards, None, backend="cuda",
                       halo_mode=halo_mode, plan="fused-pallas")
    if bad:
        return bad

    # the sharded SWAR ghost path (K6g-K8g) takes a gray plane whose rows
    # split evenly over the mesh, which the 3-channel trial almost never is:
    # a plane of the trial's shape cut to fit (_sharded_plane_shape)
    shards = prng.choice(range(2, slots + 1))
    sspec = prng.choice(_SHARDED_PLANE_SPECS)
    spipe = Pipeline.parse(sspec)
    simg = _image(*_sharded_plane_shape(h, w, shards), 1, trial_seed + 78, device)
    return lane("sharded-swar-plane",
                lambda: spipe.sharded(_mesh(shards, device), backend="swar")(simg),
                spipe(simg), sharded_plane_spec=sspec, sharded_plane_shards=shards)


def run_repro(line: str, *, device="cuda", slots: int = 8) -> int:
    """Re-run one REPRO json line deterministically: the same spec, shape and
    image seed on every lane (each tile height the line names and the
    default, every shard count and backend, the batched backends and the
    data-parallel stack image by image, every 2-D mesh, the plan routes),
    with a verdict a lane. Returns 1 if any lane disagrees with golden."""
    device = torch.device(device)
    d = json.loads(line)
    spec, h, w, seed = d["spec"], d["h"], d["w"], d["seed"]
    img = _image(h, w, 3, seed, device)
    pipe = Pipeline.parse(spec)
    golden = pipe(img)
    print(f"repro {spec!r} ({h}x{w}, seed {seed}) -> {tuple(golden.shape)}")
    rc = 0

    def check(name, fn, want=golden, skip_on_min_guard=False):
        nonlocal rc
        try:
            got = fn()
        except ValueError as e:
            if skip_on_min_guard and "below the minimum" in str(e):
                print(f"  {name}: skipped (image too short)")
                return
            print(f"  {name}: RAISED ValueError: {str(e)[:200]}")
            rc = 1
            return
        except Exception as e:  # noqa: BLE001
            print(f"  {name}: RAISED {type(e).__name__}: {str(e)[:200]}")
            rc = 1
            return
        ok = _same(got, want)
        print(f"  {name}: {'ok' if ok else 'MISMATCH'}")
        rc |= 0 if ok else 1

    check("xla", lambda: pipe.jit("torch", device=device)(img))
    for bh in dict.fromkeys((d.get("block_h"), None)):
        tag = "" if bh is None else f"[bh={bh}]"
        check(f"pallas{tag}", lambda bh=bh: pipeline_cuda(pipe.ops, img, block_h=bh))
        check(f"packed{tag}", lambda bh=bh: pipeline_packed(pipe.ops, img, block_h=bh))
        check(f"swar{tag}", lambda bh=bh: pipeline_swar(pipe.ops, img, block_h=bh))
    if d.get("sharded_plane_spec"):
        spipe, shards = Pipeline.parse(d["sharded_plane_spec"]), d["sharded_plane_shards"]
        simg = _image(*_sharded_plane_shape(h, w, shards), 1, seed + 78, device)
        check(f"sharded-swar-plane[{d['sharded_plane_spec']} n={shards}]",
              lambda: spipe.sharded(_mesh(shards, device), backend="swar")(simg),
              want=spipe(simg))
    if d.get("plane_spec"):
        gpipe = Pipeline.parse(d["plane_spec"])
        gimg = _image(h, w - w % 4, 1, seed + 77, device)
        sbh = d.get("plane_block_h")
        check(f"swar-plane[{d['plane_spec']} bh={sbh}]",
              lambda: pipeline_swar(gpipe.ops, gimg, block_h=sbh), want=gpipe(gimg))
    # the trial's stacks (k images seeded seed + t); k = 3 covers the
    # batched lane's k, and every index is compared
    imgs = _stack(h, w, 3, seed, device)
    for b in BATCHED_BACKENDS:
        for t in range(3):
            check(f"batched-{b}[{t}]", lambda b=b, t=t: pipe.batched(b, device=device)(imgs)[t],
                  want=pipe(imgs[t]))
    if slots >= 4:
        for r, c in sorted(MESHES_2D):
            if r * c <= slots:
                check(f"sharded2d-{r}x{c}",
                      lambda r=r, c=c: pipe.sharded(
                          make_mesh_2d(r, c, devices=[device] * (r * c)), backend="torch")(img),
                      skip_on_min_guard=True)
    if slots >= 2:
        for t in range(3):
            check(f"dp[{t}]", lambda t=t: pipe.data_parallel(_mesh(2, device))(imgs)[t],
                  want=pipe(imgs[t]))
    if slots >= 2:
        for shards in sorted({s for s in (2, 3, 5, slots) if s <= slots}):
            for b in SHARDED_BACKENDS:
                check(f"sharded-{shards}-{b}",
                      lambda shards=shards, b=b: pipe.sharded(_mesh(shards, device),
                                                              backend=b)(img),
                      skip_on_min_guard=True)
    pbh = d.get("plan_block_h")
    for plan in ("fused-pallas", "fused-pallas-mxu"):
        check(f"plan-{plan}", lambda plan=plan: pipe.jit("cuda", pbh, device=device,
                                                         plan=plan)(img))
    check("plan-mxu", lambda: pipe.jit("mxu", device=device)(img))
    if slots >= 2:
        for shards in range(2, slots + 1):
            for mode in ("serial", "overlap"):
                check(f"plan-sharded-{shards}-fused-pallas-{mode}",
                      lambda shards=shards, mode=mode: pipe.sharded(
                          _mesh(shards, device), backend="cuda", halo_mode=mode,
                          plan="fused-pallas")(img),
                      skip_on_min_guard=True)
    return rc


def soak(*, iters: int | None = 200, seconds: float | None = None, seed: int = 0,
         device="cuda", slots: int = 8, verbose: bool = False, out=sys.stdout) -> dict:
    """Run trials from `random.Random(seed)` until `iters` trials or
    `seconds` of wall time (which then wins) and return the report:
    trials, REPRO dicts, per-lane counts, the stack lanes' launches by
    kernel, shard skips, seconds. Prints each REPRO line and a progress line every 25 trials
    to `out`. The caller sets MCIM_NO_CALIB (main does)."""
    rng = random.Random(seed)
    t0 = time.time()
    repros: list[dict] = []
    stats: dict = {}
    i = 0
    while True:
        if seconds is not None:
            if time.time() - t0 > seconds:
                break
        elif i >= iters:
            break
        trial_seed = rng.randint(0, 2**31 - 1)
        bad = run_trial(rng, trial_seed, verbose, stats=stats, device=device, slots=slots)
        if bad is not None:
            repros.append(bad)
            print("REPRO " + json.dumps(bad), file=out, flush=True)
        i += 1
        if i % 25 == 0:
            print(f"soak: {i} trials, {len(repros)} failures, {time.time() - t0:.0f}s",
                  file=out, flush=True)
    return {
        "trials": i,
        "repros": repros,
        "lanes": {name: stats.get("lanes", {}).get(name, 0) for name in LANES},
        # the kernel launches of the stack lanes (batched, data-parallel)
        "lane_launches": stats.get("lane_launches", {}),
        "shard_skips": stats.get("shard_skips", 0),
        "seconds": time.time() - t0,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_imagemanipulation_tpu_torch.tools.soak",
        description="randomized differential soak over every route of the port",
    )
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seconds", type=float, default=None,
                    help="stop after this much wall time (overrides --iters)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--slots", type=int, default=8,
                    help="mesh slots of the sharded lanes, all on --device (default 8)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--repro", default=None,
                    help="re-run one REPRO json line instead of fuzzing")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    saved = os.environ.get("MCIM_NO_CALIB")
    # a calibration store must not steer the routes a REPRO line names
    os.environ["MCIM_NO_CALIB"] = "1"
    try:
        if args.repro:
            return run_repro(args.repro, device=device, slots=args.slots)
        rep = soak(iters=args.iters, seconds=args.seconds, seed=args.seed, device=device,
                   slots=args.slots, verbose=args.verbose)
    finally:
        if saved is None:
            os.environ.pop("MCIM_NO_CALIB", None)
        else:
            os.environ["MCIM_NO_CALIB"] = saved
    print(f"soak done: {rep['trials']} trials, {len(rep['repros'])} failures, "
          f"{rep['shard_skips']} without sharded coverage "
          f"(too short even for 2 shards), {rep['seconds']:.0f}s", flush=True)
    print("soak lanes: " + json.dumps({"lanes": rep["lanes"]}), flush=True)
    return 1 if rep["repros"] else 0


if __name__ == "__main__":
    sys.exit(main())
