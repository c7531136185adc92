"""T1: one ``[pointwise*, stencil?]`` group on packed word planes, four u8
pixels per 32-bit word; the counterpart of the JAX repository's
``tools/packed_kernels.py``.

The JAX repository demoted this design from its production paths after
measuring it on its own hardware, and kept the module as the record of the
design and for its A/B tools. The port keeps it for the same tools
(``tools.packed_ab`` and the probe's ``gaussian5_8k_packed`` case) and adds
no production route to it. It holds:

* ``pack_words`` / ``unpack_words``: (H, W) u8 <-> (H, W/4) int32, byte k
  of word j = column 4j + k (little-endian); free views of a contiguous
  plane.
* ``packed_supported``: which groups the kernel takes, rule for rule the
  JAX module's; ``pipeline_packed`` sends the others to the K1/K2 group
  runner (``ops/cuda_kernels.run_group``).
* ``run_group_packed_words``: T1, a hand-written CUDA kernel
  (``ops/csrc/packed_stream.cu``) in three forms: the pointwise form
  ('T1-pw'), the stencil form over a whole image ('T1') and its ghost mode
  over one row-shard with ghost word strips ('T1g'). Beside it the plain
  version ``run_group_packed_words_plain``: unpack, the port's plain group
  (``pointwise_group_plain``, ``stream_stencil_plain`` or
  ``stream_stencil_ghost_plain``), pack. ``run_group_packed`` takes and
  returns u8 planes.
* ``pipeline_packed``: the word-carrying group loop, consecutive eligible
  groups staying in word form.

Each of ``run_group_packed_words``, ``run_group_packed`` and
``pipeline_packed`` takes one image, or with ``batched=True`` a stack of
same-shape images (the JAX module under ``jax.vmap``,
``tests/test_packed.py:159``): T1 full mode takes the stack on its batch
axis (grid z, ``packed_batch_geometry``) and T1-pw as one flat run, so a
group is one launch per stack; ghost mode (T1g) takes one image.

The kernel's host geometry (the strips, runs and chunks of the stencil
form, the window's column and row sources, shared memory, the pointwise
form's split) is plain Python here, so that the CPU tests can check it.
Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises, and counts the launch in
``cuda_kernels.TOOL_LAUNCHES`` under 'T1-pw', 'T1' or 'T1g'.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import (
    U8,
    PointwiseOp,
    StencilOp,
    per_image,
    takes_stack,
)
from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr

I32 = torch.int32
# Launch geometry (packed_stream.cu). A stencil block owns a strip of
# tile_w words, one of TILE_WIDTHS (PK_MAX_TILE_W .. PK_MIN_TILE_W), and a
# run of run_h rows, which it walks in chunks of CHUNK_H output rows (at
# most MAX_CHUNK_H, PK_MAX_CHUNK_H), PREFETCH chunks' loads in flight ahead
# of the one it reads (PK_PREFETCH; RAW_SLOTS and ROW_SLOTS are
# PK_RAW_SLOTS and PK_ROW_SLOTS); the host narrows the strips until the
# grid has N_SMS blocks and cuts runs of whole chunks so that it has about
# TARGET_BLOCKS. The pointwise form takes RUN_WORDS words a plane per
# thread (PR_RUN_WORDS in packed_run.cuh).
TILE_WIDTHS = (32, 16, 8)
CHUNK_H = 32
MAX_CHUNK_H = 48
PREFETCH = 2
RAW_SLOTS = PREFETCH + 1
ROW_SLOTS = PREFETCH + 2
TARGET_BLOCKS = 16 * ck.N_SMS
RUN_WORDS = 4
N_SMS = ck.N_SMS


# --------------------------------------------------------------------------
# Views: u8 plane <-> int32 word plane (the same bytes)
# --------------------------------------------------------------------------


def pack_words(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) u8 -> (H, W/4) int32; word j's byte k is column 4j + k. A
    view of the plane (a copy first only if it is not contiguous)."""
    if plane.ndim != 2 or plane.dtype != U8:
        raise ValueError(f"pack_words takes an (H, W) uint8 plane, got "
                         f"{tuple(plane.shape)} {plane.dtype}")
    return _pack(plane)


def unpack_words(words: torch.Tensor, width: int) -> torch.Tensor:
    """(H, W/4) int32 -> (H, W) u8, the inverse of pack_words; a view."""
    if words.ndim != 2 or words.dtype != I32:
        raise ValueError(f"unpack_words takes (H, W/4) int32 words, got "
                         f"{tuple(words.shape)} {words.dtype}")
    return _unpack(words, width)


def _pack(planes: torch.Tensor) -> torch.Tensor:
    """pack_words over the last two axes: an (H, W) plane or an (N, H, W)
    stack of planes."""
    width = planes.shape[-1]
    if width % 4:
        raise ValueError(f"packed words need a width that is a multiple of 4, got {width}")
    return planes.contiguous().view(I32).view(*planes.shape[:-1], width // 4)


def _unpack(words: torch.Tensor, width: int) -> torch.Tensor:
    """unpack_words over the last two axes."""
    if width != 4 * words.shape[-1]:
        raise ValueError(f"{words.shape[-1]} words per row hold width {4 * words.shape[-1]}, "
                         f"not {width}")
    return words.contiguous().view(U8).view(*words.shape[:-1], width)


# --------------------------------------------------------------------------
# Eligibility
# --------------------------------------------------------------------------


def packed_supported(
    pointwise: list[PointwiseOp], stencil: StencilOp | None, width: int
) -> bool:
    """Whether this [pointwise*, stencil?] group can run packed; callers
    send the others to the u8 group runner. The JAX module's rules: width a
    multiple of 4 with at least 8 words, kernel-safe pointwise ops, a
    pointwise-only group with at least one op, or a stencil that reduces by
    corr, min, max or median with a single or magnitude combine, in
    reflect101 or edge mode (interior mode for non-separable correlations
    only), of halo 1-3 with 2 halo < W/4."""
    if width % 4 or width // 4 < 8:
        return False
    if any(not op.kernel_safe for op in pointwise):
        return False
    if stencil is None:
        return bool(pointwise)
    if stencil.reduce not in ("corr", "min", "max", "median"):
        return False
    if stencil.combine not in ("single", "magnitude"):
        return False
    if stencil.edge_mode == "interior":
        if stencil.separable is not None or stencil.reduce != "corr":
            return False
    elif stencil.edge_mode not in ("reflect101", "edge"):
        return False
    if not 1 <= stencil.halo <= 3:
        return False
    if 2 * stencil.halo >= width // 4:
        return False
    return True


# --------------------------------------------------------------------------
# Host-side geometry (packed_stream.cu)
# --------------------------------------------------------------------------


def packed_grid(height: int, wp: int, tile_w: int, run_h: int) -> tuple[int, int]:
    """T1's grid: (strips, runs)."""
    return -(-wp // tile_w), -(-height // run_h)


@functools.lru_cache(maxsize=4096)
def packed_tile_shape(height: int, wp: int, n: int = 1) -> tuple[int, int]:
    """The (tile_w, run_h) of one T1 launch over a stack of `n` images of
    (height, wp) words: the widest of TILE_WIDTHS that gives the grid,
    every image counted, N_SMS blocks of one chunk each, narrowing only
    while that adds strips; then runs of whole chunks, as long as keeps
    about TARGET_BLOCKS blocks over the stack (one chunk at least, and at
    most 65535 runs an image). A stack fills the SMs sooner than one
    image, so it keeps wider strips and longer runs."""
    cols = TILE_WIDTHS[0]
    for narrower in TILE_WIDTHS[1:]:
        if n * math.prod(packed_grid(height, wp, cols, CHUNK_H)) >= N_SMS:
            break
        if -(-wp // narrower) > -(-wp // cols):
            cols = narrower
    strips, chunks = packed_grid(height, wp, cols, CHUNK_H)
    per_run = max(1, n * chunks * strips // TARGET_BLOCKS, -(-chunks // 65535))
    return cols, CHUNK_H * min(per_run, chunks)


# images of one full-mode launch: CUDA's limit on grid z (PK_MAX_IMAGES)
MAX_BATCH = ck.MAX_BATCH


def packed_batch_geometry(n: int, height: int, wp: int) -> tuple[int, int, int]:
    """(images, input stride, output stride) of one T1 full-mode launch
    over `n` images of (height, wp) words a plane, strides in words: each
    input and output plane is a contiguous (n, height, wp) stack, image i
    at ``i * stride`` words, which the kernel takes in 64 bits (here
    Python ints; PkPlanes holds them as long long). One image is a stack of
    one."""
    if not 1 <= n <= MAX_BATCH:
        raise ValueError(f"one T1 launch takes 1 to {MAX_BATCH} images, got {n}")
    return n, height * wp, height * wp


def packed_smem_bytes(n_in: int, n_out: int, tile_w: int, chunk_h: int, halo: int,
                      family: int) -> int:
    """Dynamic shared memory of one stencil block (pk_layout in the
    source): ROW_SLOTS slots of row sources (16 bytes each) and RAW_SLOTS
    raw slots, n_in x (chunk_h + 2 halo) rows each; then per output plane the
    window ring, chunk_h + 4 halo rows (its mirror included); then, for
    separable and min/max, the float32 row-pass ring of as many rows of 4
    tile_w floats per plane."""
    eh = chunk_h + 2 * halo
    rows = eh + 2 * halo
    raw_pitch = -(-(4 * tile_w + 24) // 16) * 16
    pitch = -(-(4 * tile_w + 8) // 16) * 16
    nbytes = (ROW_SLOTS * n_in * eh * 16 + RAW_SLOTS * n_in * eh * raw_pitch
              + n_out * rows * pitch)
    if family in (ck._FAMILIES["separable"], ck._FAMILIES["min"], ck._FAMILIES["max"]):
        nbytes += n_out * rows * 4 * tile_w * 4
    return nbytes


def planar_split(in_addrs, out_addr: int, n: int) -> tuple[int, int, int, list[int]]:
    """How the pointwise form (T1-pw, and T2) splits a launch of `n` words a
    plane (pr_split in packed_run.cuh): (head, runs, tail, shifts). Words
    [0, head) and the `tail` after the body run one a thread; the body is
    `runs` runs of RUN_WORDS words from `head`, the first word whose output
    is 16-byte aligned; input plane c's runs start shifts[c] words past a
    16-byte boundary."""
    head = 0
    while head < RUN_WORDS and (out_addr + 4 * head) % 16:
        head += 1
    head = min(head, n)
    runs = (n - head) // RUN_WORDS
    return head, runs, n - head - runs * RUN_WORDS, [(a + 4 * head) % 16 // 4 for a in in_addrs]


def _st_src(c: int, n: int, mode: str) -> int:
    """stencil.cuh's st_src: the golden padding's source (ck.edge_src),
    clamped into the axis where that has none (interior mode)."""
    src = ck.edge_src(c, n, mode)
    return min(max(c, 0), n - 1) if src is None else src


def window_columns(w0: int, tile_w: int, wp: int, halo: int, mode: str) -> list[int]:
    """The image column each byte of a strip's post-chain window row holds
    (the window pass): bytes 0 .. 4 tile_w + 2 halo - 1, byte 0 being
    column 4 w0 - halo. In a strip that touches no border, the column
    itself; else its st_src column, clamped into the words the strip loads,
    [max(w0 - 1, 0), min(w0 + tile_w + 1, wp))."""
    lo, hi = max(w0 - 1, 0), min(w0 + tile_w + 1, wp)
    border = w0 == 0 or w0 + tile_w + 1 > wp
    cols = [4 * w0 - halo + b for b in range(4 * tile_w + 2 * halo)]
    if border:
        cols = [min(max(_st_src(c, 4 * wp, mode), 4 * lo), 4 * hi - 1) for c in cols]
    return cols


def window_row_source(ty: int, height: int, halo: int, mode: str,
                      ghost: bool) -> tuple[str, int]:
    """Where a window row `ty` (a row of the image, or of the tile in ghost
    mode) comes from: ('image', row) by the row source st_src in full mode;
    in ghost mode ('top', row) or ('bottom', row) of the strips (rows past
    the bottom strip clamp to its last row) or ('tile', row)."""
    if not ghost:
        return "image", _st_src(ty, height, mode)
    return ck.ghost_row_source(ty, height, halo)


# --------------------------------------------------------------------------
# Checks shared by the wrappers and the plain versions
# --------------------------------------------------------------------------


def _check_planes(what: str, planes, shape, device) -> None:
    for p in planes:
        if tuple(p.shape) != shape or p.dtype != I32 or p.device != device:
            raise ValueError(
                f"T1 takes {what} as {shape} int32 word planes on {device}, got "
                f"{[(tuple(q.shape), q.dtype, str(q.device)) for q in planes]}"
            )


def _check_group(pointwise, stencil, words, height, width, block_h, ghosts, y0, image_h):
    """Validate one T1 call on a stack: `words` are (N, height, width/4)
    planes. Returns (chain, stencil descriptor or None, (tile_w, run_h) or
    None). `block_h`, the JAX block height, is checked (the JAX default
    when falsy) and sets nothing."""
    if len(words) not in (1, 3):
        raise ValueError(f"T1 takes 1 or 3 word planes, got {len(words)}")
    if width % 4:
        raise ValueError(f"packed words need a width that is a multiple of 4, got {width}")
    wp = width // 4
    n = words[0].shape[0]
    _check_planes("the input", words, (n, height, wp), words[0].device)
    if not packed_supported(list(pointwise), stencil, width):
        names = [op.name for op in pointwise] + ([stencil.name] if stencil else [])
        raise ValueError(f"T1 does not take group {names} at width {width} (packed_supported)")
    chain = ck.chain_for(pointwise, len(words))
    if (block_h or 1) < 1:
        raise ValueError(f"tile height must be >= 1, got {block_h}")
    if stencil is None:
        if ghosts is not None:
            raise ValueError("ghost mode needs a stencil")
        return chain, None, None
    desc = ck.desc_for(stencil)
    h = stencil.halo
    if height <= h:
        raise ValueError(f"image height {height} too small for halo {h}")
    if ghosts is not None:
        if n != 1:
            raise ValueError(f"ghost mode takes one image, got a stack of {n}")
        tops, bots = ghosts
        if len(tops) != len(words) or len(bots) != len(words):
            raise ValueError(f"ghost mode needs one top and one bottom strip per input plane, "
                             f"got {len(tops)} and {len(bots)} for {len(words)}")
        _check_planes("ghost strips", list(tops) + list(bots), (h, wp), words[0].device)
        if y0 is None or image_h is None:
            raise ValueError("ghost mode needs the tile's first global row y0 and image_h")
        if not 0 <= int(y0) <= image_h - height:
            raise ValueError(f"tile rows [{int(y0)}, {int(y0) + height}) lie outside an image "
                             f"of {image_h} rows")
    return chain, desc, packed_tile_shape(height, wp, n)


def _hwc(planes: list[torch.Tensor]) -> torch.Tensor:
    """An image (a stack) from its channel planes (stacks of planes)."""
    return planes[0] if len(planes) == 1 else torch.stack(planes, dim=-1)


def _stack_planes(stack: torch.Tensor) -> list[torch.Tensor]:
    """The (N, H, W) channel planes of an (N, H, W[, C]) stack."""
    return [stack] if stack.ndim == 3 else [stack[..., c] for c in range(stack.shape[3])]


def _stack_call(fn, words, batched: bool):
    """`fn(words)` on a stack of (N, H, W/4) planes: one image's planes as a
    stack of one unless `batched` (ghost strips stay per image)."""
    if batched:
        return fn(list(words))
    return [o[0] for o in fn([w[None] for w in words])]


# --------------------------------------------------------------------------
# T1: plain version and wrapper
# --------------------------------------------------------------------------


def _group_plain_stack(pointwise, stencil, words, height, width, block_h, ghosts, y0, image_h):
    """The plain version on (N, height, width/4) planes, image by image."""
    _check_group(pointwise, stencil, words, height, width, block_h, ghosts, y0, image_h)
    img = _hwc([_unpack(w, width) for w in words])
    if stencil is None:
        out = per_image(functools.partial(ck.pointwise_group_plain, list(pointwise)), img)
    elif ghosts is None:
        out = per_image(functools.partial(ck.stream_stencil_plain, list(pointwise), stencil), img)
    else:
        tops, bots = ([unpack_words(s, width) for s in strips] for strips in ghosts)
        out = ck.stream_stencil_ghost_plain(
            list(pointwise), stencil, img[0], _hwc(tops), _hwc(bots), y0=int(y0),
            image_h=image_h, image_w=width,
        )[None]
    return [_pack(p) for p in _stack_planes(out)]


def run_group_packed_words_plain(
    pointwise: list[PointwiseOp],
    stencil: StencilOp | None,
    words: list[torch.Tensor],
    height: int,
    width: int,
    *,
    block_h: int | None = None,
    ghosts: tuple[list[torch.Tensor], list[torch.Tensor]] | None = None,
    y0=None,
    image_h: int | None = None,
    batched: bool = False,
) -> list[torch.Tensor]:
    """Plain version of T1, all three forms: unpack the words (views), the
    port's plain group (``pointwise_group_plain``, ``stream_stencil_plain``,
    or ``stream_stencil_ghost_plain`` at global row `y0` of `image_h` in
    ghost mode), pack each output plane; with ``batched=True`` over
    (N, height, width/4) planes, image by image. `block_h` is checked, and
    changes no byte."""
    return _stack_call(
        lambda ws: _group_plain_stack(pointwise, stencil, ws, height, width, block_h, ghosts, y0,
                                      image_h),
        words, batched)


def _group_words_stack(pointwise, stencil, words, height, width, block_h, ghosts, y0, image_h):
    """T1 on (N, height, width/4) planes: one launch for the stack."""
    chain, desc, shape = _check_group(
        pointwise, stencil, words, height, width, block_h, ghosts, y0, image_h)
    device = words[0].device
    if device.type == "cpu":
        return _group_plain_stack(pointwise, stencil, words, height, width, block_h, ghosts, y0,
                                  image_h)
    tops, bots = ghosts if ghosts is not None else ([], [])
    for p in [*words, *tops, *bots]:
        if not p.is_contiguous():
            raise ValueError("T1 takes contiguous word planes")
    wp = width // 4
    n, in_stride, out_stride = packed_batch_geometry(words[0].shape[0], height, wp)
    n_out = chain.c_out
    outs = [torch.empty((n, height, wp), dtype=I32, device=device) for _ in range(n_out)]
    planes = kr.PkPlanes()
    for field, tensors in (("in_", words), ("top", tops), ("bot", bots), ("out", outs)):
        getattr(planes, field)[: len(tensors)] = [t.data_ptr() for t in tensors]
    planes.in_stride, planes.out_stride = in_stride, out_stride
    lib = kr.load("packed_stream")
    n_in = len(words)
    table = chain.ptr(device)
    stream = ck.stream_handle(device)
    if stencil is None:
        key = "T1-pw"  # a contiguous stack is one flat run of n * height rows
        rc = lib.packed_pointwise_group_launch(
            ctypes.byref(planes), n * height, wp, n_in, n_out, table, chain.n_ops, device.index,
            stream)
    else:
        tile_w, run_h = shape
        if ghosts is None:
            key = "T1"
            rc = lib.packed_stream_launch(
                ctypes.byref(planes), height, wp, n_in, n_out, table, chain.n_ops,
                ctypes.byref(desc), tile_w, CHUNK_H, run_h, n, device.index, stream)
        else:
            key = "T1g"
            rc = lib.packed_stream_ghost_launch(
                ctypes.byref(planes), height, wp, n_in, n_out, table, chain.n_ops,
                ctypes.byref(desc), tile_w, CHUNK_H, run_h, int(y0), image_h, device.index,
                stream)
    ck._raise_on(rc, "packed_stream")
    ck.TOOL_LAUNCHES[key] += 1
    return outs


def run_group_packed_words(
    pointwise: list[PointwiseOp],
    stencil: StencilOp | None,
    words: list[torch.Tensor],
    height: int,
    width: int,
    *,
    block_h: int | None = None,
    ghosts: tuple[list[torch.Tensor], list[torch.Tensor]] | None = None,
    y0=None,
    image_h: int | None = None,
    batched: bool = False,
) -> list[torch.Tensor]:
    """T1: one group on (height, width/4) int32 word planes, one per
    channel, into word planes of the channel count after the chain; one
    launch. With ``batched=True`` the planes are (N, height, width/4)
    stacks, and the one launch takes every image (full mode on grid z,
    T1-pw as one flat run). `block_h` is the JAX block height: checked, and
    it sets nothing (the launch shape is ``packed_tile_shape``'s).
    ``ghosts=(tops, bots)`` runs ghost mode over a row-shard (one image):
    raw, pre-pointwise (halo, width/4) word strips per input plane, the
    tile's first row being global row `y0` of an image `image_h` rows high.
    A plane may start at any word (a row slice of a larger one). The
    caller keeps to `packed_supported`; a group outside it raises."""
    return _stack_call(
        lambda ws: _group_words_stack(pointwise, stencil, ws, height, width, block_h, ghosts, y0,
                                      image_h),
        words, batched)


def run_group_packed(
    pointwise: list[PointwiseOp],
    stencil: StencilOp | None,
    planes: list[torch.Tensor],
    *,
    block_h: int | None = None,
    ghosts: tuple[list[torch.Tensor], list[torch.Tensor]] | None = None,
    y0=None,
    image_h: int | None = None,
    batched: bool = False,
) -> list[torch.Tensor]:
    """T1 on (H, W) u8 planes in and out ((N, H, W) with ``batched=True``);
    the words are views at the call's boundary. ``ghosts=(tops, bots)``:
    raw (halo, W) u8 strips per input plane, packed like the planes."""
    height, width = planes[0].shape[-2:]
    gw = None
    if ghosts is not None:
        gw = tuple([pack_words(s) for s in strips] for strips in ghosts)
    outs = run_group_packed_words(
        pointwise, stencil, [_pack(p) for p in planes], height, width, block_h=block_h,
        ghosts=gw, y0=y0, image_h=image_h, batched=batched,
    )
    return [_unpack(o, width) for o in outs]


@takes_stack
def pipeline_packed(ops, stack: torch.Tensor, *, block_h: int | None = None) -> torch.Tensor:
    """The archival packed runner over one image, or a stack of same-shape
    images with ``batched=True`` (the JAX runner under ``jax.vmap``): each
    group `packed_supported` takes runs on T1 in word form, one launch for
    the stack, consecutive ones staying words; the others run on the u8
    group runner (K1/K2, ``cuda_kernels.run_group``, which takes the stack
    on its batch axis too), as the JAX runner sends them to its u8
    streaming path. `block_h` is the u8 runner's tile height; T1 checks it
    and it sets nothing there. Same bytes as the golden ops, image by
    image; on a CPU tensor every group takes its plain version."""
    planes = _stack_planes(stack)
    words = None  # not None: the planes live as packed words
    height = width = None
    for pointwise, stencil in ck.group_ops(ops):
        if words is None:
            height, width = planes[0].shape[1:]
        if packed_supported(pointwise, stencil, width):
            if words is None:
                words = [_pack(p) for p in planes]
            words = run_group_packed_words(pointwise, stencil, words, height, width,
                                           block_h=block_h, batched=True)
            continue
        if words is not None:
            planes = [_unpack(w, width) for w in words]
            words = None
        planes = _stack_planes(ck.run_group(pointwise, stencil, _hwc(planes),
                                            block_h=block_h, batched=True))
    if words is not None:
        planes = [_unpack(w, width) for w in words]
    return _hwc(planes)
