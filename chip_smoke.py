#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``mpi_cuda_imagemanipulation_tpu_torch/
ops/csrc`` with nvcc (one process per source, all at once), then runs
twenty-one phases; any failure raises and the script exits non-zero without
printing a result:

1. Kernel against plain version on the card. K1 (pointwise group), K2
   (fused stencil group) and K4 (fused plan stage) must give the same
   bytes as their plain PyTorch versions: every kernel-safe pointwise op,
   every stencil of the registry at 1080x1920 RGB and at odd shapes, the
   reference pipeline's fused group; for K4 also multi-stencil stages that
   mix edge modes, stages that change the channel count mid-stage, a
   halo-0 stage, the megakernel and plan_ab chains, shapes just above the
   size gates and tile heights above 48 KB of shared memory. The ghost
   modes of the row-sharded runner, K2g (fused group over a shard with
   ghost strips), K3 (stencil over a pre-extended tile) and K4g (fused
   stage over an extended tile), run the same cases on tiles cut as the
   first, a middle and the last of three shards; K3 also on a tile with
   pad rows. K5, the tensor-core arm of K4/K4g, in both forms (bf16 and
   int8) against its plain version and the VPU arm: every eligible stencil
   of the registry, multi-stencil stages under the settings 'on' and
   'f32', the boundary filters of the exactness argument (255 * sum|w| =
   2^24 - 1; |w| = 127 and 128) on the extreme inputs where the sums are
   largest (all 0, all 255, 0/255 checkerboards), the three main stages at
   8K and on the first, a middle and the last 1080x7680 shard tile. K6
   (narrow and wide), K7 and K8, the SWAR kernels, in full and ghost mode:
   every eligible stencil of the registry and two custom integer filters
   (scale != 1; sum|w| = 128 with large negative taps), with no chain, a
   pre-chain, a post-chain and both, on seeded, all-0, all-255,
   checkerboard and row-ramp planes and on the first, a middle and the last
   1080x7680 shard tile of the 8K gray frame. A small input is also held
   against the loop-level emulator of the reference program
   (tests/_c_reference.py). The tools' kernels: T4's copies (u8, f32, u32
   words, u32 at full element count, f32 at the packed size) at every
   block height, its shared-memory copy and its bitcast pair, on the 8K
   plane, on 36/44/37-row planes (one 100 wide: the element path) and on
   all-0, all-255 and checkerboard planes; T2 and T3 on their JAX
   self-tests' shapes and tile heights (ragged ones too), on those planes
   and at 8K, T3 also against the golden gaussian:5, and the redesigned T3
   on both its paths: widths whose word count is no multiple of 4, ext
   words off a 16-byte boundary (the 8K plane too), rows narrower than one
   strip, one row, heights under one run and no multiple of it. Then the SWAR chains
   past the old limits: K6 after 17 and 40 fused steps, K8 with a 23x23
   filter (1058 tap words), and `run --impl swar` on a 17-step chain at 8K.
   T1, the packed-word group runner, in its three forms (T1-pw, T1, T1g):
   every group it takes in tests/test_packed.py's 33 specs at odd shapes
   (97x384, ragged heights, last blocks shorter than the halo, W/4 = 8 and
   W/4 < 128) and tile heights, flat and checkerboard planes, the first, a
   middle and the last 1080x7680 shard tile in ghost mode, the 8K gray
   gaussian:5 and the 8K RGB reference group; the redesigned T1 at heights
   of 1 to 2h + 1 rows around each chunk boundary (runs of whole images, at
   the default and at 5-row chunks), at widths of 8, 11 and 75 words with
   the planes starting at word offsets 0-3, on RGB chains into stencils and
   on ghost tiles at the top, middle and bottom; T1-pw (1 -> 1, 1 -> 3,
   3 -> 1, 3 -> 3) and T2 on planes of 1 to 1081 rows at ragged widths, at
   word offsets 0-3. The stream-stencil kernel's
   tile shapes: K3 on overlap bands of 1 to 2h + 1 output rows, K2g on
   shard tiles of h + 1 to 2h + 1 rows, K2 on short images and ragged last
   tiles, for a stencil of every family (the 5x5 median too) in every edge
   mode, gray and RGB, at widths that are no multiple of 16. Pointwise
   chains of 9, 17 and 40 ops (past the first design's 8) on K1, K2, K2g
   and T1 in its three forms. The redesigned K1 on 3 -> 1, 1 -> 3, 1 -> 1
   and 3 -> 3 chains at every input offset 0..15 and on tiny, ragged and
   8K images; K4 and K4g on stages of every halo 0..16, RGB rows and
   extended tiles at every start byte, and the long stages (26 and 82 ops,
   nine box:3, twelve box:1, twelve box:1 and a box:3, past the first
   K4's 24 ops and 8 stencils) with VPU and tensor-core arms. The
   redesigned K6, K7 and K8 on every SWAR stencil and K7 at 7x7 and 9x9, in
   every edge mode, at widths that are no multiple of 8 or 128, with rows
   at every start byte, in ghost mode at the image's top, middle and
   bottom; the redesigned K5 in both forms on one stencil of each side and
   the magnitude family in every edge mode, as a stage's last stencil and
   as an inner one, gray and RGB, and on the main stages at every start
   byte, K4 and K4g.
2. The main paths at full size: the `run` command's computation
   (cli.run_image) on the 8K RGB synthetic image, for the reference
   pipeline, gaussian:5 and the megakernel chain, under ``--plan off``
   (K1/K2 groups) and ``--plan fused-pallas`` (K4 stages), byte-equal to
   the golden ops, with each kernel's launches counted over each run. Then
   the row-sharded paths: ``Pipeline.sharded`` on the same frame over a
   4-slot mesh (slot i on card i modulo the number of cards, so all on the
   one card here), under both plans and both halo modes, and once at 4323
   rows (one pad row) to drive K3, byte-equal to golden, with the launches
   and strip exchanges the code implies and no full-mode launch. Then the
   SWAR backend (``--impl swar``): the five 8K workloads of its slice with
   their launches (K1, K6, K7, K8, and K2 for the colour gaussian:5), and
   ``Pipeline.sharded(backend='swar')`` on the 8K gray frame: one K7g, K6g
   or K8g per shard and one exchange round per group, no SWAR launch at
   4323 rows or under overlap. The whole-op `--impl mxu` route on images
   within a median's halo: the golden op, counted. Then the tools' entry
   points in-process (`roofline_probe --quick`, with T1 on gaussian:5, the
   `packed_proto` self-test, `swar_proto --quick`, `packed_ab`, which drives
   T1-pw, T1, T2, K1 and K2), each with its launches counted, their records
   printed; and T1g's path, the 8K gray gaussian:5 as four packed shards with
   ghost strips, stitched and equal to golden. The long stages through
   `run --plan fused-pallas` (one K4 launch each, and the gray -> RGB
   stage) and sharded (one K4g per shard; a halo-0 stage goes to the
   per-group path, uncounted, as in the JAX runner).
3. Numbers: CUDA-event times of each kernel and its plain version at the
   main paths' shapes (the ghost modes at the 1080x7680 shard), the bound
   from bytes and operations, a PyTorch library call as a yardstick where
   one computes the same function, the strip exchange, and each path end
   to end under both plans, sharded beside unsharded; K5 per form beside
   the VPU arm, and the tensor-core paths end to end; K6, K7 and K8 on the
   SWAR paths' groups (8K gray plane, and ghost mode on one shard) beside
   K2 on the same group, and the SWAR paths end to end; T4's kernels at the
   probe's 8K shapes beside `copy_`, the probe's copy rates as a share of
   3.35 TB/s, T2 at 8K beside K1 on the same group, T3 at 8K beside K6
   narrow and K2 on the same plane (its bound the larger of its bytes and
   its counted integer instructions; its registers, spills and SASS loops
   printed); T1 on the 8K gray gaussian:5 beside K2
   and `F.conv2d`, T1g on one shard beside K2g, T1-pw
   on packed_ab's group beside K1. For the K1, K4, K4g and K5 rows (K1 also on quantize:6 over
   the 8K gray plane), the stream-stencil rows (K2 on the 8K groups, K2g,
   K3 on the band and on emboss:3) and T4's copies also the split of one
   call: device time from CUDA events around one call queued behind a spin
   kernel, the wrapper's host time, CUDA events back to back, and the same
   for the library call; K2 by tile height. The K6, K7 and K8 rows (8K
   and one shard) are split the same way, and timed at each tile height
   the SWAR picker chooses from.

4. The rest of the registry: the geometric ops (flips, quarter turns,
   transpose, crop, pad, resize, scale, rotate) and the global-statistics
   ops (equalize, autocontrast, otsu), plain tensor ops between the
   kernels. `Pipeline.jit` on the 8K RGB frame under ``--impl cuda --plan
   off`` and ``--impl swar`` (``grayscale,equalize,gaussian:5`` also under
   ``fused-pallas`` and ``fused-pallas-mxu``), with exactly the launches of
   the kernels before and after them, byte-equal to the golden ops on the
   card, and the same route's card and CPU results equal at 1080x1920;
   ``tools.packed_kernels.pipeline_packed`` on ``rot:90,gaussian:5`` (one
   T1 launch); ``Pipeline.sharded`` over the 4-slot mesh at 4320 and 4323
   rows. Each path's device ms, launches and bytes bound are printed.

5. Calibration and ``auto`` routing, with a calibration store in a
   temporary directory (the earlier phases run with an empty one, wherever
   the script runs): ``autotune`` in-process on the 8K frame for each
   dimension (``block`` with ``--impl cuda`` and ``--impl swar`` on
   gaussian:5, ``backend`` on gaussian:5,emboss:3,sharpen, ``plan`` on the
   reference and megakernel_ab pipelines), each lane's ms and the records
   printed; then the three 8K workloads through ``Pipeline.jit(backend=
   'auto', plan='auto')`` with an empty store (the launches of ``cuda
   --plan off``), with the recorded store (the launches of the recorded
   choice) and under ``MCIM_PREFER_SWAR=1`` (the launches of ``swar``),
   each byte-equal to golden with its device ms, and the host enqueue ms
   of ``auto`` beside ``cuda``; ``Pipeline.sharded(backend='auto')`` over
   the 4-slot mesh in the same three states; and an armed
   ``halo.exchange`` failpoint, which must raise.

6. The randomized differential soak (tools/soak.py) on the card: 1000
   trials from seed 0, the sharded lanes over 4 slots of the one card,
   every lane byte-equal to the golden ops on the card; it fails on any
   REPRO line, on a lane no trial reached (xla, pallas, packed,
   swar-plane, swar, sharded under each of torch / cuda / auto / swar, and
   the plan lane's fused-pallas, fused-pallas-mxu, mxu and sharded
   fused-pallas, the sharded SWAR gray-plane lane, batched under torch and
   cuda, the 2-D mesh and data-parallel) and on a kernel the soak never
   launched (K1, K2, K2g, K3, K4, K4g, K5, K6, K7, K8, K6g, K7g, K8g, T1,
   T1-pw; T1g has no route to soak: no entry point runs the packed runner
   sharded, and phase 2's stitch holds it), and when the batched-cuda lane
   launched no batched K1 or K2; it prints the trials, the lane counts, the
   launches by kernel (and the stack lanes' own) and the wall time.

7. Tracing: `run --trace-out --show-timing` on the 8K reference (a PNG
   in a temporary directory), twice traced and twice not, in turns: the
   spans run, run.load, run.compile_and_run, run.steady and run.save with
   their parent links, run.steady and run.compile_and_run at least the
   path's device time (CUDA events) and run.steady's one synchronised call
   at least 0.9 of it, and the steady device time traced beside untraced;
   then the sharded dispatch span under run.compile_and_run (`run --shards
   4` with four cards, else Pipeline.sharded over the 4-slot mesh of one
   card under the same two spans), and the device and host enqueue time
   of that sharded path with the tracer armed and disarmed.

8. The flight recorder: `run` with ``--failpoints io.decode=always`` exits
   2, and ``recorder.dump("manual", force=True)``, written under
   ``MCIM_RECORDER_DIR`` (a temporary directory for the whole script),
   holds the failpoint entry and the run's WARNING line.

9. The online store's newest-wins rule: in phase 5's store, an offline
   ``plan_choice`` and an online ``promoted`` record that disagree for the
   8K reference under the card's kind, each newer in turn; `run`'s
   computation (gray output) under ``--impl auto --plan auto`` launches
   exactly what the newer record names, equal to golden, and
   ``mcim_tune_stale_overrides_total`` rises by one.

10. The batch axis (grid z) of the redesigned kernels, through the same
   launch entry as one image: K2 (every family and edge mode, prologues
   that change the channel count), K1 as one flat run, K4 on the VPU arm
   and with K5 in each form, K6 narrow and wide, K7 and K8, each on stacks
   of N = 1, 2 and 3 small images (sub-halo, odd widths), equal to its
   plain version image by image; a non-contiguous stack is refused by each
   wrapper and made contiguous by ``Pipeline.batched``.

11. The batched main paths: a stack of 4 frames of the 8K RGB synthetic
   (seeds 0-3) through ``Pipeline.batched`` under cuda --plan off,
   fused-pallas, fused-pallas-mxu, mxu, swar and auto for the three
   workloads (and the SWAR gray workloads under swar; auto with phase 5's
   recorded store, since with none it is cuda --plan off), each image equal to
   ``Pipeline.parse(spec)(image)``, the launches equal to one image's (one
   launch per group per stack), device ms per stack and per image beside 4
   single calls; then the batched kernels' rows of the ``kernels`` line
   (K2, K4, K4 with K5, K1 flat, K6 narrow and wide, K7, K8), each bound
   counting all four frames.

12. ``Pipeline.data_parallel``: 5 frames of 8K over the 4-slot mesh of the
   one card, equal per image, host ms beside the same stack batched.

13. The 2-D tile-sharded runner (parallel/api2d.py) over a 2 x 2 mesh of
   the one card: the 8K reference and gaussian:5 under torch and auto,
   serial and overlap, plan fused, equal to golden with rounds on both
   axes; host ms beside the 1-D 4-slot runner on the same torch ops.

14. The device-hang guard: ``run --impl cuda`` on the 8K reference (a PNG
   in a temporary directory) in a subprocess, unguarded and with
   ``--device-timeout 300``, the outputs equal, both wall times beside the
   child's two windows; a 0.01 s budget exits 4.

15. T1's batch axis: T1 full mode (every stencil group of tests/test_packed.py's
   specs that T1 takes: every edge mode, gray and RGB) and T1-pw (1 -> 1,
   3 -> 1, 3 -> 3, 1 -> 3) on stacks of N = 1, 2 and 3 small images
   (heights just above the halo, word widths 8, 11, 75, 33 and 65) through
   the same launch entry as one image, each equal to its plain version
   image by image with one launch a stack; ``pipeline_packed`` on a
   non-contiguous source stack; then ``pipeline_packed`` over 4 8K gray
   planes (gaussian:5): equal to golden per image, one T1 launch, ms a frame
   beside one frame's call, and the batched T1 row of the ``kernels`` line.

16. The engine (engine/core.py) on the card: 64 dispatches of the 8K
   reference, each a fresh frame, through ``Engine(inflight=3)`` with
   ``device_stager`` and ``Pipeline.jit(donate=True)``, every output equal
   to golden (SHA-256 of the bytes): the staged buffers' ``record_stream``
   under load; the stage percentiles and ``device_idle_frac``; inflight 1
   and 2 with each output written as a PGM; what pinning a 99.5 MB buffer
   costs, and the frame's H2D and D2H, pinned and pageable.

17. CLI ``batch`` at 8K: 6 frames of the 8K RGB synthetic as PPM (the
   native codec, its counters asserted) and 2 as PNG, the reference
   through ``cuda --plan off``, ``auto``, ``swar``, ``fused-pallas-mxu``,
   ``--stack 3``, ``--shards 4`` and ``--stack 4 --shards 4`` (the 4-slot
   mesh of the one card) over the PPM files and ``cuda --plan off`` over
   the PNG files, each at ``--inflight`` 1 and 2: every output file equal
   to golden, each run's end-to-end MP/s and device idle share as
   ``--show-timing`` prints them.

18. The streaming tile engine (stream/): the 8K frame through
   ``stream_pipeline`` in 512-row bands for the reference and megakernel_ab
   chains, inflight 1 and 2 x impl torch and mxu x plan off and fused, into
   an ``ArrayTileWriter``, and to a PNG and a PGM file; ``stream
   --synthetic 100000x4096`` (1.23 GB RGB, never whole on the host) and
   25000x4096 to a PGM, each by SHA-256 against the golden of the whole
   frame on the card, the host peak against ``stream/runner.resident_bound``
   (one bound for both heights: flat) and the frame, the card's allocator
   peak, MP/s and ``device_idle_frac``; 6 8K frames as video under ``framediff`` and
   ``tdenoise:3`` before ``grayscale,gaussian:5``; ``batch --stream-rows
   512`` over two 8K PPM frames, its files byte-equal to ``batch``'s;
   ``obs/cost.attribute_plan(pallas=True)`` on the reference and
   megakernel_ab plans at 8K (one K4 launch a stage, drift in the band,
   ``temp_bytes`` beside the torch walker's); a ``stream`` killed by the
   ``stream.tile`` failpoint at tile 5, then ``--resume``: the file equal
   to golden with only the missing tiles run.

19. Online serving (serve/), which runs no kernel of its own (the
   bucket-padded executor is the golden ops' gathers, as in the JAX
   package): (a) ``make_serving_fn`` under backends torch, mxu and auto x
   plans off, fused-pallas-mxu and auto, on the reference, megakernel_ab
   and ``grayscale,equalize,gaussian:5`` chains (RGB) and one stencil per
   edge mode (gray), each on a batch of 8 images of 8 true shapes in the
   2048 and 4096 buckets: every crop equal to the golden ops on the card,
   which ``Pipeline.jit(backend='cuda')`` also equals (but on the zero-mode
   stencil, which K2 does not take); (b) a ServeApp at the
   JAX package's hardware serve_loadgen settings (reference, buckets
   512/1024/2048, max_batch 8, max_delay_ms 4, queue_depth 256) under 64,
   256 and 1024 requests/s offered open-loop for 4 s each over 48
   mixed_shapes images: every completed response equal to its golden, no
   first call after warmup, and per rate the completed and shed counts,
   e2e p50/p95/p99, occupancy, the device's idle share and MP/s, then the
   devmem gauges; (c) ``serve`` in a subprocess with its default buckets
   (512-4096): PNG requests equal to golden, ``/healthz``, ``/stats``,
   ``/metrics``, SIGTERM drains and exits 0; (d) a transient
   ``serve.dispatch`` fault rate (retried responses equal to golden) and an
   open breaker's degraded golden fallback.

20. The pipeline-graph service, the systolic runner and profiling, which
   run no kernel of their own (graph segments and systolic groups run the
   stage walker, as the JAX package's run XLA): (a) an unsharp DAG (a
   gaussian tap read twice, subtract and blend merges, histogram and stats
   outputs) on the 8K RGB frame under impl torch and mxu, equal to the
   golden ops composed by hand, and the reference chain as a linear DAG
   equal to ``Pipeline.jit(backend='cuda')`` byte for byte, timed beside
   the chain's cuda and torch routes; (b) ``parallel/systolic.py`` with
   megakernel_ab's chain after its grayscale on the 8K gray plane over 2
   and 4 slots of the one card (tile_rows 540), equal to the unsharded
   cuda route, one band copy per stage boundary and tile, timed beside it;
   (c) a ``Server`` with the graph service: two tenants (interactive,
   batch) on the unsharp DAG, ``multi_tenant_run`` at 64 requests/s for 4
   s over mixed_shapes up to 512 x 512, every ok response equal to its
   golden, the per-tenant ok, shed and p99, the service's dispatch time
   and sheds by reason, the engine's stage means; (d) under that traffic
   ``POST /control/profile`` (started on a handler thread): the summary's
   device kernels and DMA share, and a second call answered 429; then
   ``run --profile-dir`` on the 8K frame, whose trace holds the card's
   kernels.

21. The serving fabric (fabric/), whose replicas serve the padded
    executor's golden ops (JAX's serve XLA) and whose mesh lane runs the
    ghost-mode kernels: (a) ``MeshLane`` on the 8K RGB reference frame over
    4 slots of the card under backends cuda (K2g serial; K1 and three K3 a
    shard under overlap, counted) and torch, each equal to
    ``Pipeline.jit(backend='cuda')``, host and device ms; (b) ``Fabric``
    with 3 replica processes on the card (buckets 512-4096, channels 1,3)
    and the mesh lane (cuda, serial): each replica's seconds from spawn to
    its first heartbeat and its device memory; 16 mixed-shape requests over
    the whole bucket grid and the 8K frame (as PPM, answered by "mesh")
    through the router, every response equal to ``Pipeline.jit(backend=
    'cuda')``, the launches of that run; a live video session
    (``tdenoise:3,grayscale,contrast:3.5``) whose replica a churn run
    SIGKILLs: ok fractions before, during and after, the respawn's seconds,
    the ``replica_death`` dump, the session's second half failed over and
    every frame equal to the rings + cuda golden; the federated /metrics
    against the sum of the replicas' ``/fleet/snapshot`` with their
    ``mcim_devmem_*`` gauges, ``/slo``, and one ``POST /control/profile``
    through the router under load; (c) then, with (b)'s pod idle, the
    throughput lane: ``fabric --replicas 1`` and ``serve --replicas 3``,
    each a process group of its own started beside (b)'s pod, on the JAX
    fabric_loadgen lane's settings (five bucket keys up to 512, shed
    fraction 0.25), loaded from three client processes (``chip_smoke.py
    --fabric-client``) at 96 and 128 rps for 4 s: ok, shed, p50/p99,
    achieved rps, requests by replica, CPU cores by process, each replica
    engine's idle share and the card's, each replica's dispatches and
    p50s; SIGTERM drains each pod to exit 0; (d) the ``kernels`` rows of
    the mesh lane's K2g, K1 and K3 at its shard shapes.

The native codec is built from the checkout like the kernels, and a kernel
or the codec that fails to build or launch fails its phase: nothing falls
back. It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
# dense tensor-core peaks, H100 SXM data sheet: bf16 operations, int8
H100_TC_OPS_PER_S = {"mxu": 989e12, "mxu-int8": 1979e12}
# 32-bit integer instructions: 64 INT32 lanes an SM a clock (Hopper
# architecture white paper's SM), 132 SMs, 1.98 GHz (the clock of the data
# sheet's 67 TFLOP/s float32)
H100_INT32_OPS_PER_S = 64 * 132 * 1.98e9
# T3's integer instructions per output word and row, counted from the
# arithmetic (swar_proto.cu's header): field splits 2, row passes 8, column
# cascades 8, rounds and repack 8
T3_INT_OPS_PER_WORD = 26
MAIN_H, MAIN_W = 4320, 7680  # the 8K frame of the gaussian5_8k workload
SPECS = {
    "reference": "grayscale,contrast:3.5,emboss:3",
    "gaussian5_8k": "gaussian:5",
    # the JAX package's megakernel A/B lane (bench_suite.megakernel_ab_params)
    "megakernel_ab": "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6",
}
PLANS = ("off", "fused-pallas")
# quantize:6 keeps the top six bits of a u8: x & 0xFC, the library yardstick
# of K1's quantize:6 rows
QUANTIZE6_MASK = 0xFC
HALO_MODES = ("serial", "overlap")
N_SHARDS = 4  # 1080 x 7680 shards of the 8K frame
PAD_H = 4323  # over 4 shards: 1081 rows each, one pad row in the last
POINTWISE_CASES = [
    "grayscale", "grayscale601", "sepia", "contrast:3.5", "contrast:3",
    "brightness:20", "brightness:-7.5", "invert", "threshold:100",
    "posterize:3", "quantize:6", "solarize:100", "gray2rgb",
    "sepia,invert,brightness:9,grayscale,contrast:3.5,threshold:90,gray2rgb,solarize:60",
]
STENCIL_CASES = [
    "emboss:3", "emboss:5", "emboss101:3", "emboss101:5", "gaussian:3",
    "gaussian:5", "gaussian:7", "box:1", "box:3", "box:5", "sobel", "prewitt",
    "scharr", "sharpen", "unsharp", "laplacian:4", "laplacian:8",
    "filter:1/2/1/2/4/2/1/2/1:0.0625", "filter:0.1/0.2/0.1/0.2/0.3/0.2/0.1/0.2/0.1",
    "filter:" + "/".join(str(v) for v in range(-24, 25)) + ":0.01",
    "erode:3", "erode:5", "dilate:3", "dilate:7", "median:3", "median:5",
]
FUSED_CASES = [
    "grayscale,contrast:3.5,emboss:3", "sepia,gaussian:5", "grayscale,gaussian:5",
    "invert,brightness:-20,median:5", "grayscale,gray2rgb,sobel",
    "grayscale601,contrast:3,emboss101:3",
]
# K4 stages beyond the one-stencil ones: several stencils with mixed edge
# modes, channel counts that change mid-stage, halo 0, the main chains
STAGE_CASES = [
    "gaussian:5,sharpen", "emboss:3,gaussian:5", "median:3,sobel,box:3",
    "gaussian:7,gaussian:7,gaussian:7,gaussian:7,gaussian:7",
    "erode:3,dilate:5,median:5", "emboss:5,emboss:3,emboss101:3",
    "box:1,invert,box:1", "grayscale,contrast:3.5,emboss:3,gray2rgb,gaussian:5",
    "grayscale,gaussian:3,gray2rgb,sharpen,sepia", "sepia,gaussian:3,grayscale,sobel",
    "sepia,median:3,invert,emboss:3", "gray2rgb",
    "grayscale,contrast:3.5,emboss:3", "grayscale,contrast:3.5,gaussian:5,quantize:6",
    SPECS["megakernel_ab"],
]
SHAPES = [(1080, 1920), (37, 53), (257, 301)]
# the JAX package's boundary filters (tests/test_mxu_backend.py): 255 *
# sum|w| = 2^24 - 1, the largest exact sum; |w| = 127, the int8 operand
# bound, and 128, just past it (the bf16 form only); then taps that cancel,
# whose sum on a plane constant along rows is the pixel itself, inside
# 0..255, after partial sums of 255 * 32640 (bf16) or 255 * 127 (int8)
BOUNDARY_FILTERS = [
    "filter:65280/512/1/0/0/0/0/0/0:1.0", "filter:127/1/0/0/0/0/0/0/0:1.0",
    "filter:128/1/0/0/0/0/0/0/0:1.0", "filter:32640/-32640/1/0/0/0/0/0/0:1.0",
    "filter:127/-127/1/0/0/0/0/0/0:1.0",
]
# the stencils whose raw sums the probe holds against the exact ones
PROBE_CASES = BOUNDARY_FILTERS + ["gaussian:7", "gaussian:5", "sobel", "laplacian:8",
                                  "emboss:5", "sharpen"]
# a fused stage K4 rejects ('lut-op')
REJECTED_SPEC = "gamma:2.2,gaussian:5"
# the SWAR slice's 8K workloads: (pipeline, the launches of one `run`)
SWAR_SPECS = {
    "reference": (SPECS["reference"], {"K1": 2, "K7": 1}),
    "megakernel_ab": (SPECS["megakernel_ab"], {"K1": 3, "K6-narrow": 1, "K7": 1}),
    "gaussian7_gray": ("grayscale,gaussian:7", {"K1": 2, "K6-wide": 1}),
    "sobel_gray": ("grayscale,sobel", {"K1": 2, "K8": 1}),
    "gaussian5_8k": (SPECS["gaussian5_8k"], {"K2": 1}),  # colour: the whole group falls back
    # the redesigned K6 and K8 forms on gray frames: bare narrow, wide on
    # fields, K8 on fields with scharr's largest sums and on lanes
    "gaussian5_gray": ("grayscale,gaussian:5", {"K1": 2, "K6-narrow": 1}),
    "box5_gray": ("grayscale,box:5", {"K1": 2, "K6-wide": 1}),
    "scharr_gray": ("grayscale,scharr", {"K1": 2, "K8": 1}),
    "unsharp_gray": ("grayscale,unsharp", {"K1": 2, "K8": 1}),  # K8 on lanes, side 5
}
# the sharded SWAR paths on the 8K gray frame: pipeline -> ghost kernel
SWAR_SHARDED = {"contrast:3.5,emboss:3": "K7g", "gaussian:5": "K6g-narrow", "sobel": "K8g"}
# every stencil a SWAR kernel takes: the registry's, a K8 filter with scale
# != 1 and a K7 filter at its bias bound (sum|w| = 128, large negative taps)
SWAR_STENCILS = [
    "gaussian:3", "gaussian:5", "gaussian:7", "box:3", "box:5", "box:9", "emboss:3",
    "emboss:5", "emboss101:3", "emboss101:5", "sharpen", "laplacian:4", "laplacian:8",
    "sobel", "prewitt", "scharr", "unsharp", "filter:1/2/1/2/4/2/1/2/1:0.0625",
    "filter:-60/-4/0/0/1/0/0/0/63",
]
SWAR_CHAINS = [((), ()), (("contrast:3.5",), ()), ((), ("brightness:-20",)),
               (("invert", "brightness:-20"), ("contrast:3.5",))]
SWAR_SOURCE = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/swar_stencil.cu"
SWAR_REPLACES = {"K6": "mpi_cuda_imagemanipulation_tpu/ops/swar_kernels.py:454",
                 "K7": "mpi_cuda_imagemanipulation_tpu/ops/swar_kernels.py:798",
                 "K8": "mpi_cuda_imagemanipulation_tpu/ops/swar_kernels.py:652"}
K5_SOURCE = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/mma_stage.cuh"
K5_REPLACES = "mpi_cuda_imagemanipulation_tpu/ops/mxu_kernels.py:853"
K5_KEYS = {"mxu": "K5-bf16", "mxu-int8": "K5-int8"}


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def gpu_utilization() -> float | None:
    """The card's utilization.gpu percentage as nvidia-smi reads it (the
    share of the last sample period in which a kernel ran, from any
    process), or None where nvidia-smi cannot answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def split_group(spec):
    from mpi_cuda_imagemanipulation_tpu_torch.ops.cuda_kernels import group_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops

    groups = group_ops(make_pipeline_ops(spec))
    assert len(groups) == 1, f"{spec} is not one kernel group"
    return groups[0]


def input_for(pointwise, shape, seed, device):
    """A seeded image for the group: the channels its first op needs, else
    RGB, or gray for odd seeds."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image

    first = next((op.in_channels for op in pointwise if op.in_channels), 0)
    img = synthetic_image(*shape, channels=first or (1 if seed % 2 else 3), seed=seed)
    return torch.from_numpy(img).to(device)


def check_equal(name, got, want):
    import torch

    if got.shape != want.shape or not torch.equal(got, want):
        err = (got.int() - want.int()).abs().max().item() if got.shape == want.shape else None
        raise AssertionError(f"{name}: kernel != plain (shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, max abs err {err})")
    return 0


def phase1(device) -> int:
    """Every kernel case against its plain version; returns the case count."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck

    # the wrappers' stream handle is the current stream's, on a side stream too
    side = torch.cuda.Stream(device)
    for stream in (torch.cuda.current_stream(device), side):
        with torch.cuda.stream(stream):
            assert ck.stream_handle(device) == torch.cuda.current_stream(device).cuda_stream
    n = 0
    for spec in POINTWISE_CASES:
        pw, st = split_group(spec)
        assert st is None
        for seed, shape in enumerate(SHAPES):
            x = input_for(pw, shape, seed, device)
            check_equal(f"K1 {spec} {shape}", ck.pointwise_group(pw, x),
                        ck.pointwise_group_plain(pw, x))
            n += 1
    for spec in STENCIL_CASES + FUSED_CASES:
        pw, st = split_group(spec)
        for seed, shape in enumerate(SHAPES):
            x = input_for(pw, shape, seed, device)
            want = ck.stream_stencil_plain(pw, st, x)
            check_equal(f"K2 {spec} {shape}", ck.stream_stencil(pw, st, x), want)
            n += 1
            if seed == 0:  # other tile heights, including one above 48 KB of smem
                for tile_h in (5, 48):
                    check_equal(f"K2 {spec} {shape} tile_h={tile_h}",
                                ck.stream_stencil(pw, st, x, tile_h=tile_h), want)
                    n += 1
    n += phase1_k4(device)
    n += phase1_ghost(device)
    n += phase1_stencil_shapes(device)
    n += phase1_long_chains(device)
    n += phase1_redesign(device)
    print(f"phase 1: {n} kernel cases equal to their plain versions (max_abs_err 0)")
    return n


# the stream-stencil kernel's tile shapes: one stencil of every family (the
# 5x5 median too) and halo 0..3, in every edge mode, gray and RGB, at
# widths that are no multiple of 16 and at the frame's width
SHAPE_STENCILS = ["gaussian:5", "emboss:3", "sobel", "erode:5", "dilate:3", "median:3",
                  "median:5", "gaussian:7", "box:1", "sharpen"]
SHAPE_WIDTHS = (301, 7677, MAIN_W)
EDGE_MODES = ("interior", "reflect101", "edge", "zero")


def phase1_stencil_shapes(device) -> int:
    """K2, K2g and K3 on the redesigned kernel's tile shapes against their
    plain versions: K3 on overlap bands of 1 to 2h + 1 output rows (the
    2- and 32-column tiles of a band), K2g on shard tiles of h + 1 to
    2h + 1 rows at the first, a middle and the last shard, K2 on images of
    1 to 2h + 1 rows and on ragged last tiles (37 and 130 rows); every
    stencil of SHAPE_STENCILS in every edge mode K2/K2g take (K3 also
    zero), gray and RGB, at SHAPE_WIDTHS. Returns the case count."""
    import dataclasses

    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import api

    def img(h, w, c, seed):
        return torch.from_numpy(synthetic_image(h, w, channels=c, seed=seed)).to(device)

    n = 0
    for spec in SHAPE_STENCILS:
        base = make_op(spec)
        h = base.halo
        for mode in EDGE_MODES:
            op = dataclasses.replace(base, edge_mode=mode)
            for c in (1, 3):
                for width in SHAPE_WIDTHS:
                    for rows in range(1, 2 * h + 2):
                        ext = img(rows + 2 * h, width, c, seed=rows + width)
                        check_equal(f"K3 {spec} {mode} band {tuple(ext.shape)}",
                                    ck.stencil_tile(op, ext), ck.stencil_tile_plain(op, ext))
                        n += 1
                    if mode == "zero" or width == MAIN_W:
                        continue
                    for rows in range(1, 2 * h + 2):  # K2 on short images
                        if mode == "reflect101" and rows <= h:
                            continue
                        x = img(rows, width, c, seed=rows)
                        check_equal(f"K2 {spec} {mode} {tuple(x.shape)}",
                                    ck.stream_stencil([], op, x), ck.stream_stencil_plain([], op, x))
                        n += 1
                    for rows, tile_h in ((37, None), (130, 48), (37, 5)):  # ragged last tiles
                        x = img(rows, width, c, seed=rows + 1)
                        check_equal(f"K2 {spec} {mode} {tuple(x.shape)} tile_h={tile_h}",
                                    ck.stream_stencil([], op, x, tile_h=tile_h),
                                    ck.stream_stencil_plain([], op, x))
                        n += 1
                    if h == 0:
                        continue
                    for local_h in range(h + 1, 2 * h + 2):  # K2g on short shard tiles
                        frame = img(3 * local_h, width, c, seed=local_h + width)
                        for k in range(3):
                            y0 = k * local_h
                            zeros = torch.zeros_like(frame[:h])
                            tile = frame[y0:y0 + local_h].contiguous()
                            top = frame[y0 - h:y0].contiguous() if k else zeros
                            bottom = frame[y0 + local_h:y0 + local_h + h].contiguous() if k < 2 \
                                else zeros
                            top, bottom = api._fix_edge_strips(top, bottom, tile, op, y0,
                                                               3 * local_h)
                            kw = dict(y0=y0, image_h=3 * local_h, image_w=width)
                            check_equal(f"K2g {spec} {mode} {tuple(tile.shape)} shard {k}",
                                        ck.stream_stencil_ghost([], op, tile, top, bottom, **kw),
                                        ck.stream_stencil_ghost_plain([], op, tile, top, bottom,
                                                                      **kw))
                            n += 1
    torch.cuda.synchronize()
    print(f"phase 1: K2, K2g and K3 on bands, short tiles and ragged tiles equal to their plain "
          f"versions: {n} cases")
    return n


# pointwise chains past the first design's 8-op limit
LONG_CHAINS = (9, 17, 40)
LONG_STEPS = ("brightness:3", "invert", "brightness:-5", "solarize:200")


def long_chain(n: int) -> str:
    return ",".join(LONG_STEPS[k % len(LONG_STEPS)] for k in range(n))


# stages K4 takes whatever their length (the first K4 held 24 ops and 8
# stencils); K1's chains by channel counts
LONG_STAGES = {
    "26 ops": "grayscale," + long_chain(12) + ",gaussian:5," + long_chain(12),
    "82 ops": "grayscale," + long_chain(40) + ",gaussian:5," + long_chain(40),
    "nine box:3": ",".join(["box:3"] * 9),
    "twelve box:1": ",".join(["box:1"] * 12),
    "twelve box:1 and box:3": ",".join(["box:1"] * 12 + ["box:3"]),
}
K1_CHAINS = {"3->1": "grayscale,contrast:3.5", "1->3": "gray2rgb", "1->1": "quantize:6",
             "3->3": "sepia,invert,brightness:-20"}


def halo_stage(r: int) -> str:
    """A stage of total halo r: 7x7 Gaussians (separable), then a 5x5 median
    or a 3x3 emboss for the rest; r = 0: two box:1 around an invert."""
    if r == 0:
        return "box:1,invert,box:1"
    ops = ["gaussian:7"] * (r // 3) + {0: [], 1: ["emboss:3"], 2: ["median:5"]}[r % 3]
    return ",".join(ops)


def unaligned(x, offset: int):
    """`x` copied into a fresh buffer at byte `offset`: a contiguous view
    whose first byte lies `offset` bytes past the allocation's start, as a
    shard view or a flushed region may."""
    import torch

    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def phase1_redesign(device) -> int:
    """The redesigned K1, K4 and K4g (and K5 in both forms on the long
    stages) against their plain versions: K1 on 3 -> 1, 1 -> 3, 1 -> 1 and
    3 -> 3 chains at every input offset 0..15 and on 1x1, 1x15, 3x17, 37x53,
    1080x1920 and 8K images; K4 on stages of every halo 0..16, gray and
    RGB, just above the height gate and at 257 x 1920, on RGB rows at every
    start byte; K4 and K4g on the long stages (26 and 82 ops, nine box:3,
    twelve box:1, twelve box:1 and a box:3) with VPU and tensor-core arms;
    K4g on the first, a middle and the last shard at every halo and on
    extended tiles at every start byte. Returns the case count."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo

    def img(h, w, c, seed):
        return torch.from_numpy(synthetic_image(h, w, channels=c, seed=seed)).to(device)

    # K1's split (pw_split in pointwise_run.cuh) is the host's mirror of it
    import ctypes

    from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr

    lib = kr.load("pointwise")
    split = (ctypes.c_longlong * 4)()
    for c_in, c_out in ((1, 1), (1, 3), (3, 1), (3, 3)):
        for n_pix in (1, 17, 4320 * 7680):
            for in_off in range(16):
                for out_off in (0, 7):
                    args = (4096 + in_off, 8192 + out_off, n_pix, c_in, c_out)
                    lib.pointwise_split(*args, split)
                    assert tuple(split) == ck.pointwise_split(*args), args
    n = 0
    for label, spec in K1_CHAINS.items():
        pw = list(make_pipeline_ops(spec))
        c_in = int(label[0])
        for seed, shape in enumerate([(1, 1), (1, 15), (3, 17), (37, 53), (1080, 1920),
                                      (MAIN_H, MAIN_W)]):
            x = img(*shape, c_in, seed)
            offsets = range(16) if shape == (37, 53) else (0, 3)
            for off in offsets:
                xo = unaligned(x, off)
                check_equal(f"K1 {label} {shape} offset {off}", ck.pointwise_group(pw, xo),
                            ck.pointwise_group_plain(pw, xo))
                n += 1
    for r in range(17):
        ops = make_pipeline_ops(halo_stage(r))
        for c in (1, 3):
            for seed, shape in enumerate([(2 * r + 1, 301), (257, 1920)]):
                x = img(*shape, c, r + seed)
                assert ck.fused_stage_reject(ops, *shape, c) is None, (r, shape)
                check_equal(f"K4 halo {r} {shape} c={c}", ck.fused_stage(ops, x),
                            ck.fused_stage_plain(ops, x))
                n += 1
            if not r:
                continue
            for k in range(3):
                tile, top, bottom, y0, image_h = shard_cut(ops, (3 * (2 * r + 3), 777), k, r + k,
                                                           device, r)
                if c == 1 and tile.ndim == 3:
                    tile, top, bottom = (t[..., 0].contiguous() for t in (tile, top, bottom))
                ext = torch.cat([top, tile, bottom]).contiguous()
                kw = dict(y0=y0, image_h=image_h, image_w=777)
                check_equal(f"K4g halo {r} shard {k} c={c}", ck.fused_stage_ext(ops, ext, **kw),
                            ck.fused_stage_ext_plain(ops, ext, **kw))
                n += 1
    for spec in (SPECS["megakernel_ab"], SPECS["gaussian5_8k"], SPECS["reference"],
                 "sepia,median:3,invert,emboss:3"):
        ops = make_pipeline_ops(spec)
        H = chain_halo(ops)
        x = img(37, 53, 3, 5)
        want = ck.fused_stage_plain(ops, x)
        tile, top, bottom, y0, image_h = shard_cut(ops, (3 * 40, 301), 1, 6, device, H)
        ext = torch.cat([top, tile, bottom]).contiguous()
        kw = dict(y0=y0, image_h=image_h, image_w=301)
        want_g = ck.fused_stage_ext_plain(ops, ext, **kw)
        for off in range(16):
            check_equal(f"K4 {spec} RGB rows at offset {off}",
                        ck.fused_stage(ops, unaligned(x, off)), want)
            check_equal(f"K4g {spec} extended tile at offset {off}",
                        ck.fused_stage_ext(ops, unaligned(ext, off), **kw), want_g)
            n += 2
    for label, spec in LONG_STAGES.items():
        ops = make_pipeline_ops(spec)
        H = chain_halo(ops)
        x = img(1080, 1920, 3, len(spec))
        for setting in ("vpu", "on", "f32"):
            arms = ("vpu",) * len(ops) if setting == "vpu" else ck.stage_arms(ops, setting)
            check_equal(f"K4 {label} arms={setting}", ck.fused_stage(ops, x, arms=arms),
                        ck.fused_stage_plain(ops, x, arms=arms))
            n += 1
            if not H:
                continue
            for k in range(3):
                tile, top, bottom, y0, image_h = shard_cut(ops, (1080, 1920), k, k, device, H)
                ext = torch.cat([top, tile, bottom]).contiguous()
                kw = dict(y0=y0, image_h=image_h, image_w=1920)
                check_equal(f"K4g {label} shard {k} arms={setting}",
                            ck.fused_stage_ext(ops, ext, arms=arms, **kw),
                            ck.fused_stage_ext_plain(ops, ext, arms=arms, **kw))
                n += 1
    torch.cuda.synchronize()
    print(f"phase 1: the redesigned K1, K4, K4g (and K5 on the long stages) equal to their "
          f"plain versions in {n} cases (max_abs_err 0)")
    return n


def phase2_long_stages(device) -> dict:
    """The long stages through the `run` computation under --plan
    fused-pallas at 1080 x 1920 RGB (one K4 launch each, and one more for
    the gray -> RGB stage after a gray result; no K1/K2, no fallback) and
    through `Pipeline.sharded` over the 4-slot mesh (one K4g per shard for a
    stage with a halo; a halo-0 stage is left to the per-group path,
    uncounted, as the JAX runner leaves it), equal to the golden ops.
    Returns the launches by case."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import run_image
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics

    mesh = sharded_mesh()
    launches = {}
    x = torch.from_numpy(synthetic_image(1080, 1920, seed=21)).to(device)
    for label, spec in LONG_STAGES.items():
        pipe = Pipeline.parse(spec)
        halo0 = label == "twelve box:1"
        # `run` replicates a gray result to RGB: a second, halo-0 K4 stage
        stages = 2 if ck.stage_program(pipe.ops, 3).c_out == 1 else 1
        for sharded in (False, True):
            ck.reset_launch_counts()
            plan_metrics.reset()
            if sharded:
                want = pipe.jit("torch", device=device, plan="off")(x)
                out = pipe.sharded(mesh, backend="cuda", plan="fused-pallas")(x)
            else:
                want = run_image(pipe, x, impl="torch", device=device, plan="off")
                out = run_image(pipe, x, impl="cuda", device=device, plan="fused-pallas")
            torch.cuda.synchronize()
            counts = {k: v for k, v in ck.launch_counts().items() if v}
            tag = f"{label} plan=fused-pallas{' sharded' if sharded else ''}"
            check_equal(tag, out, want)
            if sharded and halo0:
                expected_ok = "K4g" not in counts and plan_metrics.pallas_stages == 0
            elif sharded:
                expected_ok = counts == {"K4g": N_SHARDS} and plan_metrics.pallas_stages == 1
            else:
                expected_ok = counts == {"K4": stages} and plan_metrics.pallas_stages == stages
            if not expected_ok or plan_metrics.pallas_fallbacks:
                raise AssertionError(f"{tag}: launches {counts}, K4 stages "
                                     f"{plan_metrics.pallas_stages}, fallbacks "
                                     f"{dict(plan_metrics.pallas_fallbacks)}")
            launches[label, sharded] = counts
            print(f"phase 2: {tag} 1080x1920 RGB: cuda == golden, launches {counts}, "
                  f"K4 stages {plan_metrics.pallas_stages}, fallbacks 0")
    return launches


def phase1_long_chains(device) -> int:
    """K1, K2, K2g and T1 in its three forms (T1-pw, T1, T1g) on chains of
    9, 17 and 40 pointwise ops, alone and before gaussian:5, against their
    plain versions: 1080 x 1920 RGB and the 8K frame for K1/K2, the middle
    shard tile of a 3-shard 1080 x 1920 frame for K2g, 1080 x 1920 gray
    words for T1 and T1-pw, its second of four shard tiles for T1g.
    Returns the case count."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops

    n = 0
    rgb = torch.from_numpy(synthetic_image(1080, 1920, seed=9)).to(device)
    rgb8k = torch.from_numpy(synthetic_image(MAIN_H, MAIN_W, seed=10)).to(device)
    for steps in LONG_CHAINS:
        pw = list(make_pipeline_ops(long_chain(steps)))
        (pw5, st5), = ck.group_ops(make_pipeline_ops(long_chain(steps) + ",gaussian:5"))
        for x in (rgb, rgb8k):
            check_equal(f"K1 {steps} ops {tuple(x.shape)}", ck.pointwise_group(pw, x),
                        ck.pointwise_group_plain(pw, x))
            check_equal(f"K2 {steps} ops + gaussian:5 {tuple(x.shape)}",
                        ck.stream_stencil(pw5, st5, x), ck.stream_stencil_plain(pw5, st5, x))
            n += 2
        tile, top, bottom, y0, image_h = shard_cut(pw5, (1080, 1920), 1, steps, device, 2)
        kw = dict(y0=y0, image_h=image_h, image_w=1920)
        check_equal(f"K2g {steps} ops + gaussian:5", ck.stream_stencil_ghost(
            pw5, st5, tile, top, bottom, **kw), ck.stream_stencil_ghost_plain(
            pw5, st5, tile, top, bottom, **kw))
        gray = rgb[..., 1].contiguous()
        words = t1_words(gray)
        n += 1 + check_t1(f"T1 {steps} ops + gaussian:5", pw5, st5, words, 1080, 1920)
        n += check_t1(f"T1-pw {steps} ops", pw, None, words, 1080, 1920)
        gtile, gtop, gbot, gy0 = t1_ghost_tile(gray, 1, N_SHARDS, st5.halo)
        n += check_t1(f"T1g {steps} ops + gaussian:5", pw5, st5, t1_words(gtile.contiguous()),
                      gtile.shape[0], 1920, ghosts=(t1_words(gtop), t1_words(gbot)), y0=gy0,
                      image_h=1080)
    torch.cuda.synchronize()
    print(f"phase 1: K1, K2, K2g and T1 (T1-pw, T1, T1g) on chains of {LONG_CHAINS} pointwise "
          f"ops equal to their plain versions: {n} cases")
    return n


def k4_tile_heights(ops, c_in) -> list:
    """Tile heights to hold K4 at: the default, 5, and, for a stage that
    uses shared memory, the smallest whose 128-column block's shared memory
    exceeds 48 KB."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck

    prog = ck.stage_program(ops, c_in)
    if not prog.c_smem:
        return [None, 5]
    t = 1
    while ck.fused_stage_smem_bytes(c_in, prog.c_smem, t, 128, prog.halo, prog.table_bytes,
                                    prog.two_pass) <= 48 * 1024:
        t += 1
    return [None, 5, t]


def phase1_k4(device) -> int:
    """K4 on every stage case against fused_stage_plain, byte-equal."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo
    from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels as kr

    # the host's table and shared-memory layout are the source's
    lib = kr.load("fused_stage")
    for spec, c_in, tile_h, tile_w in ((SPECS["megakernel_ab"], 3, 16, 128), ("emboss:3", 1, 16, 32),
                                       (",".join(["box:3"] * 9), 3, 48, 64), ("box:1", 3, 200, 128)):
        prog = ck.stage_program(make_pipeline_ops(spec), c_in)
        assert lib.fused_stage_table_bytes(prog.n_ops, prog.n_stencils) == prog.table_bytes
        got = lib.fused_stage_smem_bytes(c_in, prog.c_smem, tile_h, tile_w, prog.halo,
                                         prog.n_ops, prog.n_stencils, int(prog.two_pass))
        assert got == ck.fused_stage_smem_bytes(c_in, prog.c_smem, tile_h, tile_w, prog.halo,
                                                prog.table_bytes, prog.two_pass), spec
    n = 0
    for spec in STENCIL_CASES + STAGE_CASES:
        ops = make_pipeline_ops(spec)
        halo = chain_halo(ops)
        max_op = max(op.halo for op in ops)
        shapes = list(SHAPES)
        if halo:  # just above the size gates: height > 2 halo, width > max op halo
            shapes += [(2 * halo + 1, 301), (257, max_op + 1), (2 * halo + 1, max_op + 1)]
        for seed, shape in enumerate(shapes):
            x = input_for(ops, shape, seed, device)
            c_in = 1 if x.ndim == 2 else 3
            reason = ck.fused_stage_reject(ops, *shape, c_in)
            assert reason is None, f"K4 {spec} {shape}: rejected ({reason})"
            want = ck.fused_stage_plain(ops, x)
            tiles = k4_tile_heights(ops, c_in) if seed == 0 else [None]
            for tile_h in tiles:
                check_equal(f"K4 {spec} {shape} tile_h={tile_h}",
                            ck.fused_stage(ops, x, tile_h=tile_h), want)
                n += 1
    print(f"phase 1: K4 equal to fused_stage_plain in {n} cases")
    return n


def shard_cut(ops, shape, k, seed, device, halo):
    """The tile of shard `k` of three of a seeded image `shape[0] // 3 * 3`
    rows high, with its raw ghost strips (zeros where there is no
    neighbour), its y0 and the image height."""
    import torch

    local_h = shape[0] // 3
    img = input_for(ops, (3 * local_h, shape[1]), seed, device)
    y0 = k * local_h
    zeros = torch.zeros_like(img[:halo])
    top = img[y0 - halo:y0] if k else zeros
    bottom = img[y0 + local_h:y0 + local_h + halo] if k < 2 else zeros
    return img[y0:y0 + local_h].contiguous(), top.contiguous(), bottom.contiguous(), y0, 3 * local_h


def phase1_ghost(device) -> int:
    """K2g, K3 and K4g against their plain versions on tiles cut as the
    first, a middle and the last of three shards."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import api

    n2 = n3 = n4 = 0
    for spec in STENCIL_CASES + FUSED_CASES:
        pw, st = split_group(spec)
        h = st.halo
        for i, shape in enumerate(SHAPES):
            for k in range(3):
                tile, top, bottom, y0, image_h = shard_cut(pw, shape, k, i + k, device, h)
                kw = dict(y0=y0, image_h=image_h, image_w=shape[1])
                if h >= 1 and tile.shape[0] > h:  # the gates of the fused-ghost path
                    ftop, fbot = api._fix_edge_strips(top, bottom, tile, st, y0, image_h)
                    want = ck.stream_stencil_ghost_plain(pw, st, tile, ftop, fbot, **kw)
                    for tile_h in ((None, 5, 48) if i == 0 and k == 1 else (None,)):
                        check_equal(
                            f"K2g {spec} {shape} shard {k} tile_h={tile_h}",
                            ck.stream_stencil_ghost(pw, st, tile, ftop, fbot, tile_h=tile_h, **kw),
                            want)
                        n2 += 1
                # K3 over the materialised tile, as the runner builds it; once
                # more with a pad row at the end of the last shard
                post = ck.pointwise_group_plain(pw, torch.cat([top, tile, bottom])) if pw else (
                    torch.cat([top, tile, bottom]))
                for pad in ((0, 1) if k == 2 else (0,)):
                    ext = api._fix_edge_rows(post, st, y0, image_h - pad).contiguous()
                    check_equal(f"K3 {spec} {shape} shard {k} pad={pad}",
                                ck.stencil_tile(st, ext), ck.stencil_tile_plain(st, ext))
                    n3 += 1
    for spec in STENCIL_CASES + STAGE_CASES:
        ops = make_pipeline_ops(spec)
        H = chain_halo(ops)
        for i, shape in enumerate(SHAPES):
            for k in range(3):
                tile, top, bottom, y0, image_h = shard_cut(ops, shape, k, i + k, device, H)
                c_in = 1 if tile.ndim == 2 else 3
                if ck.fused_stage_reject(ops, tile.shape[0], shape[1], c_in) is not None:
                    continue  # the tile is lower than 2 H + 1 rows: the runner's gate
                ext = torch.cat([top, tile, bottom]).contiguous()
                kw = dict(y0=y0, image_h=image_h, image_w=shape[1])
                want = ck.fused_stage_ext_plain(ops, ext, **kw)
                for tile_h in ((None, 5) if i == 0 and k == 1 else (None,)):
                    check_equal(f"K4g {spec} {shape} shard {k} tile_h={tile_h}",
                                ck.fused_stage_ext(ops, ext, tile_h=tile_h, **kw), want)
                    n4 += 1
    assert n2 and n3 and n4
    print(f"phase 1: ghost modes equal to their plain versions: K2g {n2}, K3 {n3}, K4g {n4} cases")
    return n2 + n3 + n4


def k5_forms(op) -> list:
    """The K5 forms `op` has: bf16 for every eligible correlation, int8 too
    where its taps are proven to fit."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import mxu_eligible, mxu_int8_ok

    if getattr(op, "reduce", None) != "corr" or not mxu_eligible(op):
        return []
    return ["mxu", "mxu-int8"] if mxu_int8_ok(op) else ["mxu"]


def extreme_inputs(shape, channels, device):
    """The inputs at which a stencil's sums reach 255 * sum|w| or its
    negative: all 0, all 255, and the two 0/255 checkerboards; then a plane
    constant along rows, on which the cancelling boundary filters give the
    pixel itself."""
    import torch

    h, w = shape
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    board = ((yy + xx) % 2 * 255).to(torch.uint8)
    planes = [torch.zeros(h, w, dtype=torch.uint8), torch.full((h, w), 255, dtype=torch.uint8),
              board, 255 - board, (yy * 37 % 256).to(torch.uint8)]
    out = []
    for p in planes:
        x = p if channels == 1 else p[..., None].expand(h, w, channels)
        out.append(x.contiguous().to(device))
    return out


def phase1_k5(device) -> int:
    """K5 in each form against its plain version (stage_valid_mxu_plain in
    the walker) and against the VPU arm: every eligible stencil of the
    registry and the boundary filters, on the seeded shapes and on the
    extreme inputs; multi-op stages under the settings 'on' and 'f32'; and
    K4g's form of each on tiles cut as the first, a middle and the last of
    three shards."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo

    cases = []  # (label, ops, arms)
    for spec in STENCIL_CASES + BOUNDARY_FILTERS:
        ops = make_pipeline_ops(spec)
        for arm in k5_forms(ops[0]):
            cases.append((f"{spec} {arm}", ops, (arm,)))
    for spec in STAGE_CASES:
        ops = make_pipeline_ops(spec)
        for setting in ("on", "f32"):
            arms = ck.stage_arms(ops, setting)
            if any(a != "vpu" for a in arms):
                cases.append((f"{spec} {setting}", ops, arms))
    n = n_ext = n_g = 0
    for label, ops, arms in cases:
        vpu = ("vpu",) * len(ops)
        inputs = [input_for(ops, shape, seed, device) for seed, shape in enumerate(SHAPES)]
        c = 3 if inputs[0].ndim == 3 else 1
        extremes = extreme_inputs((257, 301), c, device)
        for i, x in enumerate(inputs + extremes):
            want = ck.fused_stage_plain(ops, x, arms=arms)
            check_equal(f"K5 plain {label} input {i}", want, ck.fused_stage_plain(ops, x, arms=vpu))
            # other tile heights, including one above 48 KB of shared memory
            for tile_h in (k4_tile_heights(ops, c) if i == 0 else (None,)):
                check_equal(f"K5 {label} input {i} tile_h={tile_h}",
                            ck.fused_stage(ops, x, tile_h=tile_h, arms=arms), want)
                n += 1
            n_ext += i >= len(inputs)
        H = chain_halo(ops)
        for i, shape in enumerate(SHAPES[:1] + SHAPES[2:]):
            for k in range(3):
                tile, top, bottom, y0, image_h = shard_cut(ops, shape, k, i + k, device, H)
                if ck.fused_stage_reject(ops, tile.shape[0], shape[1], c) is not None:
                    continue
                ext = torch.cat([top, tile, bottom]).contiguous()
                kw = dict(y0=y0, image_h=image_h, image_w=shape[1])
                want = ck.fused_stage_ext_plain(ops, ext, arms=arms, **kw)
                check_equal(f"K5 (K4g) plain {label} {shape} shard {k}", want,
                            ck.fused_stage_ext_plain(ops, ext, arms=("vpu",) * len(ops), **kw))
                check_equal(f"K5 (K4g) {label} {shape} shard {k}",
                            ck.fused_stage_ext(ops, ext, arms=arms, **kw), want)
                n_g += 1
    assert n and n_ext and n_g
    print(f"phase 1: K5 equal to its plain version and to the VPU arm in {n} K4 cases "
          f"({n_ext} on extreme inputs) and {n_g} K4g cases")
    return n + n_g


def phase1_k5_main(device, x8k) -> int:
    """K5 at the main paths' shapes: the three stages at 8K and on the
    first, a middle and the last 1080x7680 shard tile, in both forms, and
    gaussian:5 and the 2^24 - 1 boundary filter on the extreme 8K inputs,
    each against its plain version and the VPU arm."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo

    n = 0
    local_h = MAIN_H // N_SHARDS
    for key, spec in SPECS.items():
        ops = make_pipeline_ops(spec)
        H = chain_halo(ops)
        vpu = ck.fused_stage(ops, x8k, arms=("vpu",) * len(ops))
        for setting in ("on", "f32"):
            arms = ck.stage_arms(ops, setting)
            want = ck.fused_stage_plain(ops, x8k, arms=arms)
            check_equal(f"K5 plain {key} {setting} 8K", want, vpu)
            check_equal(f"K5 {key} {setting} 8K", ck.fused_stage(ops, x8k, arms=arms), want)
            n += 1
            for k in (0, 1, N_SHARDS - 1):
                y0 = k * local_h
                ext = x8k[max(y0 - H, 0):y0 + local_h + H]
                if k == 0:
                    ext = torch.cat([torch.zeros_like(x8k[:H]), ext])
                if k == N_SHARDS - 1:
                    ext = torch.cat([ext, torch.zeros_like(x8k[:H])])
                ext = ext.contiguous()
                kw = dict(y0=y0, image_h=MAIN_H, image_w=MAIN_W)
                want = ck.fused_stage_ext_plain(ops, ext, arms=arms, **kw)
                check_equal(f"K5 (K4g) plain {key} {setting} shard {k}", want,
                            vpu[y0:y0 + local_h])
                check_equal(f"K5 (K4g) {key} {setting} shard {k}",
                            ck.fused_stage_ext(ops, ext, arms=arms, **kw), want)
                n += 1
        del vpu
    for spec in ("gaussian:5", BOUNDARY_FILTERS[0], BOUNDARY_FILTERS[3]):
        ops = make_pipeline_ops(spec)
        for x in extreme_inputs((MAIN_H, MAIN_W), 3, device):
            vpu = ck.fused_stage(ops, x, arms=("vpu",))
            for arm in k5_forms(ops[0]):
                want = ck.fused_stage_plain(ops, x, arms=(arm,))
                check_equal(f"K5 plain {spec} {arm} extreme 8K", want, vpu)
                check_equal(f"K5 {spec} {arm} extreme 8K", ck.fused_stage(ops, x, arms=(arm,)), want)
                n += 1
    torch.cuda.synchronize()
    print(f"phase 1: K5 at 8K and on 1080x7680 shard tiles: {n} cases equal to the plain "
          "version and the VPU arm")
    return n


def exact_sums(plane, w2d):
    """Valid-mode correlation of a u8 plane in int64 on the card: the sums K5
    must keep bit for bit."""
    import torch

    w = torch.as_tensor(w2d, dtype=torch.float64).round().long().tolist()
    ks = len(w)
    rows, cols = plane.shape[0] - ks + 1, plane.shape[1] - ks + 1
    x = plane.long()
    out = torch.zeros((rows, cols), dtype=torch.long, device=plane.device)
    for d in range(ks):
        for i in range(ks):
            if w[d][i]:
                out += w[d][i] * x[d:d + rows, i:i + cols]
    return out


def phase1_k5_sums(device, x8k) -> int:
    """K5's raw f32 sums, read through its exactness probe (k5_sums: the tile
    functions K5 runs, before any combine, scale or rounding to u8), against
    the exact int64 sums: the boundary filters and several registry
    stencils in each form, on the extreme inputs and a seeded random plane
    at 257x301 and at 8K (a plane of the 8K frame, all 255, the row
    ramp). The u8 output of K5 hides the low bits of sums that leave
    0..255; this does not. Returns the largest sum checked."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op

    gen = torch.Generator().manual_seed(3)
    small = extreme_inputs((257, 301), 1, device) + [
        torch.randint(0, 256, (257, 301), generator=gen, dtype=torch.uint8).to(device)]
    big = [x8k[..., 0].contiguous()] + [extreme_inputs((MAIN_H, MAIN_W), 1, device)[i]
                                        for i in (1, 4)]
    n, top = 0, 0
    for spec in PROBE_CASES:
        op = make_op(spec)
        for arm in k5_forms(op):
            planes = small + big if spec in (BOUNDARY_FILTERS[0], BOUNDARY_FILTERS[3]) else small
            for i, plane in enumerate(planes):
                for k, w2d in enumerate(op.kernels):
                    want = exact_sums(plane, w2d)
                    got = ck.k5_sums(op, plane, arm, kernel=k)
                    if got.shape != want.shape or not torch.equal(got.double(), want.double()):
                        err = (got.double() - want.double()).abs().max().item()
                        raise AssertionError(f"K5 sums {spec} {arm} input {i} kernel {k}: "
                                             f"max abs err {err}")
                    top = max(top, int(want.abs().max().item()))
                    n += 1
    assert top == (1 << 24) - 1, top
    print(f"phase 1: K5's raw sums equal the exact int64 sums in {n} cases, up to |sum| = {top} "
          "(2^24 - 1)")
    return top


def phase1_reference(device) -> None:
    """The reference program on a small input against the repo's loop-level
    emulator of kernel.cu (float64, tests/_c_reference.py)."""
    import importlib.util
    from pathlib import Path

    import numpy as np

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    path = Path(__file__).resolve().parent / "tests" / "_c_reference.py"
    spec = importlib.util.spec_from_file_location("_c_reference", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    contrast_c, emboss_c = ref.contrast_c, ref.emboss_c
    grayscale_c, stencil_reflect101_c = ref.grayscale_c, ref.stencil_reflect101_c

    img = synthetic_image(48, 64, seed=7)
    gray = Pipeline.parse("grayscale").jit("cuda", device=device)(img).cpu().numpy()
    diff = np.abs(gray.astype(int) - grayscale_c(img).astype(int))
    assert diff.max() <= 3, "grayscale strays from the float64 reference"
    out = Pipeline.parse("contrast:3.5,emboss:3").jit("cuda", device=device)(gray)
    np.testing.assert_array_equal(out.cpu().numpy(), emboss_c(contrast_c(gray, 3.5), 3))
    from mpi_cuda_imagemanipulation_tpu_torch.ops import filters

    k2, scale = filters.gaussian_2d(5)
    g5 = Pipeline.parse("gaussian:5").jit("cuda", device=device)(gray)
    np.testing.assert_array_equal(g5.cpu().numpy(), stencil_reflect101_c(gray, k2, scale))
    print("phase 1: reference program on 48x64 equal to tests/_c_reference.py")


def phase2(device, x8k):
    """The main paths at 8K under each plan, against the golden ops, with
    every kernel's launches counted over each run."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import run_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics

    launches = {}
    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        want = run_image(pipe, x8k, impl="torch", device=device, plan="off")
        for plan in PLANS:
            ck.reset_launch_counts()
            plan_metrics.reset()
            out = run_image(pipe, x8k, impl="cuda", device=device, plan=plan)
            torch.cuda.synchronize()
            counts = {"K1": ck.pointwise_group.launches, "K2": ck.stream_stencil.launches,
                      "K4": ck.fused_stage.launches}
            fallbacks = sum(plan_metrics.pallas_fallbacks.values())
            assert out.shape == (MAIN_H, MAIN_W, 3) and out.dtype == torch.uint8, out.shape
            check_equal(f"main path {spec} plan={plan}", out, want)
            if plan == "off":
                expected = {"K2"} if key == "gaussian5_8k" else {"K1", "K2"}
            else:
                expected = {"K4"}
            for k in counts:
                if k in expected and counts[k] < 1:
                    raise AssertionError(f"main path {spec} plan={plan}: {k} was never launched")
                if k not in expected and counts[k]:
                    raise AssertionError(f"main path {spec} plan={plan}: {k} launched {counts[k]}x")
            if fallbacks or (plan == "fused-pallas" and plan_metrics.pallas_stages < 1):
                raise AssertionError(f"main path {spec} plan={plan}: fallbacks "
                                     f"{dict(plan_metrics.pallas_fallbacks)}")
            launches[key, plan] = counts
            print(f"phase 2: {spec} plan={plan} at {MAIN_H}x{MAIN_W} RGB: cuda == golden, "
                  f"launches {counts}, K4 stages {plan_metrics.pallas_stages}, fallbacks 0")
    return launches


def sharded_mesh():
    """Four slots, slot i on card i modulo the number of cards: all on the
    one card here, spread over the cards where there are more."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import make_mesh

    cards = torch.cuda.device_count()
    return make_mesh(N_SHARDS, devices=[f"cuda:{i % cards}" for i in range(N_SHARDS)])


def expected_sharded(ops, plan, halo_mode, padded=False) -> tuple[dict, int]:
    """The launches and exchange rounds parallel/api.py implies for a
    one-stage pipeline over N_SHARDS shards: under 'off' a K2g per stencil
    group and shard (K3 after a K1 flush on padded tiles), a K1 per
    pointwise-only group; under 'fused-pallas' one K4g per shard; under
    'overlap' (either plan) a K1 flush of the prologue and three K3 per
    group and shard."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck

    want = dict.fromkeys(ck.launch_counts(), 0)
    groups = ck.group_ops(ops)
    stencils = sum(st is not None for _, st in groups)
    if plan == "fused-pallas" and halo_mode == "serial" and not padded:
        want["K4g"] = N_SHARDS
        return want, 1
    for pw, st in groups:
        if st is None:
            want["K1"] += N_SHARDS
        elif halo_mode == "overlap" and not padded:
            want["K1"] += N_SHARDS if pw else 0
            want["K3"] += 3 * N_SHARDS
        elif padded:
            want["K1"] += N_SHARDS if pw else 0
            want["K3"] += N_SHARDS
        else:
            want["K2g"] += N_SHARDS
    return want, stencils


def phase2_sharded(device, x8k):
    """`Pipeline.sharded` at 8K over the 4-slot mesh under each plan and
    halo mode, and at 4323 rows, against the golden ops; launches and
    exchanges as `expected_sharded` implies."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import halo
    from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics

    mesh = sharded_mesh()
    launches = {}

    def drive(key, pipe, x, want, plan, halo_mode, padded):
        fn = pipe.sharded(mesh, backend="cuda", plan=plan, halo_mode=halo_mode)
        ck.reset_launch_counts()
        halo.exchanges.reset()
        plan_metrics.reset()
        out = fn(x)
        for d in set(mesh.devices):
            torch.cuda.synchronize(d)
        counts = ck.launch_counts()
        rounds = halo.exchanges.rounds
        tag = f"sharded path {key} plan={plan} halo_mode={halo_mode} {x.shape[0]}x{x.shape[1]}"
        assert out.dtype == torch.uint8 and out.device == mesh.devices[0], tag
        check_equal(tag, out, want)
        exp_counts, exp_rounds = expected_sharded(pipe.ops, plan, halo_mode, padded)
        if counts != exp_counts:
            raise AssertionError(f"{tag}: launches {counts}, expected {exp_counts}")
        if rounds != exp_rounds:
            raise AssertionError(f"{tag}: {rounds} exchange rounds, expected {exp_rounds}")
        mega = plan == "fused-pallas" and halo_mode == "serial"
        want_fallbacks = {"image-too-small": 1} if mega and padded else {}
        if dict(plan_metrics.pallas_fallbacks) != want_fallbacks or (
                plan_metrics.pallas_stages != (1 if mega and not padded else 0)):
            raise AssertionError(f"{tag}: K4g stages {plan_metrics.pallas_stages}, fallbacks "
                                 f"{dict(plan_metrics.pallas_fallbacks)}")
        launches[key, plan, halo_mode, padded] = counts
        used = {k: v for k, v in counts.items() if v}
        print(f"phase 2: {tag}: sharded cuda == golden, launches {used}, {rounds} exchange "
              f"round(s) over {N_SHARDS - 1} boundaries, full-mode K2/K4 launches 0")

    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        want = pipe.jit("torch", device=device, plan="off")(x8k)
        for plan in PLANS:
            for halo_mode in HALO_MODES:
                drive(key, pipe, x8k, want, plan, halo_mode, False)
    xpad = torch.from_numpy(synthetic_image(PAD_H, MAIN_W, seed=1)).to(device)
    for key in ("reference", "gaussian5_8k"):
        pipe = Pipeline.parse(SPECS[key])
        want = pipe.jit("torch", device=device, plan="off")(xpad)
        for plan in PLANS:
            drive(key, pipe, xpad, want, plan, "serial", True)
    return launches


def expected_mxu(ops, impl, plan, *, gray_to_rgb=True, shards=1, halo_mode="serial") -> dict:
    """The launches a tensor-core path implies for one of the main chains
    (one fused stage; every stencil of them has an int8 K5 form): under
    'fused-pallas-mxu' one K4 (or, sharded, one K4g per shard) running
    K5-int8, and a halo-0 K4 stage for gray -> RGB; under 'mxu' with plan
    'off' no kernel for the stencils (banded products) and one K1 per
    pointwise run (per shard), gray -> RGB included. Sharded under
    halo_mode='overlap' no stage takes K4g: a fused-pallas-mxu run is the
    plan 'off' run of its backend."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck

    want = dict.fromkeys(ck.launch_counts(), 0)
    gray = any(op.out_channels == 1 for op in ops)
    if plan == "fused-pallas-mxu" and (shards == 1 or halo_mode == "serial"):
        want["K4g" if shards > 1 else "K4"] = shards
        want["K5-int8"] = shards
        want["K4"] += int(gray and gray_to_rgb)
        return want
    if impl == "cuda":
        assert shards == N_SHARDS and halo_mode == "overlap" and not gray_to_rgb
        return expected_sharded(ops, "off", "overlap")[0]
    assert impl == "mxu" and (plan == "off" or halo_mode == "overlap")
    runs = [pw for pw, st in ck.group_ops(ops) if pw]
    want["K1"] = shards * len(runs) + int(gray and gray_to_rgb)
    return want


def phase2_mxu(device, x8k):
    """The tensor-core paths at 8K against the golden ops: `run` under
    --plan fused-pallas-mxu (impl cuda and mxu) and --impl mxu --plan off,
    the stage executor with the in-stage setting 'f32' (K5 bf16), a stage
    K4 rejects under both impls, and Pipeline.sharded over the 4-slot mesh
    under fused-pallas-mxu (backends cuda and mxu, both halo modes) and
    mxu + off (both halo modes); launches, arm counts, K4 fallbacks and
    exchange rounds asserted."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import run_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import StencilOp
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import halo
    from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan
    from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import plan_callable_cuda
    from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics

    mesh = sharded_mesh()
    launches = {}

    def drive(tag, fn, x, want, exp, arms=None, rounds=None, fallbacks=None, golden=None):
        ck.reset_launch_counts()
        plan_metrics.reset()
        halo.exchanges.reset()
        out = fn(x)
        for d in set(mesh.devices):
            torch.cuda.synchronize(d)
        counts = ck.launch_counts()
        assert out.dtype == torch.uint8 and out.shape == want.shape, (tag, out.shape)
        check_equal(tag, out, want)
        if counts != exp:
            raise AssertionError(f"{tag}: launches {counts}, expected {exp}")
        if dict(plan_metrics.mxu_stage_ops) != (arms or {}) or plan_metrics.mxu_stage_fallbacks:
            raise AssertionError(f"{tag}: arms {dict(plan_metrics.mxu_stage_ops)}, expected "
                                 f"{arms or {}}; fallbacks {dict(plan_metrics.mxu_stage_fallbacks)}")
        if dict(plan_metrics.pallas_fallbacks) != (fallbacks or {}):
            raise AssertionError(f"{tag}: K4 fallbacks {dict(plan_metrics.pallas_fallbacks)}, "
                                 f"expected {fallbacks or {}}")
        if rounds is not None and halo.exchanges.rounds != rounds:
            raise AssertionError(f"{tag}: {halo.exchanges.rounds} exchange rounds, expected {rounds}")
        if dict(plan_metrics.mxu_golden_ops) != (golden or {}):
            raise AssertionError(f"{tag}: golden ops {dict(plan_metrics.mxu_golden_ops)}, "
                                 f"expected {golden or {}}")
        used = {k: v for k, v in counts.items() if v}
        print(f"phase 2: {tag}: == golden, launches {used}, in-stage arms "
              f"{dict(plan_metrics.mxu_stage_ops)}, golden ops {dict(plan_metrics.mxu_golden_ops)}")
        return counts

    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        n_st = sum(isinstance(op, StencilOp) for op in pipe.ops)
        int8 = {"mxu-int8": n_st}
        want = run_image(pipe, x8k, impl="torch", device=device, plan="off")
        for impl, plan in (("cuda", "fused-pallas-mxu"), ("mxu", "fused-pallas-mxu"), ("mxu", "off")):
            launches[key, impl, plan] = drive(
                f"main path {spec} impl={impl} plan={plan} {MAIN_H}x{MAIN_W} RGB",
                lambda x, impl=impl, plan=plan: run_image(pipe, x, impl=impl, device=device,
                                                          plan=plan),
                x8k, want, expected_mxu(pipe.ops, impl, plan),
                arms=int8 if plan == "fused-pallas-mxu" else None)
        # the bf16 form at 8K: the stage executor with the setting 'f32'
        gray = pipe.jit("torch", device=device, plan="off")(x8k)
        f32 = plan_callable_cuda(build_plan(pipe.ops, "fused-pallas-mxu"), mxu_stage="f32")
        exp = dict.fromkeys(ck.launch_counts(), 0)
        exp.update({"K4": 1, "K5-bf16": 1})
        launches[key, "cuda", "f32"] = drive(
            f"main path {spec} fused-pallas-mxu mxu_stage=f32 {MAIN_H}x{MAIN_W} RGB", f32, x8k,
            gray, exp, arms={"mxu": n_st})
        # sharded, no gray -> RGB step; under overlap no stage takes K4g
        for backend, plan, halo_mode in (
                ("cuda", "fused-pallas-mxu", "serial"), ("cuda", "fused-pallas-mxu", "overlap"),
                ("mxu", "fused-pallas-mxu", "serial"), ("mxu", "fused-pallas-mxu", "overlap"),
                ("mxu", "off", "serial"), ("mxu", "off", "overlap")):
            fn = pipe.sharded(mesh, backend=backend, plan=plan, halo_mode=halo_mode)
            mega = plan == "fused-pallas-mxu" and halo_mode == "serial"
            launches[key, "sharded", backend, plan, halo_mode] = drive(
                f"sharded path {spec} backend={backend} plan={plan} halo_mode={halo_mode}",
                fn, x8k, gray,
                expected_mxu(pipe.ops, backend, plan, gray_to_rgb=False, shards=N_SHARDS,
                             halo_mode=halo_mode),
                arms=int8 if mega else None, rounds=1 if mega else n_st)
    # a stage K4 rejects (a lookup table: 'lut-op'): K1/K2 groups under cuda,
    # pipeline_mxu under mxu (the gather, then the banded products)
    pipe = Pipeline.parse(REJECTED_SPEC)
    want = pipe.jit("torch", device=device, plan="off")(x8k)
    for impl in ("cuda", "mxu"):
        exp = dict.fromkeys(ck.launch_counts(), 0)
        exp["K2"] = int(impl == "cuda")
        launches["rejected", impl] = drive(
            f"main path {REJECTED_SPEC} impl={impl} plan=fused-pallas-mxu {MAIN_H}x{MAIN_W} RGB",
            lambda x, impl=impl: run_image(pipe, x, impl=impl, device=device,
                                           plan="fused-pallas-mxu"),
            x8k, want, exp, fallbacks={"lut-op": 1})
    # a median on images within its halo: no banded form, and the K2 runner
    # refuses the shape, so the whole-op route runs its golden op, counted
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image

    # (K1: the grayscale step, and gray -> RGB after a gray result)
    for spec, shape, channels, k1 in (("median:5", (2, 3), 1, 1), ("median:5", (3, 2), 3, 0),
                                      ("grayscale,median:5", (2, 3), 3, 2),
                                      ("median:3", (1, 40), 1, 1)):
        pipe = Pipeline.parse(spec)
        x = torch.from_numpy(synthetic_image(*shape, channels=channels, seed=5)).to(device)
        exp = dict.fromkeys(ck.launch_counts(), 0)
        exp["K1"] = k1
        drive(f"main path {spec} impl=mxu plan=off {shape[0]}x{shape[1]}x{channels}",
              lambda x, pipe=pipe: run_image(pipe, x, impl="mxu", device=device, plan="off"),
              x, run_image(pipe, x, impl="torch", device=device, plan="off"), exp,
              golden={spec.split(",")[-1].replace(":", ""): 1})
    return launches


def swar_case(spec, chain):
    """(stencil op, pre ops, post ops, pre chain, post chain) of one SWAR
    case: the stencil of `spec` with the pointwise ops of `chain` fused."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op

    pre = tuple(make_op(s) for s in chain[0])
    post = tuple(make_op(s) for s in chain[1])
    return (make_op(spec), pre, post, tuple(map(sk.swar_fusable, pre)),
            tuple(map(sk.swar_fusable, post)))


def gray_tile(plane, y0, rows, h, op):
    """The tile of `rows` rows at `y0` of a gray plane with the ghost strips
    the sharded runner gives it: the neighbours' rows, the op's edge
    extension at the plane's first and last row."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.parallel import api

    H = plane.shape[0]
    tile = plane[y0:y0 + rows].contiguous()
    top = plane[y0 - h:y0] if y0 else torch.zeros_like(plane[:h])
    bottom = plane[y0 + rows:y0 + rows + h] if y0 + rows < H else torch.zeros_like(plane[:h])
    top, bottom = api._fix_edge_strips(top, bottom, tile, op, y0, H)
    return tile, top.contiguous(), bottom.contiguous()


def phase1_swar(device, gray8k) -> int:
    """K6 (narrow and wide), K7 and K8 against their plain versions (run on
    the card): every SWAR stencil with each chain, full mode on a seeded
    plane, all 0, all 255, two checkerboards and a row ramp at 257x300 (tile
    heights 32, 7 and 33), seeded planes at 37x128 and 48x64; ghost mode on
    tiles cut as the first, a middle and the last of three shards of the
    seeded plane and of the 8K gray frame (1080x7680, the main path's
    shards); full mode on the 8K gray frame."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk

    def plane(h, w, seed):
        return torch.from_numpy(synthetic_image(h, w, channels=1, seed=seed)).to(device)

    seeded = plane(257, 300, 1)
    full = [seeded] + extreme_inputs((257, 300), 1, device) + [plane(37, 128, 2), plane(48, 64, 3)]
    local_h = MAIN_H // N_SHARDS
    n_full = n_ghost = n8k = 0
    kinds = set()
    for spec in SWAR_STENCILS:
        for ci, chain in enumerate(SWAR_CHAINS):
            st, pre, post, pc, qc = swar_case(spec, chain)
            kinds.add(sk.swar_kind(st))
            kw = dict(pre_ops=pre, post_ops=post)
            label = f"{sk.swar_kind(st)} {spec} chain {chain}"
            for i, x in enumerate(full):
                want = sk.swar_stencil_plain(st, x, pre_chain=pc, post_chain=qc)
                for tile_h in ((None, 7, 33) if i == 0 else (None,)):
                    check_equal(f"{label} input {i} tile_h={tile_h}",
                                sk.swar_stencil(st, x, block_h=tile_h, **kw), want)
                    n_full += 1
            h = st.halo
            for src, rows, ys in ((seeded, 85, (0, 85, 170)),
                                  (gray8k, local_h, (0, local_h, MAIN_H - local_h))):
                if src is gray8k and ci not in (0, 3):
                    continue
                H = src.shape[0]
                for y0 in ys:
                    tile, top, bottom = gray_tile(src[:3 * rows] if src is seeded else src,
                                                  y0, rows, h, st)
                    gkw = dict(ghosts=(top, bottom), y0=y0, global_h=3 * rows if src is seeded else H)
                    want = sk.swar_stencil_plain(st, tile, pre_chain=pc, post_chain=qc, **gkw)
                    check_equal(f"{label} ghost {tuple(src.shape)} y0={y0}",
                                sk.swar_stencil(st, tile, **gkw, **kw), want)
                    n_ghost += 1
            if ci in (0, 3):
                want = sk.swar_stencil_plain(st, gray8k, pre_chain=pc, post_chain=qc)
                check_equal(f"{label} 8K", sk.swar_stencil(st, gray8k, **kw), want)
                n8k += 1
    assert kinds == set(sk.KINDS), kinds
    torch.cuda.synchronize()
    print(f"phase 1: K6 narrow/wide, K7, K8 equal to their plain versions (max_abs_err 0): "
          f"{n_full} full-mode cases, {n_ghost} ghost-mode cases ({len(SWAR_STENCILS)} "
          f"stencils x {len(SWAR_CHAINS)} chains), {n8k} on the 8K gray frame")
    return n_full + n_ghost + n8k


# the redesigned SWAR kernels' ragged and unaligned shapes: widths no
# multiple of 8 or 128 (one narrower than a tile), and the frame's less 4
SWAR_WIDTHS = (76, 132, 196, 260, MAIN_W - 4)
# K7 at its largest compile-time side and past it (the tap table): 7x7 and
# 9x9 integer kernels with negative taps, sum|w| <= 128
SWAR_K7_7X7 = "filter:" + "/".join(str((i * 7 % 11) - 5 if i % 3 == 0 else 0) for i in range(49))


# K8 on i32 lanes at side 3 (sum|w| = 530, past a 16-bit field) and side 7
SWAR_K8_LANES3 = "filter:100/-100/50/0/30/0/-50/100/-100:0.25"
SWAR_K8_7X7 = "filter:" + "/".join(str((i * 5 % 13) - 6) for i in range(49)) + ":0.125"
def swar_k7_9x9():
    """A 9x9 K7 (no registry spelling: sharpen's fields, a 9x9 kernel)."""
    import dataclasses

    import numpy as np

    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op

    w = np.array([(-3 if i % 10 == 0 else 2) if i % 5 == 0 else 0 for i in range(81)],
                 np.float32).reshape(9, 9)
    return dataclasses.replace(make_op("sharpen"), name="k7_9x9", halo=4, kernels=(w,),
                               separable=None)


def swar_custom_stencils() -> list:
    """The SWAR forms no registry op reaches: K8 past side 7 (a scaled 9x9,
    trunc_clip: the tap table), K8's magnitude of two 5x5 kernels (lanes),
    K6 narrow past side 5 (S = 8 over 7 taps: the tap table), K6 wide on
    i32 lanes at sides 3 and 5 (S = 32 and 40: 255 * S^2 >= 2^16)."""
    import dataclasses

    import numpy as np

    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op

    w9 = swar_k7_9x9().kernels[0]
    a5 = np.outer([1, 2, 0, -2, -1], [1, 4, 6, 4, 1]).astype(np.float32)
    return [
        dataclasses.replace(make_op("sobel"), name="k8_9x9", halo=4, kernels=(w9,),
                            combine="single", scale=0.25, quantize="trunc_clip"),
        dataclasses.replace(make_op("sobel"), name="k8_mag5", halo=2, kernels=(a5, a5.T.copy())),
        dataclasses.replace(make_op("gaussian:5"), name="k6n_7", halo=3,
                            kernels=(np.ones((7, 7), np.float32),),
                            separable=np.array([1, 1, 1, 2, 1, 1, 1], np.float32),
                            scale=1.0 / 64),
    ] + [dataclasses.replace(make_op(f"gaussian:{len(t)}"), name=f"k6w_{len(t)}",
                             kernels=(np.outer(t, t),), separable=t, scale=1.0 / float(t.sum()) ** 2)
         for t in (np.array([1, 30, 1], np.float32), np.array([1, 4, 30, 4, 1], np.float32))]


def phase1_swar_redesign(device) -> int:
    """The redesigned K6, K7 and K8 (the window loader's row sources and
    granules, the four-word pair build, the compile-time tap loops of K6,
    K7 and K8 and their tap tables, K8 on biased fields and on lanes, K6's
    wide column pass on fields and on lanes, the hoisted guard, eight-byte
    stores) against their plain versions: every SWAR stencil, K7 at 7x7 and
    9x9, box:7, box:17 (past K6's field limit), K6 wide on lanes at sides 3
    and 5, K8 on lanes at sides 3 and 7, a 9x9 K8, K8's magnitude at side 5
    and a 7-tap narrow K6, in every edge mode the kernel takes, at widths
    that are no multiple of 8 or 128, with rows at every start byte 0..15
    (`unaligned`) on one width and two on the rest, under the picker's tile
    and a 7-row one; ghost mode at row0 at the image's top, middle and
    bottom on those widths. Every instantiation of the dispatch
    (swar_kernels.SWAR_INSTANCES), as the descriptor of the wrapper's group
    selects it, is reached in both modes. Returns the case count."""
    import dataclasses

    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op

    n = n_ghost = 0
    extra = [SWAR_K7_7X7, "box:7", "box:17", SWAR_K8_LANES3, SWAR_K8_7X7]
    stencils = ([make_op(s) for s in SWAR_STENCILS + extra] + [swar_k7_9x9()]
                + swar_custom_stencils())
    reached = {"full": set(), "ghost": set()}
    pre = (make_op("contrast:3.5"),)
    pc = tuple(map(sk.swar_fusable, pre))
    for base in stencils:
        for mode in EDGE_MODES:
            st = dataclasses.replace(base, edge_mode=mode)
            if not sk.swar_any_eligible(st):
                continue
            for w in SWAR_WIDTHS:
                if w // 4 < 2 * st.halo + 1:
                    continue
                x = torch.from_numpy(synthetic_image(37, w, channels=1, seed=w)).to(device)
                for off in (range(16) if w == 196 else (0, 5)):
                    xo = unaligned(x, off)
                    want = sk.swar_stencil_plain(st, xo, pre_chain=pc)
                    for bh in (None, 7):
                        check_equal(f"{sk.swar_kind(st)} {st.name} {mode} width {w} offset {off} "
                                    f"tile_h={bh}", sk.swar_stencil(st, xo, pre_ops=pre,
                                                                    block_h=bh), want)
                        n += 1
                reached["full"].add(sk.swar_instance(sk.swar_group(st, pre).desc))
                if mode != base.edge_mode:
                    continue
                img = torch.from_numpy(synthetic_image(72, w, channels=1, seed=w + 1)).to(device)
                for y0 in (0, 24, 48):
                    tile, top, bottom = gray_tile(img, y0, 24, st.halo, st)
                    gkw = dict(ghosts=(unaligned(top, 3), unaligned(bottom, 9)), y0=y0,
                               global_h=72)
                    want = sk.swar_stencil_plain(st, tile, pre_chain=pc, **gkw)
                    check_equal(f"{sk.swar_kind(st)}g {st.name} width {w} y0={y0}",
                                sk.swar_stencil(st, unaligned(tile, 1), pre_ops=pre, **gkw),
                                want)
                    n_ghost += 1
                reached["ghost"].add(sk.swar_instance(sk.swar_group(st, pre).desc))
    for mode, got in reached.items():
        if got != sk.SWAR_INSTANCES:
            raise AssertionError(f"{mode} mode reached {sorted(got)}, not every instantiation "
                                 f"{sorted(sk.SWAR_INSTANCES)}")
    torch.cuda.synchronize()
    print(f"phase 1: the redesigned K6, K7, K8 equal to their plain versions in {n} full-mode "
          f"cases (every edge mode, widths {SWAR_WIDTHS}, start bytes 0..15) and {n_ghost} "
          f"ghost-mode cases (max_abs_err 0); all {len(sk.SWAR_INSTANCES)} instantiations reached "
          "in both modes")
    return n + n_ghost


def phase1_k5_redesign(device) -> int:
    """The redesigned K5 (hoisted B, word-loaded A, the row and column
    clamps, 16-bit stores, a last stencil's store pass) in both forms
    against its plain version: one stencil of each side and the magnitude
    family in every edge mode, as a stage's last stencil (alone and before
    a trailing pointwise run) and before a pointwise run and a VPU
    stencil, gray and RGB; the main stages
    on RGB rows at every start byte 0..15 (`unaligned`), K4 and K4g.
    Returns the case count."""
    import dataclasses

    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op, make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo

    n = 0
    for spec in ("box:1", "sharpen", "sobel", "gaussian:5", "emboss:5", "gaussian:7"):
        base = make_op(spec)
        for mode in EDGE_MODES:
            st = dataclasses.replace(base, edge_mode=mode)
            for ops in ((st,), (st, make_op("quantize:6")), (st, make_op("invert"),
                                                             make_op("box:3"))):
                for c, shape in ((1, (37, 53)), (3, (70, 301))):
                    x = torch.from_numpy(synthetic_image(*shape, channels=c, seed=n)).to(device)
                    for arm in k5_forms(st):
                        arms = (arm,) + ("vpu",) * (len(ops) - 1)
                        check_equal(f"K5 {arm} {[o.name for o in ops]} {mode} c={c}",
                                    ck.fused_stage(ops, x, arms=arms),
                                    ck.fused_stage_plain(ops, x, arms=arms))
                        n += 1
    for spec in (SPECS["megakernel_ab"], SPECS["gaussian5_8k"], SPECS["reference"]):
        ops = make_pipeline_ops(spec)
        H = chain_halo(ops)
        x = torch.from_numpy(synthetic_image(37, 53, channels=3, seed=5)).to(device)
        tile, top, bottom, y0, image_h = shard_cut(ops, (3 * 40, 301), 1, 6, device, H)
        ext = torch.cat([top, tile, bottom]).contiguous()
        kw = dict(y0=y0, image_h=image_h, image_w=301)
        for setting in ("on", "f32"):
            arms = ck.stage_arms(ops, setting)
            want = ck.fused_stage_plain(ops, x, arms=arms)
            want_g = ck.fused_stage_ext_plain(ops, ext, arms=arms, **kw)
            for off in range(16):
                check_equal(f"K5 {setting} {spec} RGB rows at offset {off}",
                            ck.fused_stage(ops, unaligned(x, off), arms=arms), want)
                check_equal(f"K5 (K4g) {setting} {spec} extended tile at offset {off}",
                            ck.fused_stage_ext(ops, unaligned(ext, off), arms=arms, **kw), want_g)
                n += 2
    torch.cuda.synchronize()
    print(f"phase 1: the redesigned K5 equal to its plain version in {n} cases (every edge mode, "
          "last and inner stencil, gray and RGB, start bytes 0..15; max_abs_err 0)")
    return n


def phase2_swar(device, x8k, gray8k):
    """The SWAR backend's paths against the golden ops: `run --impl swar`
    (cli.run_image) on the five 8K workloads with exactly their launches,
    and Pipeline.sharded(backend='swar') on the 8K gray frame over the
    4-slot mesh: one ghost-mode launch per shard and one exchange round per
    group; at 4323 rows and under overlap no SWAR launch, the 'cuda'
    route's launches instead."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import run_image
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import halo

    launches = {}
    for key, (spec, exp) in SWAR_SPECS.items():
        pipe = Pipeline.parse(spec)
        want = run_image(pipe, x8k, impl="torch", device=device, plan="off")
        ck.reset_launch_counts()
        out = run_image(pipe, x8k, impl="swar", device=device, plan="off")
        torch.cuda.synchronize()
        counts = ck.launch_counts()
        assert out.shape == (MAIN_H, MAIN_W, 3) and out.dtype == torch.uint8, out.shape
        check_equal(f"swar path {spec}", out, want)
        expected = {**dict.fromkeys(counts, 0), **exp}
        if counts != expected:
            raise AssertionError(f"swar path {spec}: launches {counts}, expected {expected}")
        launches[key] = counts
        print(f"phase 2: {spec} impl=swar at {MAIN_H}x{MAIN_W} RGB: swar == golden, launches "
              f"{exp}")
    mesh = sharded_mesh()
    to_gray = Pipeline.parse("grayscale").jit("torch", device=device, plan="off")
    gray_pad = to_gray(torch.from_numpy(synthetic_image(PAD_H, MAIN_W, seed=1)).to(device))
    for spec, kernel in SWAR_SHARDED.items():
        pipe = Pipeline.parse(spec)
        for x, halo_mode, padded in ((gray8k, "serial", False), (gray8k, "overlap", False),
                                     (gray_pad, "serial", True)):
            want = pipe.jit("torch", device=device, plan="off")(x)
            fn = pipe.sharded(mesh, backend="swar", halo_mode=halo_mode)
            ck.reset_launch_counts()
            halo.exchanges.reset()
            out = fn(x)
            for d in set(mesh.devices):
                torch.cuda.synchronize(d)
            counts, rounds = ck.launch_counts(), halo.exchanges.rounds
            tag = f"sharded swar path {spec} halo_mode={halo_mode} {x.shape[0]}x{x.shape[1]} gray"
            assert out.dtype == torch.uint8 and out.device == mesh.devices[0], tag
            check_equal(tag, out, want)
            if halo_mode == "serial" and not padded:
                exp, exp_rounds = dict.fromkeys(counts, 0), 1
                exp[kernel] = N_SHARDS
            else:
                exp, exp_rounds = expected_sharded(pipe.ops, "off", halo_mode, padded)
            if counts != exp or rounds != exp_rounds:
                raise AssertionError(f"{tag}: launches {counts}, {rounds} rounds; expected "
                                     f"{exp}, {exp_rounds}")
            launches[spec, halo_mode, padded] = counts
            used = {k: v for k, v in counts.items() if v}
            print(f"phase 2: {tag}: == golden, launches {used}, {rounds} exchange round(s)")
    return launches


def phase3_swar(device, x8k, gray8k, swar_launches, record):
    """K6, K7 and K8 at the SWAR paths' shapes (the 8K gray plane; ghost
    mode on a middle 1080x7680 shard), each held against its plain version,
    with K2 (K2g) on the same group and plane, the route `--impl cuda`
    takes, timed beside it, and each 8K row at every tile height the picker
    chooses from; K6 narrow on the bare gaussian:5 also beside T3; then the
    SWAR paths end to end beside `--impl cuda`. `record` appends the
    kernels' rows."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import image_runner
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
    from mpi_cuda_imagemanipulation_tpu_torch.tools import swar_proto as sp
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    local_h = MAIN_H // N_SHARDS
    y0 = local_h
    # the gray input of the megakernel chain's sharpen group
    _, pre, _, pc, _ = swar_case("gaussian:5", (("contrast:3.5",), ()))
    blurred = sk.swar_stencil(swar_case("gaussian:5", ((), ()))[0], gray8k, pre_ops=pre)
    # (label, spec, chain, plane, phase-2 run and key, library call?)
    groups = [
        ("K6 narrow", "gaussian:5", (("contrast:3.5",), ()), gray8k, ("megakernel_ab", "K6-narrow"),
         False),
        ("K6 narrow", "gaussian:5", ((), ()), gray8k, ("gaussian5_gray", "K6-narrow"), True),
        ("K6 wide", "gaussian:7", ((), ()), gray8k, ("gaussian7_gray", "K6-wide"), True),
        ("K6 wide", "box:5", ((), ()), gray8k, ("box5_gray", "K6-wide"), True),
        ("K7", "emboss:3", (("contrast:3.5",), ()), gray8k, ("reference", "K7"), False),
        ("K7", "sharpen", ((), ()), blurred, ("megakernel_ab", "K7"), True),
        ("K8", "sobel", ((), ()), gray8k, ("sobel_gray", "K8"), False),
        ("K8", "scharr", ((), ()), gray8k, ("scharr_gray", "K8"), False),
        ("K8", "unsharp", ((), ()), gray8k, ("unsharp_gray", "K8"), True),
    ]
    for label, spec, chain, x, (key, count), lib in groups:
        st, pre, post, pc, qc = swar_case(spec, chain)
        names = ",".join(op.name for op in pre + (st,) + post)
        record(
            f"{label} swar_stencil [{names}] gray", SWAR_SOURCE, SWAR_REPLACES[label[:2]],
            swar_launches[key][count],
            lambda st=st, x=x, pre=pre: sk.swar_stencil(st, x, pre_ops=pre),
            lambda st=st, x=x, pc=pc: sk.swar_stencil_plain(st, x, pre_chain=pc), 1, 1,
            list(pre) + [st], library=conv_library(st, x, pad_rows=True) if lib else None,
            split=True,
        )
        t_k2 = device_time_ms(lambda st=st, x=x, pre=pre: ck.stream_stencil(list(pre), st, x),
                              reps=7)
        print(f"  K2 on the same group and plane (the --impl cuda route) in this run: "
              f"{t_k2:.4f} ms")
        if spec == "gaussian:5" and not pre:
            # T3, the SWAR 5x5 prototype, on the same plane (bh 240): device
            # time of the kernel alone, beside K6's
            ext = sp.pack_quarters(sp.reflect_pad(x))
            print(f"  T3 on the same plane (quarter-strip words, bh 240), device: "
                  f"{padded_device_ms(lambda: sp.swar_proto(ext, 240)):.4f} ms, K6 narrow "
                  f"{padded_device_ms(lambda st=st, x=x: sk.swar_stencil(st, x)):.4f} ms")
            del ext
        # the tile heights the picker chooses from (swar_kernels.TILE_ROWS)
        t_rows = {rows: padded_device_ms(lambda rows=rows, st=st, x=x, pre=pre: sk.swar_stencil(
            st, x, pre_ops=pre, block_h=rows)) for rows in sk.TILE_ROWS}
        print(f"sweep {label} [{names}] 8K gray by tile_h (device): " +
              ", ".join(f"{r}: {t:.4f} ms" for r, t in t_rows.items()))
    ghost = [("K6g narrow", "gaussian:5", "K6g-narrow", True),
             ("K7g", "contrast:3.5,emboss:3", "K7g", False), ("K8g", "sobel", "K8g", False)]
    for label, spec, count, lib in ghost:
        parts = spec.split(",")
        st, pre, post, pc, qc = swar_case(parts[-1], (tuple(parts[:-1]), ()))
        h = st.halo
        tile, top, bottom = gray_tile(gray8k, y0, local_h, h, st)
        kw = dict(ghosts=(top, bottom), y0=y0, global_h=MAIN_H)
        ext = torch.cat([top, tile, bottom])
        record(
            f"{label} swar_stencil ghost [{spec}] gray shard", SWAR_SOURCE,
            SWAR_REPLACES[label[:2]], swar_launches[spec, "serial", False][count],
            lambda st=st, t=tile, pre=pre, kw=kw: sk.swar_stencil(st, t, pre_ops=pre, **kw),
            lambda st=st, t=tile, pc=pc, kw=kw: sk.swar_stencil_plain(st, t, pre_chain=pc, **kw),
            1, 1, list(pre) + [st], library=conv_library(st, ext, pad_rows=False) if lib else None,
            n_pix=local_h * MAIN_W, strip_bytes=2 * h * MAIN_W, split=True,
        )
        gk = dict(y0=y0, image_h=MAIN_H, image_w=MAIN_W)

        def k2g(st=st, t=(tile, top, bottom), pre=pre):
            return ck.stream_stencil_ghost(list(pre), st, *t, **gk)

        t_k2 = device_time_ms(k2g, reps=7)
        # host time per call of each wrapper: where it exceeds the device
        # time, back-to-back launches wait on the host
        h_swar = host_enqueue_ms(lambda st=st, t=tile, pre=pre, kw=kw: sk.swar_stencil(
            st, t, pre_ops=pre, **kw))
        print(f"  K2g on the same group and shard (the --impl cuda route) in this run: "
              f"{t_k2:.4f} ms; host time to enqueue one call: {label} {h_swar:.4f} ms, K2g "
              f"{host_enqueue_ms(k2g):.4f} ms")
        del ext
    torch.cuda.synchronize()

    mp = MAIN_H * MAIN_W / 1e6
    for key, (spec, _) in SWAR_SPECS.items():
        pipe = Pipeline.parse(spec)
        times = {}
        for impl in ("swar", "cuda", "swar"):
            runner = image_runner(pipe, impl=impl, device=device, plan="off")
            times[impl] = device_time_ms(lambda: runner(x8k), reps=5, inner=3)
        used = {k: v for k, v in swar_launches[key].items() if v}
        print(f"path {key} [{spec}] impl=swar {MAIN_H}x{MAIN_W} RGB in, RGB out: "
              f"{times['swar']:.4f} ms ({mp / times['swar'] * 1e3:.1f} MP/s), impl=cuda "
              f"plan=off in this run {times['cuda']:.4f} ms; launches {used}")
    mesh = sharded_mesh()
    for spec in SWAR_SHARDED:
        pipe = Pipeline.parse(spec)
        times = {}
        for backend in ("swar", "cuda"):
            fn = pipe.sharded(mesh, backend=backend)
            times[backend] = device_time_ms(lambda: fn(gray8k), reps=5, inner=3)
        print(f"sharded path [{spec}] {MAIN_H}x{MAIN_W} gray over {N_SHARDS} slots, serial: "
              f"swar {times['swar']:.4f} ms, cuda {times['cuda']:.4f} ms")


# --------------------------------------------------------------------------
# The tools' kernels: T4 (roofline_probe), T2 (packed_proto), T3 (swar_proto)
# --------------------------------------------------------------------------


def tool_planes(shape, device, seed=1):
    """A seeded u8 plane of `shape`, then all 0 and all 255 and a 0/255
    checkerboard."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image

    seeded = torch.from_numpy(synthetic_image(*shape, channels=1, seed=seed)).to(device)
    return [seeded] + extreme_inputs(shape, 1, device)[:3]


# T3's shapes new with its redesign, (H, W, ext words past a 16-byte
# boundary): W 132, 4, 516 (Ws 33, 1, 129: no multiple of 4); ext 1 and 3
# words in; Ws under one 128-word strip; H = 1; H under one run (16 rows)
# and no multiple of it (37 = 16 + 16 + 5); a row of two warps, the second
# partly past Ws (W 1040); the 8K plane one word in
T3_SHAPES = [(48, 132, 0), (37, 132, 0), (1, 4, 0), (50, 516, 0), (48, 64, 1), (37, 128, 3),
             (50, 132, 1), (16, 64, 0), (1, 64, 0), (1, 132, 0), (5, 128, 0), (15, 256, 1),
             (37, 64, 0), (50, 1040, 0), (17, 520, 0), (MAIN_H, MAIN_W, 1)]


def offset_words(x, words: int):
    """`x`'s values in a contiguous tensor that starts `words` elements
    into a larger one (a slice of a bigger array); `x` itself for 0."""
    import torch

    if not words:
        return x
    big = torch.zeros(x.numel() + 8, dtype=x.dtype, device=x.device)
    view = big[words:words + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def phase1_tools(device, gray8k) -> int:
    """T4's copies and bitcasts, T2 and T3 against their plain versions, byte
    for byte; T3 unpacked against the golden gaussian:5; then the SWAR
    chains past the old 16-step limit (17 and 40 steps) and a filter past
    the old 512 tap words, on K6 and K8. Returns the case count."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_proto as pp
    from mpi_cuda_imagemanipulation_tpu_torch.tools import roofline_probe as rp
    from mpi_cuda_imagemanipulation_tpu_torch.tools import swar_proto as sp

    n = 0
    probe8k = torch.from_numpy(synthetic_image(rp.H, rp.W, channels=1, seed=99)).to(device)
    # T4: the probe's five arrays at its block heights on the 8K plane, then
    # small and odd shapes (W = 100: no 16-byte rows, the element path) and
    # flat planes at every block height
    arrays = [probe8k, probe8k.float(), pp.pack_u8(probe8k), probe8k.to(torch.int32),
              probe8k.float()[:, : rp.W // 4].contiguous()]
    small = [p for shape in ((36, 96), (44, 96), (37, 100)) for p in tool_planes(shape, device)]
    for x in arrays + small + [p.float() for p in small] + [p.to(torch.int32) for p in small]:
        for bh in rp.BLOCK_HEIGHTS + (1, 7):
            check_equal(f"T4 copy {tuple(x.shape)} {x.dtype} bh={bh}", rp.copy_probe(x, bh),
                        rp.copy_probe_plain(x))
            n += 1
    for x in [probe8k] + [p for p in small if p.shape[1] % 16 == 0]:
        for bh in rp.BLOCK_HEIGHTS + (5,):
            check_equal(f"T4 smem copy {tuple(x.shape)} bh={bh}", rp.smem_copy(x, bh), x)
            n += 1
    for x in [probe8k] + [p for p in small if p.shape[0] % 4 == 0 and p.shape[1] % 4 == 0]:
        for bh in rp.BLOCK_HEIGHTS + (8, 12):
            words = rp.bitcast_store(x, bh)
            check_equal(f"T4 bitcast store {tuple(x.shape)} bh={bh}", words,
                        rp.bitcast_store_plain(x))
            for lbh in (bh // 4, bh, 3):
                check_equal(f"T4 bitcast load {tuple(words.shape)} bh={lbh}",
                            rp.bitcast_load(words, lbh), x)
            n += 4
    # T2: the JAX self-test's shape and tile heights (24 leaves a ragged last
    # block), odd shapes, flat and checkerboard planes, the 8K frame
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops

    chain = make_pipeline_ops(pp.CHAIN)
    for shape, bhs in (((64, 256), (24, 128)), ((37, 128), (16, 5)), ((36, 96), (128,)),
                       ((MAIN_H, MAIN_W), (128, 96))):
        planes = tool_planes(shape, device, seed=shape[0])
        for i, p in enumerate(planes):
            rgb = [p, planes[(i + 1) % len(planes)], planes[(i + 2) % len(planes)]]
            words = [pp.pack_u8(q) for q in rgb]
            golden = torch.stack(rgb, dim=-1)
            for op in chain:
                golden = op(golden)
            for bh in bhs:
                got = pp.packed_gray_contrast(*words, block_h=bh)
                check_equal(f"T2 {shape} plane {i} bh={bh}", got,
                            pp.packed_gray_contrast_plain(*words))
                check_equal(f"T2 {shape} plane {i} bh={bh} vs golden", pp.unpack_u32(got), golden)
                n += 1
    pp.selftest(device)
    # T3: the JAX gate's shapes and ragged heights, flat and checkerboard
    # planes, the 8K plane at the timed block heights; unpacked == golden
    golden5 = Pipeline.parse("gaussian:5")
    for shape, bhs in (((48, 64), (16,)), ((37, 64), (16, 5)), ((50, 64), (24,)),
                       ((130, 256), (120, 7)), ((MAIN_H, MAIN_W), sp.BLOCK_HEIGHTS)):
        for i, p in enumerate(tool_planes(shape, device, seed=shape[0])):
            ext = sp.pack_quarters(sp.reflect_pad(p))
            want = sp.swar_words_plain(ext)
            for bh in bhs:
                got = sp.swar_proto(ext, bh)
                check_equal(f"T3 {shape} plane {i} bh={bh}", got, want)
                check_equal(f"T3 {shape} plane {i} bh={bh} vs golden", sp.unpack_quarters(got),
                            golden5(p))
                n += 1
    # the redesign's new shapes, each on the path sp.granule_path names:
    # Ws % 4 != 0, ext one or three words past a 16-byte boundary, Ws under
    # one strip, H = 1, H under one run or no multiple of it, the 8K plane
    # off a boundary
    paths = {True: 0, False: 0}
    for h, w, off in T3_SHAPES:
        for i, p in enumerate(tool_planes((h, w), device, seed=h + w)):
            ext = offset_words(sp.pack_quarters(sp.reflect_pad(p)), off)
            got = sp.swar_proto(ext, 16)
            name = f"T3 ({h}, {w}) plane {i} ext {off} words in"
            check_equal(name, got, sp.swar_words_plain(ext))
            check_equal(f"{name} vs golden", sp.unpack_quarters(got), golden5(p))
            paths[sp.granule_path(ext.data_ptr(), got.data_ptr(), w // 4)] += 1
            n += 1
    assert paths[True] and paths[False], paths
    print(f"  T3's new shapes: {paths[True]} cases on 16-byte granules, {paths[False]} on "
          f"4-byte words")
    sp.bitexact_gate(device)
    n += phase1_swar_chains(device, gray8k)
    torch.cuda.synchronize()
    print(f"phase 1: T4 copies and bitcasts, T2, T3 and the long SWAR chains equal to their "
          f"plain versions (max_abs_err 0): {n} cases")
    return n


def phase1_swar_chains(device, gray8k) -> int:
    """K6 with 17 and 40 pre-chain steps (and a post-chain), K8 with a 23x23
    integer filter (1058 tap words), against their plain versions; and the
    17-step pipeline through `run --impl swar` at 8K, equal to golden with
    one K6 launch."""
    import dataclasses

    import numpy as np
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import run_image
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op, make_pipeline_ops

    n = 0
    plane = torch.from_numpy(synthetic_image(257, 300, channels=1, seed=4)).to(device)
    st = make_op("gaussian:5")
    for steps, post in ((17, ()), (40, ("invert", "brightness:-3"))):
        pre = make_pipeline_ops(",".join(["brightness:1"] * steps))
        post_ops = tuple(make_op(s) for s in post)
        pc, qc = tuple(map(sk.swar_fusable, pre)), tuple(map(sk.swar_fusable, post_ops))
        for x in (plane, gray8k):
            want = sk.swar_stencil_plain(st, x, pre_chain=pc, post_chain=qc)
            for tile_h in (None, 7):
                check_equal(f"K6 gaussian:5 after {steps} steps {tuple(x.shape)} tile_h={tile_h}",
                            sk.swar_stencil(st, x, pre_ops=pre, post_ops=post_ops,
                                            block_h=tile_h), want)
                n += 1
    big = dataclasses.replace(make_op("sobel"), name="ones23", halo=11,
                              kernels=(np.ones((23, 23), np.float32),), combine="single",
                              scale=1.0 / 529)
    assert sk.swar_kind(big) == "K8"
    for x in (plane, gray8k[:1080]):
        check_equal(f"K8 23x23 filter {tuple(x.shape)}", sk.swar_stencil(big, x),
                    sk.swar_stencil_plain(big, x))
        n += 1
    spec = "grayscale," + ",".join(["brightness:1"] * 17) + ",gaussian:5"
    pipe = Pipeline.parse(spec)
    x8k = torch.from_numpy(synthetic_image(MAIN_H, MAIN_W, seed=0)).to(device)
    want = run_image(pipe, x8k, impl="torch", device=device, plan="off")
    ck.reset_launch_counts()
    out = run_image(pipe, x8k, impl="swar", device=device, plan="off")
    torch.cuda.synchronize()
    counts = {k: v for k, v in ck.launch_counts().items() if v}
    check_equal("swar path with a 17-step chain", out, want)
    if counts != {"K1": 2, "K6-narrow": 1}:
        raise AssertionError(f"swar path with a 17-step chain: launches {counts}")
    print(f"phase 1: {spec.split(',')[0]} + 17 x brightness:1 + gaussian:5 impl=swar at "
          f"{MAIN_H}x{MAIN_W}: == golden, launches {counts}")
    return n + 1


def phase2_tools(device) -> dict:
    """The tools' entry points on the card, in-process: `roofline_probe
    --quick`, the `packed_proto` self-test, `swar_proto --quick` and
    `packed_ab`, each with the launch counts set to 0 before it and read
    after it. Prints their records; fails if a tool's kernels were not
    launched or a record is missing. Returns {tool: (launch counts, best
    records)}; packed_ab's records are all its cases (it reports no
    bests)."""
    import contextlib
    import io

    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_ab as pab
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_proto as pp
    from mpi_cuda_imagemanipulation_tpu_torch.tools import roofline_probe as rp
    from mpi_cuda_imagemanipulation_tpu_torch.tools import swar_proto as sp

    # tool -> (entry point, arguments, kernels it must launch, best records wanted)
    tools = {
        "roofline_probe": (rp.main, ["--quick"],
                           ("T4-copy", "T4-smem-copy", "T4-bitcast-store", "T4-bitcast-load",
                            "K2", "T1"), 12),
        "packed_proto": (pp.main, [], ("T2",), 0),
        "swar_proto": (sp.main, ["--quick"], ("T3", "K2", "K6-narrow"), 8),
        "packed_ab": (pab.main, [], ("T1-pw", "T1", "T2", "K1", "K2"), 8),
    }
    runs = {}
    name = torch.cuda.get_device_name(0)
    for tool, (entry, argv, kernels, n_best) in tools.items():
        buf = io.StringIO()
        ck.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = entry(argv)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ck.launch_counts().items() if v}
        lines = buf.getvalue().splitlines()
        for line in lines:
            print(f"  {tool}: {line}")
        best = [json.loads(ln) for ln in lines
                if ln.startswith("{") and ('"stat"' in ln or tool == "packed_ab")]
        missing = [k for k in kernels if not counts.get(k)]
        if rc != 0 or missing or len(best) != n_best:
            raise AssertionError(f"{' '.join([tool] + argv)}: rc {rc}, launches {counts}, "
                                 f"kernels not launched {missing}, {len(best)} best records")
        if any(r["device"] != name or r["clock"] != "cuda events" for r in best):
            raise AssertionError(f"{tool}: records not from the card: {best}")
        runs[tool] = (counts, best)
        print(f"phase 2: {' '.join([tool] + argv)} on the card: launches {counts}")
    return runs


def phase3_tools(device, gray8k, tool_runs, record):
    """T4's kernels, T2 and T3 at their tools' shapes (the 8K plane or
    frame), each held against its plain version with `record`; K1 on T2's
    group and frame, and K2 and K6 narrow on T3's plane, timed beside them
    in the same run; the probe's copy rates as a share of the data sheet's
    3.35 TB/s."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op, make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_proto as pp
    from mpi_cuda_imagemanipulation_tpu_torch.tools import roofline_probe as rp
    from mpi_cuda_imagemanipulation_tpu_torch.tools import swar_proto as sp
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    csrc = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/"
    probe = "tools/roofline_probe.py"
    n_pix = rp.H * rp.W
    t4 = tool_runs["roofline_probe"][0]
    x = torch.from_numpy(synthetic_image(rp.H, rp.W, channels=1, seed=99)).to(device)
    for label, arr, c in (("u8", x, 1), ("f32", x.float(), 4), ("u32 packed", pp.pack_u8(x), 4)):
        out = torch.empty_like(arr)
        record(f"T4 copy_probe [{label} {tuple(arr.shape)}, block_h 128]", csrc + "copy_probe.cu",
               f"{probe}:88", t4["T4-copy"], lambda arr=arr: rp.copy_probe(arr, 128),
               lambda arr=arr: rp.copy_probe_plain(arr), c, c, [], n_pix=arr.numel(),
               library=lambda out=out, arr=arr: out.copy_(arr), split=True)
    out = torch.empty_like(x)
    record(f"T4 smem_copy [u8 {tuple(x.shape)}, block_h 128] for the lagged copy",
           csrc + "copy_probe.cu", f"{probe}:158", t4["T4-smem-copy"],
           lambda: rp.smem_copy(x, 128), lambda: rp.copy_probe_plain(x), 1, 1, [],
           library=lambda: out.copy_(x), split=True)
    words = rp.bitcast_store(x, 128)
    pack_view = x.view(rp.H // 4, 4, rp.W).transpose(1, 2)
    unpack_view = words.view(torch.uint8).view(rp.H // 4, rp.W, 4).transpose(1, 2)
    record("T4 bitcast_store [u8 -> u32 sublane words, block_h 128]", csrc + "copy_probe.cu",
           f"{probe}:217", t4["T4-bitcast-store"], lambda: rp.bitcast_store(x, 128),
           lambda: rp.bitcast_store_plain(x), 1, 1, [], library=lambda: pack_view.contiguous())
    record("T4 bitcast_load [u32 sublane words -> u8, block_h 128]", csrc + "copy_probe.cu",
           f"{probe}:232", t4["T4-bitcast-load"], lambda: rp.bitcast_load(words, 128),
           lambda: rp.bitcast_load_plain(words), 1, 1, [],
           library=lambda: unpack_view.contiguous())
    del words, out
    sweep = []
    for label, arr in (("u8", x), ("f32", x.float())):
        for bh in rp.BLOCK_HEIGHTS:
            ms = device_time_ms(lambda arr=arr, bh=bh: rp.copy_probe(arr, bh), reps=7)
            sweep.append(f"{label} bh {bh}: {ms:.4f} ms "
                         f"({2 * arr.numel() * arr.element_size() / ms / 1e6:.0f} GB/s)")
    for bh in rp.BLOCK_HEIGHTS:
        ms = device_time_ms(lambda bh=bh: rp.smem_copy(x, bh), reps=7)
        sweep.append(f"shared-memory u8 bh {bh}: {ms:.4f} ms ({2 * x.numel() / ms / 1e6:.0f} GB/s)")
    print("  T4 copies by block height in this run: " + "; ".join(sweep))
    for rec in tool_runs["roofline_probe"][1]:
        if rec.get("gb_s") and "copy" in rec["case"]:
            print(f"  copy rate {rec['case']} block_h {rec.get('block_h')}: {rec['gb_s']:.1f} "
                  f"GB/s, {rec['gb_s'] / (H100_BYTES_PER_S / 1e9):.1%} of 3.35 TB/s "
                  f"({rec['device']}, {rec['power_limit']})")

    # T2 at 8K beside K1 on the same group and frame
    rgb = torch.from_numpy(synthetic_image(MAIN_H, MAIN_W, seed=0)).to(device)
    planes = [pp.pack_u8(rgb[..., c].contiguous()) for c in range(3)]
    chain = list(make_pipeline_ops(pp.CHAIN))
    record("T2 packed_gray_contrast [grayscale,contrast3.5] 8K",
           csrc + "packed_proto.cu", "tools/packed_proto.py:141",
           tool_runs["packed_proto"][0]["T2"], lambda: pp.packed_gray_contrast(*planes),
           lambda: pp.packed_gray_contrast_plain(*planes), 3, 1, chain, n_pix=MAIN_H * MAIN_W)
    t_k1 = device_time_ms(lambda: ck.pointwise_group(chain, rgb), reps=7)
    # planes that start one word past a 16-byte boundary, one row shorter
    wp = MAIN_W // 4
    sliced = [p.reshape(-1)[1:1 + (MAIN_H - 1) * wp].view(MAIN_H - 1, wp) for p in planes]
    check_equal("T2 on planes one word in", pp.packed_gray_contrast(*sliced),
                pp.packed_gray_contrast_plain(*sliced))
    t_sliced = device_time_ms(lambda: pp.packed_gray_contrast(*sliced), reps=7)
    print(f"  K1 on the same group and frame ((H, W, 3) u8 in, gray out) in this run: "
          f"{t_k1:.4f} ms; T2 on planes one word past a 16-byte boundary: {t_sliced:.4f} ms")
    del planes, rgb

    # T3 at 8K beside K6 narrow and K2 on the same plane; its bound is the
    # larger of its bytes and its counted integer instructions
    g5 = make_op("gaussian:5")
    ext = sp.pack_quarters(sp.reflect_pad(x))
    strip_words, run_h = sp.launch_shape(rp.H, rp.W // 4)
    words = rp.H * rp.W // 4
    record(f"T3 swar_proto [gaussian5] quarter-strip words 8K, {strip_words}-word strips, "
           f"{run_h}-row runs", csrc + "swar_proto.cu",
           "tools/swar_proto.py:122", tool_runs["swar_proto"][0]["T3"],
           lambda: sp.swar_proto(ext, 240), lambda: sp.swar_words_plain(ext), 1, 1, [g5],
           strip_bytes=ext.numel() * 4 - n_pix, library=conv_library(g5, x, pad_rows=True),
           ops_ms=T3_INT_OPS_PER_WORD * words / H100_INT32_OPS_PER_S * 1e3, split=True)
    t_k6 = device_time_ms(lambda: sk.swar_stencil(g5, x), reps=7)
    t_k2 = device_time_ms(lambda: ck.stream_stencil([], g5, x), reps=7)
    t_e2e = device_time_ms(lambda: sp.gaussian5(x, 240), reps=7)
    print(f"  on the same 8K gray plane in this run: K6 narrow {t_k6:.4f} ms (device "
          f"{padded_device_ms(lambda: sk.swar_stencil(g5, x)):.4f}), K2 {t_k2:.4f} ms, "
          f"T3 with pad, pack and unpack {t_e2e:.4f} ms; T3's integer instructions "
          f"{T3_INT_OPS_PER_WORD} a word: "
          f"{T3_INT_OPS_PER_WORD * words / H100_INT32_OPS_PER_S * 1e3:.4f} ms at 16.7 T/s")
    print(f"  T3 build: {t3_build_summary()}")


# --------------------------------------------------------------------------
# T1 (tools/packed_kernels.py): the packed-word group runner
# --------------------------------------------------------------------------

# tests/test_packed.py's specs: every one runs fully or partly on T1
PACKED_SPECS = [
    "gaussian:3", "gaussian:5", "gaussian:7", "box:3", "box:5", "box:7",
    "invert,gaussian:5", "brightness:25,gaussian:3", "grayscale,gaussian:5",
    "grayscale,contrast:3.5", "grayscale601,box:3", "sepia", "threshold:99,gaussian:5,invert",
    "erode:3", "erode:5", "erode:7", "dilate:5", "invert,dilate:3", "sobel", "prewitt",
    "scharr", "laplacian:8", "sharpen", "unsharp", "emboss101:3", "emboss101:5", "median:3",
    "median:5", "filter:1/2/1/2/4/2/1/2/1:0.0625", "grayscale,sobel", "emboss:3", "emboss:5",
    "grayscale,contrast:3.5,emboss:3",
]
# odd shapes: the JAX test's 97x384 and its ragged heights (block_h 32), the
# last block shorter than the halo (33 and 34 rows), W/4 = 8 words, and
# W/4 < 128 (75 words), where the JAX docstring records a compiled-TPU
# miscompare
T1_SHAPES = [(97, 384), (33, 256), (64, 256), (65, 256), (95, 256), (129, 256), (34, 128),
             (40, 32), (37, 300)]
T1_GHOST_SPECS = ["gaussian:5", "sobel", "emboss:3", "median:5", "erode:3",
                  "grayscale,contrast:3.5,emboss:3"]


def t1_words(img):
    """The word planes of an (H, W) or (H, W, C) u8 image."""
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk

    planes = [img] if img.ndim == 2 else [img[..., c].contiguous() for c in range(img.shape[2])]
    return [pk.pack_words(p) for p in planes]


def t1_ghost_tile(img, k, n_shards, halo):
    """Shard `k` of `n_shards` row-shards of `img` with its raw ghost strips:
    the neighbours' rows, or the reflect101 extension at the image's first
    and last rows (as tests/test_packed.py builds them); y0."""
    h = img.shape[0]
    local_h = h // n_shards
    y0 = k * local_h
    top = img[y0 - halo:y0] if k else img[1:1 + halo].flip(0)
    bot = (img[y0 + local_h:y0 + local_h + halo] if k < n_shards - 1
           else img[h - 1 - halo:h - 1].flip(0))
    return img[y0:y0 + local_h], top.contiguous(), bot.contiguous(), y0


def check_t1(tag, pointwise, stencil, words, height, width, **kw) -> int:
    """One T1 launch against its plain version on the same card."""
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk

    got = pk.run_group_packed_words(pointwise, stencil, words, height, width, **kw)
    want = pk.run_group_packed_words_plain(pointwise, stencil, words, height, width, **kw)
    for c, (g, w) in enumerate(zip(got, want)):
        check_equal(f"{tag} plane {c}", g, w)
    return 1


def phase1_t1(device, gray8k, x8k) -> int:
    """T1-pw, T1 and T1g against their plain versions: every group T1 takes
    in the 33 specs at the odd shapes and block heights (the flat and
    checkerboard planes too at 97x384), block_h 32/64/96/400 at 130x512, the
    first, a middle and the last 1080x7680 shard tile of the 8K frame in
    ghost mode, the 8K gray gaussian:5 and the 8K RGB reference group, which
    runs fully packed. Returns the case count."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk

    n = 0
    for spec in PACKED_SPECS:
        groups = ck.group_ops(make_pipeline_ops(spec))
        channels = 3 if spec.startswith(("grayscale", "sepia")) else 1
        for shape in T1_SHAPES:
            imgs = [torch.from_numpy(synthetic_image(*shape, channels=channels, seed=41))
                    .to(device)]
            if shape == T1_SHAPES[0]:
                imgs += extreme_inputs(shape, channels, device)[:4]
            for img in imgs:
                for pw, st in groups:
                    if pk.packed_supported(pw, st, shape[1]):
                        for bh in (None, 32, 5):
                            n += check_t1(f"T1 {spec} group {[op.name for op in pw]} {st and st.name} "
                                          f"{tuple(img.shape)} block_h={bh}", pw, st, t1_words(img),
                                          *shape, block_h=bh)
                    img = ck.run_group(pw, st, img)
    # block_h sets nothing: 400, whose tile the first design refused for
    # its shared memory, gives the plain version's bytes too
    for spec, channels in (("gaussian:5", 1), ("sepia,gaussian:3", 3), ("sepia,gaussian:7", 3)):
        img = torch.from_numpy(synthetic_image(130, 512, channels=channels, seed=44)).to(device)
        for pw, st in ck.group_ops(make_pipeline_ops(spec)):
            for bh in (32, 64, 96, 400):
                n += check_t1(f"T1 {spec} 130x512 block_h={bh}", pw, st, t1_words(img), 130, 512,
                              block_h=bh)
            img = ck.run_group(pw, st, img)
    # ghost mode on the 8K frame's shard tiles: first, a middle, the last
    for spec in T1_GHOST_SPECS:
        (pw, st), = ck.group_ops(make_pipeline_ops(spec))
        img = x8k if spec.startswith("grayscale") else gray8k
        for k in (0, 1, N_SHARDS - 1):
            tile, top, bot, y0 = t1_ghost_tile(img, k, N_SHARDS, st.halo)
            for bh in (None, 32):
                n += check_t1(f"T1g {spec} shard {k} block_h={bh}", pw, st, t1_words(tile),
                              tile.shape[0], MAIN_W, block_h=bh,
                              ghosts=(t1_words(top), t1_words(bot)), y0=y0, image_h=MAIN_H)
    # the 8K gray gaussian:5 and the 8K RGB reference group
    for spec, img in (("gaussian:5", gray8k), ("grayscale,contrast:3.5,emboss:3", x8k)):
        (pw, st), = ck.group_ops(make_pipeline_ops(spec))
        for bh in (None, 32):
            n += check_t1(f"T1 {spec} 8K block_h={bh}", pw, st, t1_words(img), MAIN_H, MAIN_W,
                          block_h=bh)
    pw, _ = split_group("grayscale,contrast:3.5")
    n += check_t1("T1-pw grayscale,contrast:3.5 8K", pw, None, t1_words(x8k), MAIN_H, MAIN_W)
    torch.cuda.synchronize()
    print(f"phase 1: T1-pw, T1 and T1g equal to their plain versions (max_abs_err 0): {n} cases")
    return n


# the redesigned T1's stencil groups: every family and halo, chains
T1_CHUNK_SPECS = ["gaussian:5", "gaussian:7", "box:3", "sobel", "scharr", "median:5", "median:3",
                  "erode:3", "dilate:5", "laplacian:8", "emboss:3", "emboss:5",
                  "invert,gaussian:5", "brightness:25,median:3"]
# word widths: 8 words, not a multiple of 4, odd (row slices at every offset)
T1_CHUNK_WPS = (8, 11, 75)


@contextlib.contextmanager
def t1_shape(chunk_h, target):
    """T1's launch shape for a block of cases: chunks of `chunk_h` rows and
    about `target` blocks (1: one run per strip, so that every block walks
    the whole height and carries rows over every chunk boundary); the
    module's own settings are put back after."""
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk

    saved = pk.CHUNK_H, pk.TARGET_BLOCKS
    pk.CHUNK_H, pk.TARGET_BLOCKS = chunk_h, target
    pk.packed_tile_shape.cache_clear()
    try:
        yield
    finally:
        pk.CHUNK_H, pk.TARGET_BLOCKS = saved
        pk.packed_tile_shape.cache_clear()


def phase1_t1_redesign(device) -> int:
    """The redesigned T1, T1-pw and T2 against their plain versions: T1 at
    heights of 1 to 2h + 1 rows either side of each chunk boundary, at the
    default chunk height and a 5-row one, one run per strip (the runs the
    host cuts are phase1_t1's); widths of 8, 11 and 75 words, the planes
    row slices that start at word offsets 0-3; RGB chains into
    stencils; ghost tiles at the top, middle and bottom of an image; T1-pw
    for 1 -> 1, 1 -> 3, 3 -> 1 and 3 -> 3 chains and T2, on planes of 1 to
    1081 rows at ragged widths, each input at word offsets 0-3. Returns
    the case count."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_proto as pp

    n = 0
    # the first rows of the slices: from row a, a plane of wp words starts
    # at word offset a * wp mod 4 (75 words: 0, 3, 2, 1; 11 words: 3, 1)
    offsets = {8: (0,), 11: (1, 3), 75: (0, 1, 2, 3)}
    for chunk_h, wps in ((pk.CHUNK_H, T1_CHUNK_WPS), (5, T1_CHUNK_WPS[1:])):
        with t1_shape(chunk_h, 1):
            for spec in T1_CHUNK_SPECS:
                pw, st = split_group(spec)
                h = st.halo
                heights = sorted({chunk_h * m + d for m in (1, 2, 3)
                                  for d in range(-2 * h - 1, 2 * h + 2) if chunk_h * m + d > h})
                for wp in wps:
                    for rows in heights:
                        img = torch.from_numpy(synthetic_image(rows + 3, 4 * wp, channels=1,
                                                               seed=rows)).to(device)
                        planes = t1_words(img)
                        for a in offsets[wp]:
                            n += check_t1(f"T1 {spec} chunk {chunk_h} {wp} words {rows} rows "
                                          f"from row {a}", pw, st,
                                          [p[a:a + rows] for p in planes], rows, 4 * wp)
            for spec in ("grayscale,gaussian:5", "sepia,gaussian:3",
                         "grayscale,contrast:3.5,emboss:3", "sepia,median:3", "grayscale,sobel"):
                pw, st = split_group(spec)
                for rows in (chunk_h - 1, chunk_h + 3, 3 * chunk_h + 1):
                    img = torch.from_numpy(synthetic_image(rows + 1, 300, channels=3,
                                                           seed=rows)).to(device)
                    planes = t1_words(img)
                    n += check_t1(f"T1 {spec} RGB chunk {chunk_h} {rows} rows", pw, st,
                                  [p[1:] for p in planes], rows, 300)
            img = torch.from_numpy(synthetic_image(3 * chunk_h + 7, 300, channels=1,
                                                   seed=3)).to(device)
            for spec in ("gaussian:5", "sobel", "emboss:3", "median:5", "invert,dilate:3"):
                pw, st = split_group(spec)
                for k in range(3):  # the top, a middle and the bottom tile
                    tile, top, bot, y0 = t1_ghost_tile(img, k, 3, st.halo)
                    n += check_t1(f"T1g {spec} chunk {chunk_h} tile {k}", pw, st,
                                  t1_words(tile.contiguous()), tile.shape[0], 300,
                                  ghosts=(t1_words(top), t1_words(bot)), y0=y0,
                                  image_h=img.shape[0])
    for spec, ch in (("invert,brightness:9", 1), ("gray2rgb,sepia", 1),
                     ("grayscale,contrast:3.5", 3), ("sepia,invert", 3)):
        pw = list(make_pipeline_ops(spec))
        for rows, width in ((1, 36), (5, 44), (37, 300), (1081, 7676)):
            img = torch.from_numpy(synthetic_image(rows + 3, width, channels=ch,
                                                   seed=rows)).to(device)
            planes = t1_words(img)
            for a in range(4):
                words = [p[a:a + rows] for p in planes]
                n += check_t1(f"T1-pw {spec} {rows}x{width} from row {a}", pw, None, words,
                              rows, width)
                if ch == 3 and spec == pp.CHAIN:
                    want = pp.packed_gray_contrast_plain(*words)
                    for bh in (pp.DEFAULT_BLOCK_H, 1, 400):  # block_h sets nothing
                        check_equal(f"T2 {rows}x{width} from row {a} block_h={bh}",
                                    pp.packed_gray_contrast(*words, block_h=bh), want)
                        n += 1
    torch.cuda.synchronize()
    print(f"phase 1: the redesigned T1 at chunk boundaries, narrow and ragged strips, row "
          f"slices at word offsets 0-3 and ghost tiles, T1-pw and T2 at word offsets 0-3, equal "
          f"to their plain versions (max_abs_err 0): {n} cases")
    return n


def phase2_t1_ghost(device, gray8k) -> dict:
    """T1g's path: the 8K gray frame's gaussian:5 as four 1080-row shards,
    each through ``run_group_packed(ghosts=...)`` with its neighbours' rows
    (reflect101 at the image's edges) as strips, stitched, equal to the
    golden ops; the launch counts set to 0 before and read after. Returns
    the counts."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk

    pipe = Pipeline.parse("gaussian:5")
    want = pipe.jit("torch", device=device, plan="off")(gray8k)
    (pw, st), = ck.group_ops(pipe.ops)
    ck.reset_launch_counts()
    outs = []
    for k in range(N_SHARDS):
        tile, top, bot, y0 = t1_ghost_tile(gray8k, k, N_SHARDS, st.halo)
        outs += pk.run_group_packed(pw, st, [tile.contiguous()], ghosts=([top], [bot]), y0=y0,
                                    image_h=MAIN_H)
    out = torch.cat(outs, dim=0)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ck.launch_counts().items() if v}
    check_equal("T1g stitch of four shards, gaussian:5 8K gray", out, want)
    if counts != {"T1g": N_SHARDS}:
        raise AssertionError(f"T1g stitch: launches {counts}")
    print(f"phase 2: gaussian:5 on the 8K gray frame as {N_SHARDS} packed shards with ghost "
          f"strips: == golden, launches {counts}")
    return counts


def phase3_t1(device, gray8k, tool_runs, record):
    """T1 on the 8K gray gaussian:5 and T1-pw on packed_ab's group (2160 x
    3840 RGB, seed 31), launches from packed_ab's run; T1g on one 1080-row
    shard of the same gaussian:5, launches from the ghost path. Each is
    held against its plain version with `record`; K2 / K1 on the same input
    are timed beside them in the same run, with `F.conv2d` for gaussian:5.
    T1 returns a list of word planes: the records time it whole and compare
    its one plane."""
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_ab as pab
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    import torch

    src = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/packed_stream.cu"
    ab = tool_runs["packed_ab"][0]
    pw5, st5 = split_group("gaussian:5")
    words = t1_words(gray8k)
    record("T1 packed_stream [gaussian5] 8K gray words", src, "tools/packed_kernels.py:752",
           ab["T1"], lambda: pk.run_group_packed_words(pw5, st5, words, MAIN_H, MAIN_W)[0],
           lambda: pk.run_group_packed_words_plain(pw5, st5, words, MAIN_H, MAIN_W)[0], 1, 1,
           [st5], library=conv_library(st5, gray8k, pad_rows=True))
    t_k2 = device_time_ms(lambda: ck.stream_stencil(pw5, st5, gray8k), reps=7)
    print(f"  K2 on the same 8K gray plane in this run: {t_k2:.4f} ms")
    tile, top, bot, y0 = t1_ghost_tile(gray8k, 1, N_SHARDS, st5.halo)
    tw, ghosts = t1_words(tile.contiguous()), (t1_words(top), t1_words(bot))
    rows = tile.shape[0]
    ext = torch.cat([top, tile, bot])
    record("T1g packed_stream [gaussian5] one 1080x7680 gray shard", src,
           "tools/packed_kernels.py:752", tool_runs["t1_ghost"][0]["T1g"],
           lambda: pk.run_group_packed_words(pw5, st5, tw, rows, MAIN_W, ghosts=ghosts, y0=y0,
                                             image_h=MAIN_H)[0],
           lambda: pk.run_group_packed_words_plain(pw5, st5, tw, rows, MAIN_W, ghosts=ghosts,
                                                   y0=y0, image_h=MAIN_H)[0],
           1, 1, [st5], n_pix=rows * MAIN_W, strip_bytes=2 * st5.halo * MAIN_W,
           library=conv_library(st5, ext, pad_rows=False))
    t_k2g = device_time_ms(lambda: ck.stream_stencil_ghost(
        pw5, st5, tile.contiguous(), top, bot, y0=y0, image_h=MAIN_H, image_w=MAIN_W), reps=7)
    print(f"  K2g on the same shard in this run: {t_k2g:.4f} ms")
    del words, tw, ext
    h, w = 2160, 3840
    rgb = torch.from_numpy(synthetic_image(h, w, channels=3, seed=31)).to(device)
    pw, _ = split_group(pab.CHAIN)
    planes = t1_words(rgb)
    record(f"T1-pw packed_stream [grayscale,contrast3.5] {h}x{w} RGB words", src,
           "tools/packed_kernels.py:676", ab["T1-pw"],
           lambda: pk.run_group_packed_words(pw, None, planes, h, w)[0],
           lambda: pk.run_group_packed_words_plain(pw, None, planes, h, w)[0], 3, 1, pw,
           n_pix=h * w)
    t_k1 = device_time_ms(lambda: ck.pointwise_group(pw, rgb), reps=7)
    print(f"  K1 on the same group and frame ((H, W, 3) u8 in, gray out) in this run: "
          f"{t_k1:.4f} ms")
    for rec in tool_runs["packed_ab"][1]:
        print(f"  packed_ab {rec['case']}: {rec['ms']:.4f} ms, {rec['mp_s']:.1f} MP/s, "
              f"{rec['gb_s']:.1f} GB/s ({rec['device']}, {rec['power_limit']})")


def op_count(ops, n_pix: int, c_in: int) -> int:
    """Float32 operations a group or stage does per image, counted from its
    ops: each pointwise op per pixel, each stencil per pixel and plane."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import MEDIAN_NETWORKS, StencilOp

    per_op = {"grayscale": 8, "grayscale601": 8, "sepia": 27, "gray2rgb": 0,
              "invert": 1, "threshold": 1, "solarize": 2}
    total, c = 0, c_in
    for op in ops:
        if not isinstance(op, StencilOp):
            total += per_op.get(op.name.rstrip("0123456789.-"), 6) * n_pix
            c = op.out_channels or c
            continue
        k = 2 * op.halo + 1
        if op.reduce == "median":
            st = 2 * len(MEDIAN_NETWORKS[k][0])
        elif op.reduce in ("min", "max"):
            st = 2 * (k - 1)
        elif op.separable is not None:
            st = 2 * (2 * k - 1) + 1
        else:
            nnz = sum(int((w != 0).sum()) for w in op.kernels)
            st = 2 * nnz + (4 if op.combine == "magnitude" else 0) + 1
        total += (st + 3) * n_pix * c
    return total


def bound(nbytes: int, ops: int, ops_ms: float | None = None) -> tuple[float, str]:
    """The least time for `nbytes` of device memory traffic and `ops`
    float32 operations (or, given, `ops_ms` for the operations)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3 if ops_ms is None else ops_ms
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k5_ops_ms(ops, arms, n_pix: int, c_in: int) -> float:
    """Least time for a stage's operations with its stencils on the given
    in-stage arms: each tensor-core stencil's useful multiply-adds (two
    operations per nonzero tap, per pixel and plane) at the dense peak of
    its form, the rest as `op_count` counts it at the float32 rate."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import StencilOp

    tc_ms, c = 0.0, c_in
    for op, arm in zip(ops, arms):
        if isinstance(op, StencilOp) and arm != "vpu":
            nnz = sum(int((w != 0).sum()) for w in op.kernels)
            tc_ms += 2 * nnz * n_pix * c / H100_TC_OPS_PER_S[arm] * 1e3
        elif not isinstance(op, StencilOp):
            c = op.out_channels or c
    rest = [op for op, arm in zip(ops, arms) if arm == "vpu"]
    return tc_ms + op_count(rest, n_pix, c_in) / H100_F32_OPS_PER_S * 1e3


def conv_library(op, x, pad_rows: bool):
    """One PyTorch call that computes a lone correlation stencil: a
    depthwise float32 `F.conv2d` (TF32 off) over the planes of the u8 image
    or pre-extended tile `x`, padded by the op's halo beforehand (columns
    always, rows unless the tile already carries them). The yardstick for
    `library_ms`; it leaves out the rounding to u8 and pads by reflection
    whatever the op's edge mode (border pixels only, the same work)."""
    import torch
    import torch.nn.functional as F

    h, k = op.halo, 2 * op.halo + 1
    c = x.shape[2] if x.ndim == 3 else 1
    planes = x.reshape(x.shape[0], x.shape[1], c).permute(2, 0, 1)[None].float()
    xf = F.pad(planes, (h, h, h if pad_rows else 0, h if pad_rows else 0), mode="reflect")
    weight = torch.as_tensor(op.kernels[0] * op.scale, dtype=torch.float32, device=x.device)
    weight = weight.expand(c, 1, k, k).contiguous()
    return lambda: F.conv2d(xf, weight, groups=c)


def phase3(device, x8k, launches, sharded_launches, mxu_launches, gray8k, swar_launches,
           tool_runs):
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import image_runner
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    n_pix = MAIN_H * MAIN_W
    mp = n_pix / 1e6
    rows = []
    k2 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/stream_stencil.cu"
    k4 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/fused_stage.cu"

    def record(name, source, replaces, launch_count, fn, plain, c_in, c_out, ops,
               library=None, n_pix=n_pix, strip_bytes=0, ops_ms=None, split=False):
        """Time one kernel beside its plain version. The bound counts
        `n_pix` pixels read at c_in and written at c_out bytes, plus
        `strip_bytes` of ghost rows read once, and the operations `ops`
        does (or `ops_ms` for them). `split`: also print its device, host
        and back-to-back times and the library call's (`split_ms`)."""
        got, want = fn(), plain()
        err = int((got.int() - want.int()).abs().max().item())
        if err:
            raise AssertionError(f"{name}: kernel != plain, max abs err {err}")
        ms = device_time_ms(fn, reps=7)
        plain_ms = device_time_ms(plain, reps=3, inner=2)
        library_ms = device_time_ms(library, reps=7) if library is not None else None
        nbytes = (c_in + c_out) * n_pix + strip_bytes
        bound_ms, bound_by = bound(nbytes, op_count(ops, n_pix, c_in), ops_ms)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launch_count, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        }
        rows.append(row)
        print(f"kernel {name}: {ms:.4f} ms ({n_pix / 1e6 / ms * 1e3:.1f} MP/s), bound "
              f"{bound_ms:.4f} ms by {bound_by} ({bound_ms / ms:.1%}), plain "
              f"{plain_ms:.4f} ms, library {library_ms}, launches {launch_count}")
        if split:
            parts = {"kernel": split_ms(fn)}
            if library is not None:
                parts["library"] = split_ms(library)
            print(f"  split {name}: " + "; ".join(
                f"{k} device {v['device_ms']:.4f} ms, host "
                f"{v['host_ms']:.4f} ms, back-to-back {v['b2b_ms']:.4f} ms"
                for k, v in parts.items()) + f"; bound {bound_ms:.4f} ms by {bound_by}")

    # K2 on the reference group: 8K RGB in, gray out
    pw, st = split_group(SPECS["reference"])
    record(
        "K2 stream_stencil [grayscale,contrast3.5,emboss3]", k2,
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:377",
        launches["reference", "off"]["K2"],
        lambda: ck.stream_stencil(pw, st, x8k),
        lambda: ck.stream_stencil_plain(pw, st, x8k), 3, 1, pw + [st], split=True,
    )
    # K1 on the reference path: the gray result replicated to RGB
    gray = ck.stream_stencil(pw, st, x8k)
    g2r, _ = split_group("gray2rgb")
    record(
        "K1 pointwise_group [gray2rgb]",
        "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/pointwise.cu",
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:540",
        launches["reference", "off"]["K1"],
        lambda: ck.pointwise_group(g2r, gray),
        lambda: ck.pointwise_group_plain(g2r, gray), 1, 3, g2r,
        library=lambda: gray[..., None].expand(-1, -1, 3).contiguous(), split=True,
    )
    # K2 on gaussian:5, RGB in and out; the yardstick is a depthwise
    # float32 convolution of the pre-padded planes (TF32 off)
    pw5, st5 = split_group(SPECS["gaussian5_8k"])
    conv5 = conv_library(st5, x8k, pad_rows=True)
    record(
        "K2 stream_stencil [gaussian5]", k2,
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:377",
        launches["gaussian5_8k", "off"]["K2"],
        lambda: ck.stream_stencil(pw5, st5, x8k),
        lambda: ck.stream_stencil_plain(pw5, st5, x8k), 3, 3, pw5 + [st5],
        library=conv5, split=True,
    )
    # K4 on the gaussian:5 path's one stage, RGB in and out, beside the same
    # convolution
    record(
        "K4 fused_stage [gaussian5]", k4,
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:993",
        launches["gaussian5_8k", "fused-pallas"]["K4"],
        lambda: ck.fused_stage([st5], x8k), lambda: ck.fused_stage_plain([st5], x8k),
        3, 3, [st5], library=conv5, split=True,
    )
    del conv5
    # the two K2 launches of the megakernel chain under plan off: the
    # prologue fused into gaussian:5 (RGB in, gray out), then sharpen on gray
    (pwm, stm), (pws, sts), _ = ck.group_ops(make_pipeline_ops(SPECS["megakernel_ab"]))
    graym = ck.stream_stencil(pwm, stm, x8k)
    record(
        "K2 stream_stencil [grayscale,contrast3.5,gaussian5]", k2,
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:377",
        launches["megakernel_ab", "off"]["K2"],
        lambda: ck.stream_stencil(pwm, stm, x8k),
        lambda: ck.stream_stencil_plain(pwm, stm, x8k), 3, 1, pwm + [stm], split=True,
    )
    record(
        "K2 stream_stencil [sharpen] gray", k2,
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:377",
        launches["megakernel_ab", "off"]["K2"],
        lambda: ck.stream_stencil(pws, sts, graym),
        lambda: ck.stream_stencil_plain(pws, sts, graym), 1, 1, [sts],
        library=conv_library(sts, graym, pad_rows=True), split=True,
    )
    # K1 on the same path's quantize:6 over the sharpened 8K gray plane;
    # posterize to 6 bits keeps the top bits, so the yardstick is one
    # bitwise_and with 0xFC (held equal to the plain version here)
    (pwq, _), = ck.group_ops(make_pipeline_ops("quantize:6"))
    sharp = ck.stream_stencil(pws, sts, graym)
    if not torch.equal(torch.bitwise_and(sharp, QUANTIZE6_MASK),
                       ck.pointwise_group_plain(pwq, sharp)):
        raise AssertionError("quantize:6 != bitwise_and with 0xFC")
    record(
        "K1 pointwise_group [quantize6] 8K gray",
        "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/pointwise.cu",
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:540",
        launches["megakernel_ab", "off"]["K1"],
        lambda: ck.pointwise_group(pwq, sharp), lambda: ck.pointwise_group_plain(pwq, sharp),
        1, 1, pwq, library=lambda: torch.bitwise_and(sharp, QUANTIZE6_MASK), split=True,
    )
    del sharp
    # K4 on the first stage of the reference and megakernel paths, 8K RGB
    # in, gray out; no single PyTorch call computes a fused stage
    for key in ("reference", "megakernel_ab"):
        ops = make_pipeline_ops(SPECS[key])
        record(
            f"K4 fused_stage [{','.join(op.name for op in ops)}]", k4,
            "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:993",
            launches[key, "fused-pallas"]["K4"],
            lambda ops=ops: ck.fused_stage(ops, x8k),
            lambda ops=ops: ck.fused_stage_plain(ops, x8k), 3, 1, ops, split=True,
        )
    # K4 on the halo-0 stage that replicates gray to RGB on the same path
    record(
        "K4 fused_stage [gray2rgb]", k4,
        "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:993",
        launches["reference", "fused-pallas"]["K4"],
        lambda: ck.fused_stage(g2r, gray), lambda: ck.fused_stage_plain(g2r, gray), 1, 3, g2r,
        library=lambda: gray[..., None].expand(-1, -1, 3).contiguous(), split=True,
    )

    phase3_sharded(device, x8k, graym, sharded_launches, record)
    del graym
    phase3_k5(device, x8k, mxu_launches, record)
    phase3_swar(device, x8k, gray8k, swar_launches, record)
    phase3_tools(device, gray8k, tool_runs, record)
    phase3_t1(device, gray8k, tool_runs, record)

    # each path's bound: every launch reads its input and writes its output
    # once (gray paths: 3 -> 1 B, then 1 -> 3 B; gaussian:5: 3 -> 3 B),
    # under either plan
    path_bytes = {"reference": 8 * n_pix, "gaussian5_8k": 6 * n_pix,
                  "megakernel_ab": 8 * n_pix}
    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        bound_ms = path_bytes[key] / H100_BYTES_PER_S * 1e3
        golden = image_runner(pipe, impl="torch", device=device, plan="off")
        t_golden = device_time_ms(lambda: golden(x8k), reps=5, inner=3)
        for plan in PLANS:
            runner = image_runner(pipe, impl="cuda", device=device, plan=plan)
            t = device_time_ms(lambda: runner(x8k), reps=5, inner=3)
            print(f"path {key} [{spec}] plan={plan} {MAIN_H}x{MAIN_W} RGB in, RGB out: "
                  f"cuda {t:.4f} ms ({mp / t * 1e3:.1f} MP/s), bound {bound_ms:.4f} ms by "
                  f"bytes ({bound_ms / t:.1%}), golden torch ops {t_golden:.4f} ms "
                  f"({mp / t_golden * 1e3:.1f} MP/s), launches {launches[key, plan]}")

    # K2's block rows on the 8K gaussian:5 and reference group
    for label, (pwt, stt) in (("gaussian5", (pw5, st5)), ("reference", (pw, st))):
        t_rows = {rows: device_time_ms(lambda rows=rows, pwt=pwt, stt=stt: ck.stream_stencil(
            pwt, stt, x8k, tile_h=rows), reps=5) for rows in (8, 16, 32, 64)}
        print(f"sweep K2 [{label}] 8K by tile_h: " +
              ", ".join(f"{r}: {t:.4f} ms" for r, t in t_rows.items()))

    # every stencil of the registry through K2 at 8K RGB, kernel time only
    for spec in STENCIL_CASES:
        pws, sts = split_group(spec)
        ms = device_time_ms(lambda pws=pws, sts=sts: ck.stream_stencil(pws, sts, x8k),
                            reps=3, inner=5)
        bms, by = bound(6 * n_pix, op_count(pws + [sts], n_pix, 3))
        print(f"sweep K2 {spec} 8K RGB: {ms:.4f} ms, bound {bms:.4f} ms by {by} "
              f"({bms / ms:.1%})")
    return rows


def phase3_k5(device, x8k, mxu_launches, record):
    """K5's times in each form at the main stages' shapes (8K, and K4g on a
    middle 1080 x 7680 shard), each held against its plain version and
    printed beside the VPU arm's time in the same run, then each
    tensor-core path end to end. `record` appends the kernels' rows."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import image_runner
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    n_pix = MAIN_H * MAIN_W
    local_h = MAIN_H // N_SHARDS
    y0 = local_h
    kw = dict(y0=y0, image_h=MAIN_H, image_w=MAIN_W)
    # form -> (setting, label, the phase-2 run whose launches count)
    forms = {"mxu-int8": ("on", "int8", ("cuda", "fused-pallas-mxu")),
             "mxu": ("f32", "bf16", ("cuda", "f32"))}
    for key, c_out in (("reference", 1), ("gaussian5_8k", 3), ("megakernel_ab", 1)):
        ops = make_pipeline_ops(SPECS[key])
        names = ",".join(op.name for op in ops)
        H = chain_halo(ops)
        ext = x8k[y0 - H:y0 + local_h + H].contiguous()
        library = conv_library(ops[0], x8k, pad_rows=True) if len(ops) == 1 else None
        library_g = conv_library(ops[0], ext, pad_rows=False) if len(ops) == 1 else None
        vpu = ("vpu",) * len(ops)
        t_vpu = device_time_ms(lambda ops=ops: ck.fused_stage(ops, x8k, arms=vpu), reps=7)
        t_vpu_g = device_time_ms(lambda ops=ops: ck.fused_stage_ext(ops, ext, arms=vpu, **kw), reps=7)
        for arm, (setting, label, lkey) in forms.items():
            arms = ck.stage_arms(ops, setting)
            ck_key = K5_KEYS[arm]
            ops_ms = k5_ops_ms(ops, arms, n_pix, 3)
            record(
                f"K5 {label} in fused_stage [{names}]", K5_SOURCE, K5_REPLACES,
                mxu_launches[(key, *lkey)][ck_key],
                lambda ops=ops, arms=arms: ck.fused_stage(ops, x8k, arms=arms),
                lambda ops=ops, arms=arms: ck.fused_stage_plain(ops, x8k, arms=arms),
                3, c_out, ops, library=library, ops_ms=ops_ms, split=True,
            )
            print(f"  operations bound {ops_ms:.4f} ms; the VPU arm of K4 on the same stage "
                  f"in this run: {t_vpu:.4f} ms")
        # K4g's form on one shard: the int8 form, which the sharded main path
        # launches
        arms = ck.stage_arms(ops, "on")
        ops_ms = k5_ops_ms(ops, arms, local_h * MAIN_W, 3)
        record(
            f"K5 int8 in fused_stage_ext [{names}]", K5_SOURCE, K5_REPLACES,
            mxu_launches[key, "sharded", "cuda", "fused-pallas-mxu", "serial"]["K5-int8"],
            lambda ops=ops, arms=arms, ext=ext: ck.fused_stage_ext(ops, ext, arms=arms, **kw),
            lambda ops=ops, arms=arms, ext=ext: ck.fused_stage_ext_plain(
                ops, ext, arms=arms, **kw),
            3, c_out, ops, library=library_g, n_pix=local_h * MAIN_W,
            strip_bytes=2 * H * MAIN_W * 3, ops_ms=ops_ms, split=True,
        )
        print(f"  operations bound {ops_ms:.4f} ms; the VPU arm of K4g on the same shard in "
              f"this run: {t_vpu_g:.4f} ms")
        del ext, library, library_g
    torch.cuda.synchronize()

    mp = n_pix / 1e6
    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        for impl, plan in (("cuda", "fused-pallas-mxu"), ("mxu", "off")):
            runner = image_runner(pipe, impl=impl, device=device, plan=plan)
            t = device_time_ms(lambda: runner(x8k), reps=5, inner=3)
            used = {k: v for k, v in mxu_launches[key, impl, plan].items() if v}
            print(f"path {key} [{spec}] impl={impl} plan={plan} {MAIN_H}x{MAIN_W} RGB in, RGB "
                  f"out: {t:.4f} ms ({mp / t * 1e3:.1f} MP/s), launches {used}")


def host_enqueue_ms(fn, reps: int = 7) -> float:
    """Host milliseconds one call of `fn` takes to enqueue its work (no
    synchronise inside the timed region; the device is idle when it starts):
    the median of `reps` samples. Not a device time."""
    import statistics

    import torch

    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(samples)


# cycles of the spin kernel that keeps the stream busy while the host
# enqueues a timed call (about 2.5 ms at the H100's clock, longer than any
# wrapper's host time)
SPIN_CYCLES = 5_000_000


def padded_device_ms(fn, reps: int = 7) -> float:
    """Device milliseconds of one call of `fn`: CUDA events around it, the
    stream held busy beforehand by a spin kernel (`torch.cuda._sleep`) so
    that the call's kernels are queued before the start event runs and no
    host time falls between the events; the median of `reps`."""
    import statistics

    import torch

    fn()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def split_ms(fn) -> dict:
    """One call of `fn` three ways: the device time its kernels take
    (`padded_device_ms`), the host time it takes to enqueue
    (`host_enqueue_ms`), and CUDA events around calls back to back
    (`device_time_ms`, which reads host time where a call's host work is
    longer than its kernels)."""
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    return {"device_ms": padded_device_ms(fn), "host_ms": host_enqueue_ms(fn),
            "b2b_ms": device_time_ms(fn, reps=7)}


def phase3_sharded(device, x8k, gray8k, sharded_launches, record):
    """Times of K2g, K3, K4g and the per-shard K1 at the shapes the sharded
    main paths give them (a middle 1080 x 7680 shard of the 8K frame; the
    interior and one boundary band of the overlap mode), each held against
    its plain version, then of one strip exchange and of each sharded path
    end to end beside the unsharded one. `gray8k` is the megakernel chain's
    gray intermediate, the input of its second group. `record` appends the
    kernels' rows."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import halo
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    k1 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/pointwise.cu"
    k2 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/stream_stencil.cu"
    k4 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/fused_stage.cu"
    pk = "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py"
    local_h = MAIN_H // N_SHARDS
    y0 = local_h  # the second of four shards: neither edge
    n_pix = local_h * MAIN_W
    kw = dict(y0=y0, image_h=MAIN_H, image_w=MAIN_W)

    def cut(img, h):
        """The shard's tile of `img` and its two h-row ghost strips."""
        return (img[y0:y0 + local_h].contiguous(), img[y0 - h:y0].contiguous(),
                img[y0 + local_h:y0 + local_h + h].contiguous())

    def names(ops):
        return ",".join(op.name for op in ops)

    # K2g on every stencil group of the three paths: the tile and two
    # (halo, W[, 3]) strips in. A lone stencil on a middle shard is one
    # convolution of the extended tile; a fused group has no single call
    groups = [(key, src, pw, st)
              for key, src in (("reference", x8k), ("gaussian5_8k", x8k))
              for pw, st in [split_group(SPECS[key])]]
    (pwm, stm), (pws, sts), (pwq, _) = ck.group_ops(make_pipeline_ops(SPECS["megakernel_ab"]))
    groups += [("megakernel_ab", x8k, pwm, stm), ("megakernel_ab", gray8k, pws, sts)]
    for key, src, pw, st in groups:
        tile, top, bottom = cut(src, st.halo)
        c_in = src.shape[2] if src.ndim == 3 else 1
        c_out = next((op.out_channels for op in reversed(pw) if op.out_channels), c_in)
        library = None if pw else conv_library(st, torch.cat([top, tile, bottom]), pad_rows=False)
        record(
            f"K2g stream_stencil_ghost [{names(pw + [st])}]" + ("" if c_in == 3 else " gray"),
            k2, f"{pk}:377", sharded_launches[key, "off", "serial", False]["K2g"],
            lambda pw=pw, st=st, t=(tile, top, bottom): ck.stream_stencil_ghost(pw, st, *t, **kw),
            lambda pw=pw, st=st, t=(tile, top, bottom): ck.stream_stencil_ghost_plain(
                pw, st, *t, **kw),
            c_in, c_out, pw + [st], library=library, n_pix=n_pix,
            strip_bytes=2 * st.halo * MAIN_W * c_in, split=True,
        )
        del library
    # K1 on the megakernel chain's trailing pointwise run, one gray shard
    gtile = gray8k[y0:y0 + local_h].contiguous()
    record(
        f"K1 pointwise_group [{names(pwq)}] gray shard", k1, f"{pk}:540",
        sharded_launches["megakernel_ab", "off", "serial", False]["K1"],
        lambda: ck.pointwise_group(pwq, gtile), lambda: ck.pointwise_group_plain(pwq, gtile),
        1, 1, pwq, library=lambda: torch.bitwise_and(gtile, QUANTIZE6_MASK), n_pix=n_pix,
        split=True,
    )
    del gtile
    # K3 on gaussian:5 over the materialised (1084, W, 3) tile, as the padded
    # 4323-row run launches it
    _, st5 = split_group(SPECS["gaussian5_8k"])
    tile, top, bottom = cut(x8k, 2)
    ext = torch.cat([top, tile, bottom]).contiguous()
    record(
        "K3 stencil_tile [gaussian5]", k2, f"{pk}:787",
        sharded_launches["gaussian5_8k", "off", "serial", True]["K3"],
        lambda: ck.stencil_tile(st5, ext), lambda: ck.stencil_tile_plain(st5, ext),
        3, 3, [st5], library=conv_library(st5, ext, pad_rows=False), n_pix=n_pix,
        strip_bytes=4 * MAIN_W * 3, split=True,
    )
    # K3 as the overlap mode launches it, three times per group and shard:
    # the tile itself as the extended input of its interior (1076 rows out),
    # and a (3h, W, 3) boundary band (h rows out)
    k3_overlap = sharded_launches["gaussian5_8k", "off", "overlap", False]["K3"]
    record(
        "K3 stencil_tile [gaussian5] overlap interior", k2, f"{pk}:787", k3_overlap,
        lambda: ck.stencil_tile(st5, tile), lambda: ck.stencil_tile_plain(st5, tile),
        3, 3, [st5], library=conv_library(st5, tile, pad_rows=False),
        n_pix=(local_h - 4) * MAIN_W, strip_bytes=4 * MAIN_W * 3, split=True,
    )
    band = ext[:6].contiguous()
    record(
        "K3 stencil_tile [gaussian5] overlap band", k2, f"{pk}:787", k3_overlap,
        lambda: ck.stencil_tile(st5, band), lambda: ck.stencil_tile_plain(st5, band),
        3, 3, [st5], library=conv_library(st5, band, pad_rows=False),
        n_pix=2 * MAIN_W, strip_bytes=4 * MAIN_W * 3, split=True,
    )
    # K3 on the reference path's emboss:3 over the gray (1082, W) tile
    pwr, str_ = split_group(SPECS["reference"])
    tile1, top, bottom = cut(x8k, 1)
    ext1 = ck.pointwise_group(pwr, torch.cat([top, tile1, bottom]).contiguous())
    record(
        "K3 stencil_tile [emboss3] gray", k2, f"{pk}:787",
        sharded_launches["reference", "off", "serial", True]["K3"],
        lambda: ck.stencil_tile(str_, ext1), lambda: ck.stencil_tile_plain(str_, ext1),
        1, 1, [str_], library=conv_library(str_, ext1, pad_rows=False), n_pix=n_pix,
        strip_bytes=2 * MAIN_W, split=True,
    )
    del ext, ext1, band, tile1
    # K4g on the one stage of each path, over the (1080 + 2H, W, 3) tile;
    # the lone gaussian:5 stage is the same convolution as K3's
    for key, c_out in (("reference", 1), ("gaussian5_8k", 3), ("megakernel_ab", 1)):
        ops = make_pipeline_ops(SPECS[key])
        H = chain_halo(ops)
        tile, top, bottom = cut(x8k, H)
        ext = torch.cat([top, tile, bottom]).contiguous()
        library = conv_library(ops[0], ext, pad_rows=False) if len(ops) == 1 else None
        record(
            f"K4g fused_stage_ext [{names(ops)}]", k4, f"{pk}:993",
            sharded_launches[key, "fused-pallas", "serial", False]["K4g"],
            lambda ops=ops, ext=ext: ck.fused_stage_ext(ops, ext, **kw),
            lambda ops=ops, ext=ext: ck.fused_stage_ext_plain(ops, ext, **kw),
            3, c_out, ops, library=library, n_pix=n_pix, strip_bytes=2 * H * MAIN_W * 3,
            split=True,
        )
        del ext, library
    del tile, top, bottom

    # one exchange round of halo-1 and halo-3 RGB strips over the mesh
    mesh = sharded_mesh()
    tiles = [x8k[k * local_h:(k + 1) * local_h].to(mesh.devices[k]) for k in range(N_SHARDS)]
    for h in (1, 3):
        ms = device_time_ms(lambda h=h: halo.exchange_halo_strips(tiles, h, mesh), reps=5)
        print(f"exchange: one round of ({h}, {MAIN_W}, 3) strips over {N_SHARDS - 1} "
              f"boundaries ({6 * h * MAIN_W * 3} B copied): {ms:.4f} ms")
    del tiles

    # each sharded path end to end beside the unsharded one, no gray -> RGB
    mp = MAIN_H * MAIN_W / 1e6
    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        for plan in PLANS:
            one = pipe.jit("cuda", device=device, plan=plan)
            t_one = device_time_ms(lambda: one(x8k), reps=5, inner=3)
            times, enqueue = {}, {}
            for halo_mode in HALO_MODES:
                fn = pipe.sharded(mesh, backend="cuda", plan=plan, halo_mode=halo_mode)
                times[halo_mode] = device_time_ms(lambda: fn(x8k), reps=5, inner=3)
                enqueue[halo_mode] = host_enqueue_ms(lambda: fn(x8k))
            used = {k: v for k, v in
                    sharded_launches[key, plan, "serial", False].items() if v}
            print(f"sharded path {key} [{spec}] plan={plan} {MAIN_H}x{MAIN_W} RGB over "
                  f"{N_SHARDS} slots on {len(set(mesh.devices))} card(s): serial "
                  f"{times['serial']:.4f} ms ({mp / times['serial'] * 1e3:.1f} MP/s), overlap "
                  f"{times['overlap']:.4f} ms, unsharded {t_one:.4f} ms; host time to enqueue "
                  f"one call: serial {enqueue['serial']:.4f} ms, overlap "
                  f"{enqueue['overlap']:.4f} ms; serial launches {used}")


# --------------------------------------------------------------------------
# Phase 4: the rest of the registry, geometric and global-statistics ops
# --------------------------------------------------------------------------

# (pipeline, {(impl, plan): the launches of one Pipeline.jit call on the 8K
# RGB frame}); the geometric and global ops run as their own tensor ops, the
# kernels before and after them as the table in PERF.md section 6 says
REGISTRY_PATHS = [
    ("grayscale,equalize,gaussian:5", {
        ("cuda", "off"): {"K1": 1, "K2": 1},
        ("cuda", "fused-pallas"): {"K4": 2},
        ("cuda", "fused-pallas-mxu"): {"K4": 2, "K5-int8": 1},
        ("swar", "off"): {"K1": 1, "K6-narrow": 1}}),
    ("grayscale,gaussian:3,otsu", {("cuda", "off"): {"K2": 1},
                                   ("swar", "off"): {"K1": 1, "K6-narrow": 1}}),
    ("grayscale,autocontrast,emboss:3", {("cuda", "off"): {"K1": 1, "K2": 1},
                                         ("swar", "off"): {"K1": 1, "K7": 1}}),
    # colour planes: the SWAR route falls back to K2
    ("rot:90,gaussian:5", {("cuda", "off"): {"K2": 1}, ("swar", "off"): {"K2": 1}}),
    ("transpose,emboss:3", {("cuda", "off"): {"K2": 1}, ("swar", "off"): {"K2": 1}}),
    ("fliph,emboss:3,flipv", {("cuda", "off"): {"K2": 1}, ("swar", "off"): {"K2": 1}}),
    ("crop:0:0:2160:3840,gaussian:5", {("cuda", "off"): {"K2": 1},
                                       ("swar", "off"): {"K2": 1}}),
    ("pad:8:reflect101,gaussian:3", {("cuda", "off"): {"K2": 1}, ("swar", "off"): {"K2": 1}}),
    ("grayscale,resize:2160x3840,gaussian:5", {("cuda", "off"): {"K1": 1, "K2": 1},
                                               ("swar", "off"): {"K1": 1, "K6-narrow": 1}}),
    ("grayscale,scale:2,sobel", {("cuda", "off"): {"K1": 1, "K2": 1},
                                 ("swar", "off"): {"K1": 1, "K8": 1}}),
    ("rotate:30", {("cuda", "off"): {}, ("swar", "off"): {}}),
    ("rotate:-17:nearest", {("cuda", "off"): {}, ("swar", "off"): {}}),
]
# the sharded paths over the 4-slot mesh (cuda, plan off): pipeline -> the
# launches at 4320 rows and at 4323 (pad rows in the last shard: K3, and the
# mask keeps them out of the histogram); rot:90 turns 4323 rows into 7680
REGISTRY_SHARDED = {
    "grayscale,equalize,gaussian:5": ({"K1": 4, "K2g": 4}, {"K1": 4, "K3": 4}),
    "grayscale,gaussian:3,otsu": ({"K2g": 4}, {"K1": 4, "K3": 4}),
    "rot:90,gaussian:5": ({"K2g": 4}, {"K2g": 4}),
}
# the CPU cross-check's frame; the 8K crop's window halved to fit it
CROSS_H, CROSS_W = 1080, 1920
CROSS_SPEC = {"crop:0:0:2160:3840,gaussian:5": "crop:0:0:540:960,gaussian:5"}


def golden_and_bytes(ops, x):
    """The golden ops in sequence on `x` (Pipeline.apply), and the bytes
    the pipeline must move at least: each run of pointwise and stencil ops
    between barriers reads its input and writes its output once, a global
    op reads its input twice (the statistic, then the apply) and writes its
    output once, a geometric op reads its input and writes its output."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import op_family

    nbytes, run_in = 0, None
    for op in ops:
        fam = op_family(op)
        y = op(x)
        if fam in ("pointwise", "stencil"):
            run_in = x.numel() if run_in is None else run_in
            run_out = y.numel()
        else:
            if run_in is not None:
                nbytes += run_in + run_out
                run_in = None
            nbytes += (2 if fam == "global-stat" else 1) * x.numel() + y.numel()
        x = y
    if run_in is not None:
        nbytes += run_in + run_out
    return x, nbytes


def phase4_registry(device, x8k, gray8k):
    """The geometric and global-statistics ops on the card: each path of
    REGISTRY_PATHS through Pipeline.jit on the 8K RGB frame (seed 0), with
    exactly its launches, byte-equal to the golden ops on the card and, on
    the 1080x1920 frame, to the port's own CPU result on the same route;
    `rot:90,gaussian:5` through tools.packed_kernels.pipeline_packed on the
    8K gray plane (T1 on the stencil group); Pipeline.sharded over the
    4-slot mesh at 4320 and 4323 rows. Prints each path's device ms
    (padded_device_ms; bincount syncs the host, so a path with a histogram
    reads the host's enqueue after the sync too), its launches, its bytes
    bound at 3.35 TB/s, and for the sharded paths the host enqueue ms."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk

    def launched(fn):
        ck.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in ck.launch_counts().items() if v}

    def bound_ms(nbytes):
        return nbytes / H100_BYTES_PER_S * 1e3

    cross = torch.from_numpy(synthetic_image(CROSS_H, CROSS_W, seed=0))
    n_paths = 0
    for spec, lanes in REGISTRY_PATHS:
        pipe = Pipeline.parse(spec)
        want, nbytes = golden_and_bytes(pipe.ops, x8k)
        cross_pipe = Pipeline.parse(CROSS_SPEC.get(spec, spec))
        cross_want = cross_pipe(cross)
        check_equal(f"registry golden {cross_pipe.name} card vs CPU",
                    cross_pipe(cross.to(device)).cpu(), cross_want)
        for (impl, plan), exp in lanes.items():
            tag = f"registry path [{spec}] impl={impl} plan={plan}"
            fn = pipe.jit(impl, device=device, plan=plan)
            out, counts = launched(lambda: fn(x8k))
            check_equal(tag, out, want)
            if counts != exp:
                raise AssertionError(f"{tag}: launches {counts}, expected {exp}")
            # the same route on the CPU and on the card, 1080x1920
            on_card = cross_pipe.jit(impl, device=device, plan=plan)(cross.to(device)).cpu()
            on_cpu = cross_pipe.jit(impl, device="cpu", plan=plan)(cross)
            check_equal(f"{tag} 1080x1920 card vs CPU", on_card, on_cpu)
            check_equal(f"{tag} 1080x1920 CPU vs golden", on_cpu, cross_want)
            ms = padded_device_ms(lambda: fn(x8k))
            b = bound_ms(nbytes)
            print(f"registry: [{spec}] impl={impl} plan={plan} {MAIN_H}x{MAIN_W} RGB -> "
                  f"{tuple(want.shape)}: == golden (card) and CPU == card at "
                  f"{CROSS_H}x{CROSS_W}; device {ms:.4f} ms, launches {counts}, bytes "
                  f"{nbytes} -> bound {b:.4f} ms at 3.35 TB/s ({b / ms * 100:.1f}% of it)")
            n_paths += 1
        del want
    # T1 on the stencil group after the quarter turn
    spec = "rot:90,gaussian:5"
    pipe = Pipeline.parse(spec)
    want, nbytes = golden_and_bytes(pipe.ops, gray8k)
    out, counts = launched(lambda: pk.pipeline_packed(pipe.ops, gray8k))
    check_equal(f"pipeline_packed [{spec}] 8K gray", out, want)
    if counts != {"T1": 1}:
        raise AssertionError(f"pipeline_packed [{spec}]: launches {counts}, expected T1 1")
    ms = padded_device_ms(lambda: pk.pipeline_packed(pipe.ops, gray8k))
    print(f"registry: pipeline_packed [{spec}] {MAIN_H}x{MAIN_W} gray: == golden; device "
          f"{ms:.4f} ms, launches {counts}, bytes {nbytes} -> bound {bound_ms(nbytes):.4f} ms")
    # row-sharded over four slots, at 4320 rows and with a pad row
    mesh = sharded_mesh()
    x4323 = torch.from_numpy(synthetic_image(PAD_H, MAIN_W, seed=0)).to(device)
    for spec, (exp_full, exp_pad) in REGISTRY_SHARDED.items():
        pipe = Pipeline.parse(spec)
        fn = pipe.sharded(mesh, backend="cuda", plan="off")
        for x, exp in ((x8k, exp_full), (x4323, exp_pad)):
            tag = f"registry sharded [{spec}] {x.shape[0]}x{x.shape[1]} over {N_SHARDS} slots"
            want, nbytes = golden_and_bytes(pipe.ops, x)
            out, counts = launched(lambda: fn(x))
            assert out.device == mesh.devices[0], tag
            check_equal(tag, out, want)
            if counts != exp:
                raise AssertionError(f"{tag}: launches {counts}, expected {exp}")
            ms = padded_device_ms(lambda: fn(x))
            enqueue = host_enqueue_ms(lambda: fn(x))
            print(f"registry: {tag} on {len(set(mesh.devices))} card(s): == golden; device "
                  f"{ms:.4f} ms, host enqueue {enqueue:.4f} ms, launches {counts}, bytes "
                  f"{nbytes} -> bound {bound_ms(nbytes):.4f} ms")
            n_paths += 1
            del want, out
    del x4323
    torch.cuda.empty_cache()
    print(f"phase 4: {n_paths} geometric and global-statistics paths == golden on the card "
          f"(and CPU == card at {CROSS_H}x{CROSS_W}), and pipeline_packed on T1")


# phase 5: the autotune sweeps, as `autotune` arguments (8K frame, defaults)
AUTOTUNE_RUNS = [
    ["--dimension", "block", "--impl", "cuda", "--ops", SPECS["gaussian5_8k"]],
    ["--dimension", "block", "--impl", "swar", "--ops", SPECS["gaussian5_8k"]],
    ["--dimension", "backend", "--ops", "gaussian:5,emboss:3,sharpen"],
    ["--dimension", "plan", "--ops", SPECS["reference"]],
    ["--dimension", "plan", "--ops", SPECS["megakernel_ab"]],
]
AUTO_KNOBS = ("MCIM_CALIB_FILE", "MCIM_NO_CALIB", "MCIM_PREFER_SWAR")


@contextlib.contextmanager
def knobs(**values):
    """MCIM_* variables set (a value) or unset (None) for the block, the
    previous values restored after."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def expected_auto_off(ops, banded: set, shards: int = 0) -> dict:
    """The launches of `auto` under plan 'off' when the stencils of the
    families in `banded` take the banded products: per group, a K1 for the
    pointwise prologue of a banded stencil, else the group's K1 or K2 (K2g
    per shard, K1 per shard, with `shards`)."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import mxu_family

    want = dict.fromkeys(ck.launch_counts(), 0)
    n = max(shards, 1)
    for pw, st in ck.group_ops(ops):
        if st is not None and mxu_family(st) in banded:
            want["K1"] += n if pw else 0
        elif st is not None:
            want["K2g" if shards else "K2"] += n
        elif pw[0].kernel_safe:
            want["K1"] += n
    return want


def phase5_auto(device, x8k):
    """Calibration and `auto` routing on the card (see the module
    docstring, phase 5). Raises on any lane that differs from golden, on
    launches other than the recorded choice's, and if the failpoint does
    not fire."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import main as cli_main
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.plan import pipeline_fingerprint
    from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
    from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mcim_calib_")
    store, empty = os.path.join(tmp, "calib.json"), os.path.join(tmp, "empty.json")
    metrics = os.path.join(tmp, "autotune.jsonl")
    kind = torch.cuda.get_device_name(device)
    with knobs(MCIM_CALIB_FILE=store, MCIM_NO_CALIB=None, MCIM_PREFER_SWAR=None):
        for argv in AUTOTUNE_RUNS:
            rc = cli_main(["autotune", *argv, "--json-metrics", metrics])
            if rc != 0:
                raise AssertionError(f"autotune {' '.join(argv)}: exit {rc}")
        with open(metrics) as f:
            for line in f:
                print(f"autotune: {line.strip()}")
        with open(store) as f:
            data = json.load(f)
        print(f"calibration store [{kind}]: {json.dumps(data['device_kinds'][kind], sort_keys=True)}")
        records = data["device_kinds"][kind]
    banded = {fam for fam, ent in records.get("backend_choice", {}).items()
              if ent["choice"] in ("mxu", "hybrid")}
    mesh = sharded_mesh()
    mp = MAIN_H * MAIN_W / 1e6

    def launched(fn):
        ck.reset_launch_counts()
        out = fn(x8k)
        for d in set(mesh.devices) | {device}:
            torch.cuda.synchronize(d)
        return out, ck.launch_counts()

    for key, spec in SPECS.items():
        pipe = Pipeline.parse(spec)
        want = pipe.jit("torch", device=device, plan="off")(x8k)
        plan = records.get("plan_choice", {}).get(pipeline_fingerprint(pipe.ops), {})
        plan = plan.get("choice", "off")
        states = {
            "empty store": dict(MCIM_CALIB_FILE=empty, MCIM_NO_CALIB=None, MCIM_PREFER_SWAR=None),
            "recorded store": dict(MCIM_CALIB_FILE=store, MCIM_NO_CALIB=None,
                                   MCIM_PREFER_SWAR=None),
            "MCIM_PREFER_SWAR=1": dict(MCIM_CALIB_FILE=store, MCIM_NO_CALIB="1",
                                       MCIM_PREFER_SWAR="1"),
        }
        state_ms = {}
        for state, env in states.items():
            with knobs(**env):
                auto = pipe.jit("auto", device=device, plan="auto")
                shard_auto = pipe.sharded(mesh, backend="auto", plan="auto")
                if state == "empty store":
                    ref = pipe.jit("cuda", device=device, plan="off")
                    shard_ref = pipe.sharded(mesh, backend="cuda", plan="off")
                elif state == "recorded store" and plan != "off":
                    ref = pipe.jit("cuda", device=device, plan=plan)
                    shard_ref = pipe.sharded(mesh, backend="cuda", plan=plan)
                elif state == "recorded store":
                    ref = shard_ref = None
                else:
                    ref = pipe.jit("swar", device=device, plan="off")
                    shard_ref = pipe.sharded(mesh, backend="swar", plan="off")
                tag = f"auto [{spec}] {state}"
                out, counts = launched(auto)
                check_equal(tag, out, want)
                exp = launched(ref)[1] if ref is not None else expected_auto_off(pipe.ops, banded)
                if counts != exp:
                    raise AssertionError(f"{tag}: launches {counts}, expected {exp}")
                out, s_counts = launched(shard_auto)
                check_equal(f"sharded {tag}", out, want)
                s_exp = (launched(shard_ref)[1] if shard_ref is not None
                         else expected_auto_off(pipe.ops, banded, N_SHARDS))
                if s_counts != s_exp:
                    raise AssertionError(f"sharded {tag}: launches {s_counts}, expected {s_exp}")
                ms = padded_device_ms(lambda: auto(x8k))
                s_ms = padded_device_ms(lambda: shard_auto(x8k))
                state_ms[state] = ms
                note = (f" (recorded: plan {plan}, banded {sorted(banded)})"
                        if state == "recorded store" else "")
                line = (f"auto: [{spec}] {state}{note}: == golden; device {ms:.4f} ms "
                        f"({mp / ms * 1e3:.1f} MP/s), launches "
                        f"{ {k: v for k, v in counts.items() if v} }; sharded over {N_SHARDS} "
                        f"slots == golden, device {s_ms:.4f} ms ({mp / s_ms * 1e3:.1f} MP/s), "
                        f"launches { {k: v for k, v in s_counts.items() if v} }")
                if state == "empty store":
                    enq = {name: host_enqueue_ms(lambda f=f: f(x8k))
                           for name, f in (("auto", auto), ("cuda", ref), ("auto2", auto),
                                           ("cuda2", ref))}
                    line += (f"; host enqueue auto {enq['auto']:.4f} / {enq['auto2']:.4f} ms, "
                             f"cuda --plan off {enq['cuda']:.4f} / {enq['cuda2']:.4f} ms")
                print(line)
        print(f"auto: [{spec}] device ms, recorded store / empty store "
              f"{state_ms['recorded store'] / state_ms['empty store']:.3f}, "
              f"MCIM_PREFER_SWAR=1 / recorded store "
              f"{state_ms['MCIM_PREFER_SWAR=1'] / state_ms['recorded store']:.3f}")
        del want
    # an armed halo.exchange failpoint raises at the sharded entry
    failpoints.configure("halo.exchange=always")
    try:
        Pipeline.parse(SPECS["gaussian5_8k"]).sharded(mesh, backend="auto")(x8k)
    except failpoints.FailpointError as e:
        print(f"auto: halo.exchange armed -> {e}")
    else:
        raise AssertionError("the armed halo.exchange failpoint did not raise")
    finally:
        failpoints.clear()
    calibration._cache["key"] = None
    torch.cuda.empty_cache()
    print(f"phase 5: autotune records, auto routing in three states over {len(SPECS)} "
          f"workloads unsharded and sharded, the failpoint; {time.perf_counter() - t0:.1f} s")
    return store


# the soak phase: trials of tools/soak.py on the card (seed 0), mesh slots
# of its sharded lanes on the one card, and the launch counters each trial
# run must have moved
SOAK_TRIALS = 1000
SOAK_SLOTS = 4
SOAK_KERNELS = ("K1", "K2", "K2g", "K3", "K4", "K4g", "K5", "K6", "K7", "K8", "K6g", "K7g",
                "K8g", "T1", "T1-pw")


def phase6_soak(device) -> dict:
    """The randomized differential soak on the card (module docstring,
    phase 6): SOAK_TRIALS trials from seed 0 over every lane, the sharded
    ones over SOAK_SLOTS slots of the one card. Raises on any REPRO line, on
    a lane no trial reached and on a kernel of SOAK_KERNELS the soak never
    launched (K5 counts either form, K6 and K6g either mode). Returns the
    report."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.tools import soak

    with knobs(MCIM_NO_CALIB="1", MCIM_PREFER_SWAR=None, MCIM_PREFER_MXU=None, MCIM_PLAN=None):
        ck.reset_launch_counts()
        rep = soak.soak(iters=SOAK_TRIALS, seed=0, device=device, slots=SOAK_SLOTS)
        torch.cuda.synchronize(device)
        counts = ck.launch_counts()
    by_kind = {k: v for k, v in counts.items() if v}
    print(f"soak: {rep['trials']} trials (seed 0, {SOAK_SLOTS} slots on one card), "
          f"{len(rep['repros'])} REPRO lines, {rep['shard_skips']} without sharded coverage, "
          f"{rep['seconds']:.1f} s")
    print(f"soak lanes: {json.dumps(rep['lanes'])}")
    print(f"soak launches by kernel: {json.dumps(by_kind)}")
    print(f"soak stack lanes' launches by kernel: {json.dumps(rep['lane_launches'])}")
    if rep["repros"]:
        raise AssertionError(f"soak: {len(rep['repros'])} REPRO lines, first "
                             f"{json.dumps(rep['repros'][0])}")
    missed = [lane for lane, n in rep["lanes"].items() if not n]
    if missed:
        raise AssertionError(f"soak: lanes no trial reached: {missed}")
    grouped = {
        "K5": counts["K5-bf16"] + counts["K5-int8"],
        "K6": counts["K6-narrow"] + counts["K6-wide"],
        "K6g": counts["K6g-narrow"] + counts["K6g-wide"],
    }
    idle = [k for k in SOAK_KERNELS if not grouped.get(k, counts.get(k, 0))]
    if idle:
        raise AssertionError(f"soak: kernels never launched: {idle}")
    stacked = rep["lane_launches"].get("batched-cuda", {})
    if not stacked.get("K1") or not stacked.get("K2"):
        raise AssertionError(f"soak: the batched-cuda lane launched no K1 or no K2: {stacked}")
    print(f"phase 6: soak, {rep['trials']} trials, every lane reached, "
          f"{rep['seconds']:.1f} s")
    return rep


def _trace_spans(path) -> dict:
    with open(path) as f:
        doc = json.load(f)
    return {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}


def phase7_trace(device, x8k) -> None:
    """`run --trace-out` on the 8K reference (module docstring, phase 7):
    the five spans and their parent links, run.steady and
    run.compile_and_run at least the path's device time (the sync is inside
    them), the steady device time traced and untraced; then the sharded
    dispatch span over the 4-slot mesh, and the tracer's cost on that
    host-bound path."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import main as cli_main
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import save_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mcim_trace_")
    src = os.path.join(tmp, "in8k.png")
    save_image(src, x8k.cpu().numpy())
    runs = {}
    for armed in (True, False, True, False):
        metrics = os.path.join(tmp, f"run_{len(runs)}.jsonl")
        argv = ["run", "--input", src, "--output", os.path.join(tmp, "out8k.png"),
                "--ops", SPECS["reference"], "--show-timing", "--json-metrics", metrics]
        trace = os.path.join(tmp, f"trace_{len(runs)}.json")
        if armed:
            argv += ["--trace-out", trace, "--trace-sample", "1.0"]
        if cli_main(argv) != 0:
            raise AssertionError(f"run {' '.join(argv)} failed")
        with open(metrics) as f:
            rec = json.loads(f.readline())
        runs[len(runs)] = (armed, rec["steady_ms"], trace if armed else None)
    for _i, (armed, steady_ms, trace) in runs.items():
        if not armed:
            continue
        spans = _trace_spans(trace)
        if set(spans) != {"run", "run.load", "run.compile_and_run", "run.steady", "run.save"}:
            raise AssertionError(f"trace: spans {sorted(spans)}")
        root = spans["run"]["args"]["span_id"]
        for name in ("run.load", "run.compile_and_run", "run.steady", "run.save"):
            if spans[name]["args"].get("parent_id") != root:
                raise AssertionError(f"trace: {name} is not a child of run")
        args = spans["run.steady"]["args"]
        durs = {n: spans[n]["dur"] / 1e3 for n in spans}
        # a synchronised call lasts at least its device time; an enqueue-only
        # span would end before the kernels ran
        if not (args["call_ms"] >= 0.9 * args["steady_ms"]
                and durs["run.steady"] >= args["steady_ms"]
                and durs["run.compile_and_run"] >= args["steady_ms"]):
            raise AssertionError(f"trace: spans shorter than the device time: {durs}, {args}")
        print(f"trace: [{SPECS['reference']}] 8K spans (ms) "
              f"{ {k: round(v, 4) for k, v in sorted(durs.items())} }; run.steady one "
              f"synchronised call {args['call_ms']:.4f} ms host, device {args['steady_ms']:.4f} ms")
    traced = [ms for armed, ms, _ in runs.values() if armed]
    plain = [ms for armed, ms, _ in runs.values() if not armed]
    print(f"trace: `run` steady device ms, tracer armed at sample 1.0 {traced} / disarmed "
          f"{plain} (turns traced, untraced, traced, untraced)")

    # the sharded dispatch: `run --shards 4` takes four cards, so on fewer
    # the same Pipeline.sharded call runs over the 4-slot mesh of one card,
    # under a root and a run.compile_and_run span as cmd_run opens them
    pipe = Pipeline.parse(SPECS["reference"])
    mesh = sharded_mesh()
    fn = pipe.sharded(mesh, backend="cuda", plan="off")
    want = pipe.jit("torch", device=device, plan="off")(x8k)
    trace = os.path.join(tmp, "trace_sharded.json")
    if torch.cuda.device_count() >= N_SHARDS:
        argv = ["run", "--input", src, "--output", os.path.join(tmp, "out8k4.png"),
                "--ops", SPECS["reference"], "--impl", "cuda", "--plan", "off",
                "--shards", str(N_SHARDS), "--trace-out", trace]
        if cli_main(argv) != 0:
            raise AssertionError("run --shards failed")
        how = f"run --shards {N_SHARDS}"
    else:
        obs_trace.configure(sample=1.0)
        try:
            with obs_trace.start_trace("run", ops=SPECS["reference"], impl="cuda",
                                       shards=str(N_SHARDS)) as root:
                with obs_trace.span("run.compile_and_run", parent=root.context()):
                    out = fn(x8k)
                    for d in set(mesh.devices):
                        torch.cuda.synchronize(d)
            obs_trace.export(trace)
        finally:
            obs_trace.disable()
        check_equal("traced sharded reference", out, want)
        how = f"Pipeline.sharded over {N_SHARDS} slots of one card"
    spans = _trace_spans(trace)
    d = spans.get("sharded.dispatch")
    if d is None or d["args"].get("parent_id") != spans["run.compile_and_run"]["args"]["span_id"]:
        raise AssertionError(f"trace: no sharded.dispatch under run.compile_and_run: "
                             f"{sorted(spans)}")
    print(f"trace: {how}: sharded.dispatch {d['dur'] / 1e3:.4f} ms host enqueue, args "
          f"mesh={d['args']['mesh']} halo_mode={d['args']['halo_mode']}")

    # the tracer's cost on the host-bound sharded path: one span a call
    def traced_call():
        with obs_trace.start_trace("bench"):
            return fn(x8k)

    cost = {}
    for turn in ("disarmed", "armed", "armed2", "disarmed2"):
        if turn.startswith("armed"):
            obs_trace.configure(sample=1.0)
        try:
            cost[turn] = (padded_device_ms(traced_call), host_enqueue_ms(traced_call))
        finally:
            obs_trace.disable()
    print("trace: sharded reference over 4 slots, (device ms, host enqueue ms) "
          + ", ".join(f"{k} ({v[0]:.4f}, {v[1]:.4f})" for k, v in cost.items()))
    del want
    print(f"phase 7: trace spans of run and of the sharded dispatch; "
          f"{time.perf_counter() - t0:.1f} s")


def phase8_recorder(device) -> None:
    """The flight recorder and the io.decode failpoint (module docstring,
    phase 8): a run with io.decode armed fails, and a manual dump holds the
    failpoint entry and the run's WARNING line."""
    from mpi_cuda_imagemanipulation_tpu_torch.cli import main as cli_main
    from mpi_cuda_imagemanipulation_tpu_torch.obs import recorder
    from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mcim_recorder_")
    with knobs(MCIM_RECORDER_DIR=tmp):
        recorder.configure(cap=None)
        try:
            rc = cli_main(["run", "--input", os.path.join(tmp, "never-read.png"), "--output",
                           os.path.join(tmp, "out.png"), "--failpoints", "io.decode=always"])
        finally:
            failpoints.clear()
        if rc != 2:
            raise AssertionError(f"run with io.decode armed: exit {rc}, expected 2")
        path = recorder.dump("manual", force=True)
    if path is None or not path.startswith(tmp):
        raise AssertionError(f"recorder dump {path!r} not in {tmp}")
    with open(path) as f:
        payload = json.load(f)
    kinds = {e["kind"] for e in payload["entries"]}
    fp = [e for e in payload["entries"] if e["kind"] == "failpoint"]
    logs = [e for e in payload["entries"] if e["kind"] == "log" and e["level"] == "WARNING"]
    if not fp or fp[-1]["site"] != "io.decode" or not logs or "io.decode" not in logs[-1]["msg"]:
        raise AssertionError(f"recorder dump lacks the failpoint or the WARNING line: "
                             f"{payload['summary']}")
    print(f"recorder: dump {os.path.basename(path)}: {len(payload['entries'])} entries, kinds "
          f"{sorted(kinds)}, failpoint {fp[-1]}, warning {logs[-1]['msg']!r}")
    print(f"phase 8: flight recorder and failpoint; {time.perf_counter() - t0:.1f} s")


def phase9_online(device, x8k, store: str) -> None:
    """The online store's newest-wins rule on the card (module docstring,
    phase 9): in phase 5's store, an offline plan_choice and an online
    promoted record that disagree for the 8K reference under the card's
    kind; `run --impl auto --plan auto` launches what the newer one names,
    and mcim_tune_stale_overrides_total counts one override a resolution."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.cli import image_runner
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.plan import pipeline_fingerprint
    from mpi_cuda_imagemanipulation_tpu_torch.tune.metrics import tune_metrics
    from mpi_cuda_imagemanipulation_tpu_torch.tune.store import online_store
    from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration

    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(device)
    pipe = Pipeline.parse(SPECS["reference"])
    fp = pipeline_fingerprint(pipe.ops)
    want = pipe.jit("torch", device=device, plan="off")(x8k)
    # gray output: the gray -> RGB step resolves a plan of its own

    def launched(runner):
        ck.reset_launch_counts()
        out = runner(x8k)
        torch.cuda.synchronize(device)
        return out, ck.launch_counts()

    now = time.time()
    # the same two records, each the newer in turn: the launches must follow
    cases = (("fused-pallas", now - 100.0, "fused-pallas-mxu", now),
             ("fused-pallas", now, "fused-pallas-mxu", now - 100.0))
    for off_choice, off_t, on_choice, on_t in cases:
        with open(store) as f:
            data = json.load(f)
        data["device_kinds"][kind].setdefault("plan_choice", {})[fp] = {
            "choice": off_choice, "width": MAIN_W, "recorded_at": off_t}
        data.setdefault("online", {}).setdefault(kind, {})["promoted"] = {
            fp: {"choice": on_choice, "width": MAIN_W, "at": on_t}}
        with open(store, "w") as f:
            json.dump(data, f)
        calibration._cache["key"] = None
        online_store.reset()
        newer = on_choice if on_t >= off_t else off_choice
        with knobs(MCIM_CALIB_FILE=store, MCIM_NO_CALIB=None, MCIM_PREFER_SWAR=None,
                   MCIM_PREFER_MXU=None, MCIM_PLAN=None):
            before = tune_metrics.stale_overrides.value()
            out, counts = launched(image_runner(pipe, impl="auto", device=device,
                                                gray_output=True))
            overrides = tune_metrics.stale_overrides.value() - before
            exp = launched(image_runner(pipe, impl="cuda", device=device, plan=newer,
                                        gray_output=True))[1]
        check_equal(f"online store [{newer}]", out, want)
        if counts != exp or overrides != 1:
            raise AssertionError(f"online store: offline {off_choice} at {off_t:.1f}, online "
                                 f"{on_choice} at {on_t:.1f}: launches {counts}, expected "
                                 f"{newer}'s {exp}; {overrides} overrides counted")
        print(f"online store: offline {off_choice} / online {on_choice}, the "
              f"{'online' if newer == on_choice else 'offline'} record newer: auto runs "
              f"{newer} == golden, launches { {k: v for k, v in counts.items() if v} }, "
              f"mcim_tune_stale_overrides_total +{overrides:g}")
    online_store.reset()
    calibration._cache["key"] = None
    del want
    print(f"phase 9: newest-wins plan records; {time.perf_counter() - t0:.1f} s")



# --------------------------------------------------------------------------
# Phases 10-13: the batched and data-parallel forms, the 2-D tile-sharded
# runner, the device-hang guard
# --------------------------------------------------------------------------

BATCH_N = 4  # 8K frames of one stack, seeds 0..3
# the batched main paths' routes: (backend, plan)
BATCH_ROUTES = (("cuda", "off"), ("cuda", "fused-pallas"), ("cuda", "fused-pallas-mxu"),
                ("mxu", "off"), ("swar", "off"), ("auto", "auto"))
# the SWAR slice's gray workloads, batched under swar beside SPECS: K6 wide
# and K8 take a stack only there
BATCH_SWAR_EXTRA = {k: SWAR_SPECS[k][0] for k in ("gaussian7_gray", "sobel_gray")}
# small shapes of the batched kernel checks: sub-halo heights and widths,
# odd widths, one past a 128-column tile
BATCH_SHAPES = [(3, 5), (2, 9), (17, 33), (37, 53), (64, 133)]
BATCH_STENCILS = ["emboss:3", "gaussian:5", "erode:3", "median:5", "sobel", "gaussian:7",
                  "contrast:3.5,emboss:3", "grayscale,contrast:3.5,gaussian:5"]
BATCH_STAGES = ["grayscale,contrast:3.5,emboss:3", "gaussian:5,sharpen",
                "grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6", "gray2rgb,box:3",
                "gaussian:5,gaussian:5,emboss:3"]
# the SWAR kernels' plane shapes (W % 4 == 0): odd heights, 76 and 132
# columns, one 8-column plane
BATCH_PLANES = [(5, 8), (13, 76), (37, 132), (64, 260)]
BATCH_SWAR = ["gaussian:5", "gaussian:7", "box:5", "emboss:3", "sharpen", "sobel", "scharr",
              "contrast:3.5,emboss:3,invert", "unsharp"]
GRID_2D = (2, 2)


def stack_of(n, shape, channels, seed, device):
    """A contiguous (n, H, W[, C]) stack of seeded images on `device`."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image

    return torch.stack([torch.from_numpy(synthetic_image(*shape, channels=channels,
                                                         seed=seed + t)) for t in range(n)]
                       ).to(device)


def phase10_batched_kernels(device) -> int:
    """The batch axis of the redesigned kernels, each held against its plain
    version image by image, through the same launch entry as one image:
    K2 (every family and edge mode the registry gives it, with prologues
    that change the channel count), K1 as a flat run, K4 on the VPU arm and
    with K5 in each form, K6 narrow and wide, K7 and K8; N = 1, 2 and 3 on
    small shapes (sub-halo, odd widths); a non-contiguous stack is refused
    by each wrapper and made contiguous by Pipeline.batched."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops

    def per_image_plain(fn, stack):
        return torch.stack([fn(x) for x in stack])

    n = {"K1": 0, "K2": 0, "K4": 0, "K5": 0, "SWAR": 0}
    ck.reset_launch_counts()
    for spec in BATCH_STENCILS:
        pw, st = split_group(spec)
        first = next((op.in_channels for op in pw if op.in_channels), 0)
        for channels in ((first,) if first else (1, 3)):
            for shape in BATCH_SHAPES:
                if st.edge_mode == "reflect101" and min(shape) <= st.halo:
                    continue  # the group runner refuses it, one image or many
                for k in (1, 2, 3):
                    x = stack_of(k, shape, channels, 11 * k, device)
                    got = ck.stream_stencil(pw, st, x, batched=True)
                    check_equal(f"K2 batched {spec} {shape}x{channels} N={k}", got,
                                per_image_plain(lambda im: ck.stream_stencil_plain(pw, st, im),
                                                x))
                    n["K2"] += 1
    for spec in ("grayscale,contrast:3.5", "gray2rgb,invert", "sepia,quantize:6"):
        pw, _ = split_group(spec)
        channels = 1 if spec.startswith("gray2rgb") else 3
        for shape in BATCH_SHAPES:
            for k in (1, 2, 3):
                x = stack_of(k, shape, channels, 5 * k, device)
                check_equal(f"K1 batched {spec} {shape} N={k}",
                            ck.pointwise_group(pw, x, batched=True),
                            per_image_plain(lambda im: ck.pointwise_group_plain(pw, im), x))
                n["K1"] += 1
    for spec in BATCH_STAGES:
        ops = make_pipeline_ops(spec)
        channels = 1 if spec.startswith("gray2rgb") else 3
        forms = [("vpu",) * len(ops)]
        forms += [ck.stage_arms(ops, s) for s in ("on", "f32")]
        for arms in dict.fromkeys(forms):
            for shape in BATCH_SHAPES:
                if ck.fused_stage_reject(ops, *shape, channels) is not None:
                    continue
                for k in (1, 2, 3):
                    x = stack_of(k, shape, channels, 7 * k, device)
                    check_equal(f"K4 batched {spec} arms={arms} {shape} N={k}",
                                ck.fused_stage(ops, x, arms=arms, batched=True),
                                per_image_plain(
                                    lambda im: ck.fused_stage_plain(ops, im, arms=arms), x))
                    n["K5" if any(a != "vpu" for a in arms) else "K4"] += 1
    kinds = set()
    for spec in BATCH_SWAR:
        ops = make_pipeline_ops(spec)
        i = next(j for j, op in enumerate(ops) if sk.swar_any_eligible(op))
        op, pre, post = ops[i], ops[:i], ops[i + 1:]
        for shape in BATCH_PLANES:
            if not sk.swar_any_eligible(op, shape):
                continue
            for k in (1, 2, 3):
                x = stack_of(k, shape, 1, 3 * k, device)
                got = sk.swar_stencil(op, x, pre_ops=pre, post_ops=post, batched=True)
                group = sk.swar_group(op, pre, post)
                want = per_image_plain(lambda im: sk.swar_stencil_plain(
                    op, im, pre_chain=group.pre_chain, post_chain=group.post_chain), x)
                check_equal(f"{group.kind} batched {spec} {shape} N={k}", got, want)
                kinds.add(group.kind)
                n["SWAR"] += 1
    if kinds != {"K6-narrow", "K6-wide", "K7", "K8"}:
        raise AssertionError(f"batched SWAR checks reached only {sorted(kinds)}")
    batched_non_contiguous(device)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    print(f"phase 10: batched kernels equal to their plain versions image by image "
          f"(max_abs_err 0): {n}, SWAR kinds {sorted(kinds)}, launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return sum(n.values())


def batched_non_contiguous(device) -> None:
    """A non-contiguous stack: K2, K4 and K6 refuse it, and Pipeline.batched
    hands the kernels a contiguous copy, equal to golden per image."""
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk

    base = stack_of(6, (40, 64), 3, 90, device)
    view = base[::2, :, 8:56]
    pw, st = split_group("gaussian:5")
    for name, fn in (("K2", lambda: ck.stream_stencil(pw, st, view, batched=True)),
                     ("K4", lambda: ck.fused_stage([st], view, batched=True)),
                     ("K6", lambda: sk.swar_stencil(st, view[..., 0], batched=True))):
        try:
            fn()
        except ValueError as e:
            if "contiguous" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} took a non-contiguous stack")
    for backend, plan in (("cuda", "off"), ("cuda", "fused-pallas"), ("swar", "off")):
        spec = "gaussian:5,emboss:3"
        got = Pipeline.parse(spec).batched(backend, device=device, plan=plan)(view)
        for t in range(view.shape[0]):
            check_equal(f"batched {backend}/{plan} non-contiguous image {t}", got[t],
                        Pipeline.parse(spec)(view[t].contiguous()))


def batched_run(spec, backend, plan, stack, device) -> tuple:
    """The batched run of `spec` over `stack`: its output and launches, the
    launches of one image's run through Pipeline.jit, and the device ms of
    the stack's call and of one call per image."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    pipe = Pipeline.parse(spec)
    fb = pipe.batched(backend, device=device, plan=plan)
    f1 = pipe.jit(backend, device=device, plan=plan)
    ck.reset_launch_counts()
    f1(stack[0])
    torch.cuda.synchronize()
    single = ck.launch_counts()
    ck.reset_launch_counts()
    out = fb(stack)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    t_stack = device_time_ms(lambda: fb(stack), reps=5, inner=2)
    t_single = device_time_ms(lambda: [f1(x) for x in stack], reps=5, inner=2)
    return out, counts, single, t_stack, t_single


def phase11_batched_paths(device, rows, store) -> dict:
    """The batched main paths at 8K: a stack of BATCH_N RGB frames (seeds
    0..3) through Pipeline.batched on each route of BATCH_ROUTES for the
    three workloads (and the SWAR gray workloads under swar), `auto` with
    the calibration store `store` that phase 5 recorded (with no store it
    would run exactly cuda --plan off), the rest with none; each image
    byte-equal to Pipeline.parse(spec)(image), each route's launches equal
    to one image's (one launch per group per stack, not N); device ms per
    stack and per image beside N single calls. Then the batched kernels'
    rows of the `kernels` line, at the stack's shapes."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops import swar_kernels as sk
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    stack = stack_of(BATCH_N, (MAIN_H, MAIN_W), 3, 0, device)
    launches = {}
    with knobs(MCIM_NO_CALIB="1", MCIM_PREFER_SWAR=None, MCIM_PREFER_MXU=None, MCIM_PLAN=None,
               MCIM_CALIB_FILE=store):
        work = [(k, s, r) for k, s in SPECS.items() for r in BATCH_ROUTES]
        work += [(k, s, ("swar", "off")) for k, s in BATCH_SWAR_EXTRA.items()]
        goldens = {}
        for key, spec, (backend, plan) in work:
            if key not in goldens:
                gold = Pipeline.parse(spec)
                goldens[key] = [gold(stack[t]) for t in range(BATCH_N)]
            with knobs(MCIM_NO_CALIB=None if backend == "auto" else "1"):
                out, counts, single, t_stack, t_single = batched_run(spec, backend, plan,
                                                                      stack, device)
            for t in range(BATCH_N):
                check_equal(f"batched {key} {backend}/{plan} image {t}", out[t],
                            goldens[key][t])
            # (the whole-op banded products launch nothing on gaussian:5)
            if counts != single or (backend != "mxu" and not any(counts.values())):
                raise AssertionError(f"batched {key} {backend}/{plan}: launches {counts}, one "
                                     f"image's {single}")
            launches[key, backend, plan] = {k: v for k, v in counts.items() if v}
            print(f"phase 11: batched {key} [{spec}] {backend}/{plan} N={BATCH_N} x "
                  f"{MAIN_H}x{MAIN_W} RGB: == golden per image, launches "
                  f"{launches[key, backend, plan]} (one image's too); device {t_stack:.4f} ms "
                  f"per stack, {t_stack / BATCH_N:.4f} ms per image; {BATCH_N} single calls "
                  f"{t_single:.4f} ms ({t_single / BATCH_N:.4f} ms per image, "
                  f"ratio {t_stack / t_single:.3f})")
    del goldens

    n_pix = BATCH_N * MAIN_H * MAIN_W
    k2 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/stream_stencil.cu"
    k4 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/fused_stage.cu"

    def record(name, source, replaces, launch_count, fn, plain, c_in, c_out, ops,
               library=None, ops_ms=None):
        """One batched kernel's row: the kernel on the stack beside its plain
        version image by image; the bound counts every image's bytes and
        operations."""
        got, want = fn(), plain()
        err = int((got.int() - want.int()).abs().max().item())
        if err:
            raise AssertionError(f"{name}: kernel != plain, max abs err {err}")
        ms = device_time_ms(fn, reps=7)
        plain_ms = device_time_ms(plain, warmup=1, reps=2, inner=1)
        library_ms = device_time_ms(library, reps=7) if library is not None else None
        bound_ms, bound_by = bound((c_in + c_out) * n_pix, op_count(ops, n_pix, c_in), ops_ms)
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launch_count, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        })
        print(f"kernel {name}: {ms:.4f} ms ({ms / BATCH_N:.4f} per image), bound "
              f"{bound_ms:.4f} ms by {bound_by} ({bound_ms / ms:.1%}), plain {plain_ms:.4f} ms, "
              f"library {library_ms}, launches {launch_count}")

    def plain_each(fn):
        return lambda: torch.stack([fn(x) for x in stack])

    def conv_batched(op, x):
        """`conv_library` over a stack of RGB images or gray planes: one
        depthwise float32 F.conv2d of the padded stack."""
        import torch.nn.functional as F

        h, k = op.halo, 2 * op.halo + 1
        c = x.shape[3] if x.ndim == 4 else 1
        planes = (x.permute(0, 3, 1, 2) if c > 1 else x[:, None]).float()
        xf = F.pad(planes, (h, h, h, h), mode="reflect")
        w = torch.as_tensor(op.kernels[0] * op.scale, dtype=torch.float32, device=x.device)
        w = w.expand(c, 1, k, k).contiguous()
        return lambda: F.conv2d(xf, w, groups=c)

    pw5, st5 = split_group(SPECS["gaussian5_8k"])
    conv5 = conv_batched(st5, stack)
    record(f"K2 stream_stencil [gaussian5] batched N={BATCH_N}", k2,
           "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:377",
           launches["gaussian5_8k", "cuda", "off"]["K2"],
           lambda: ck.stream_stencil(pw5, st5, stack, batched=True),
           plain_each(lambda x: ck.stream_stencil_plain(pw5, st5, x)), 3, 3, pw5 + [st5],
           library=conv5)
    pw, st = split_group(SPECS["reference"])
    record(f"K2 stream_stencil [grayscale,contrast3.5,emboss3] batched N={BATCH_N}", k2,
           "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:377",
           launches["reference", "cuda", "off"]["K2"],
           lambda: ck.stream_stencil(pw, st, stack, batched=True),
           plain_each(lambda x: ck.stream_stencil_plain(pw, st, x)), 3, 1, pw + [st])
    record(f"K4 fused_stage [gaussian5] batched N={BATCH_N}", k4,
           "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:993",
           launches["gaussian5_8k", "cuda", "fused-pallas"]["K4"],
           lambda: ck.fused_stage([st5], stack, batched=True),
           plain_each(lambda x: ck.fused_stage_plain([st5], x)), 3, 3, [st5], library=conv5)
    del conv5
    ops = make_pipeline_ops(SPECS["reference"])
    record(f"K4 fused_stage [grayscale,contrast3.5,emboss3] batched N={BATCH_N}", k4,
           "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:993",
           launches["reference", "cuda", "fused-pallas"]["K4"],
           lambda: ck.fused_stage(ops, stack, batched=True),
           plain_each(lambda x: ck.fused_stage_plain(ops, x)), 3, 1, ops)
    for key in ("reference", "megakernel_ab"):
        ops = make_pipeline_ops(SPECS[key])
        arms = ck.stage_arms(ops, "on")
        tc = sorted({K5_KEYS[a] for a in arms if a != "vpu"})
        got = launches[key, "cuda", "fused-pallas-mxu"]
        record(f"K4+{'+'.join(tc)} fused_stage [{','.join(op.name for op in ops)}] batched "
               f"N={BATCH_N}", K5_SOURCE, K5_REPLACES, got.get(tc[0], 0),
               lambda ops=ops, arms=arms: ck.fused_stage(ops, stack, arms=arms, batched=True),
               plain_each(lambda x, ops=ops, arms=arms: ck.fused_stage_plain(ops, x, arms=arms)),
               3, 1, ops, ops_ms=k5_ops_ms(ops, arms, n_pix, 3))
    # K1 as one flat run: megakernel_ab's quantize:6 over the stack's gray
    # planes (the batched path's one K1 group)
    (pwm, stm), (pws, sts), (pwq, _) = ck.group_ops(make_pipeline_ops(SPECS["megakernel_ab"]))
    sharp = ck.stream_stencil(pws, sts, ck.stream_stencil(pwm, stm, stack, batched=True),
                              batched=True)
    record(f"K1 pointwise_group [quantize6] batched N={BATCH_N} gray",
           "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/pointwise.cu",
           "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py:540",
           launches["megakernel_ab", "cuda", "off"]["K1"],
           lambda: ck.pointwise_group(pwq, sharp, batched=True),
           lambda: torch.stack([ck.pointwise_group_plain(pwq, x) for x in sharp]), 1, 1, pwq,
           library=lambda: torch.bitwise_and(sharp, QUANTIZE6_MASK))
    del sharp
    # K6-K8 on the swar paths' groups over the stack's gray planes
    gray = ck.pointwise_group(split_group("grayscale")[0], stack, batched=True)
    # (a lone stencil beside its convolution; a chain or a magnitude has no
    # single PyTorch call)
    for key, spec, kind in (("megakernel_ab", "contrast:3.5,gaussian:5", "K6-narrow"),
                            ("gaussian7_gray", "gaussian:7", "K6-wide"),
                            ("reference", "contrast:3.5,emboss:3", "K7"),
                            ("sobel_gray", "sobel", "K8")):
        ops = make_pipeline_ops(spec)
        op, pre = ops[-1], ops[:-1]
        group = sk.swar_group(op, pre, ())
        assert group.kind == kind, (spec, group.kind)
        lone = not pre and op.combine != "magnitude"
        record(f"{kind} swar_stencil [{spec}] batched N={BATCH_N} gray", SWAR_SOURCE,
               SWAR_REPLACES[kind[:2]], launches[key, "swar", "off"].get(kind, 0),
               lambda op=op, pre=pre: sk.swar_stencil(op, gray, pre_ops=pre, batched=True),
               lambda op=op, g=group: torch.stack([sk.swar_stencil_plain(
                   op, x, pre_chain=g.pre_chain) for x in gray]), 1, 1, ops,
               library=conv_batched(op, gray) if lone else None)
    del gray, stack
    torch.cuda.empty_cache()
    return launches


def phase12_data_parallel(device) -> None:
    """Pipeline.data_parallel: 5 frames of 8K RGB over the 4-slot mesh of
    the one card (padded to 8, two a slot), byte-equal per image, beside the
    same stack batched on one device; host ms (synchronised)."""
    import statistics

    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    stack = stack_of(5, (MAIN_H, MAIN_W), 3, 20, device)
    pipe = Pipeline.parse(SPECS["reference"])
    dp = pipe.data_parallel(sharded_mesh())
    out = dp(stack)
    for t in range(5):
        check_equal(f"data_parallel image {t}", out[t], pipe(stack[t]))
    fb = pipe.batched(device=device)

    def host_ms(fn):
        samples = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(samples)

    t_dp, t_b = host_ms(lambda: dp(stack)), host_ms(lambda: fb(stack))
    print(f"phase 12: data_parallel [{SPECS['reference']}] N=5 x {MAIN_H}x{MAIN_W} over "
          f"{N_SHARDS} slots of one card == golden per image; host {t_dp:.4f} ms "
          f"(synchronised), batched on one device {t_b:.4f} ms")


def phase13_2d(device, x8k) -> None:
    """The 2-D tile-sharded runner (parallel/api2d) over a 2 x 2 mesh of the
    one card: the 8K reference and gaussian:5 under torch and auto, serial
    and overlap, plan fused, byte-equal to golden, with both exchange axes
    counted; host ms (synchronised) beside the 1-D 4-slot runner on the same
    golden ops."""
    import statistics

    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import halo
    from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import make_mesh_2d

    mesh = make_mesh_2d(*GRID_2D, devices=[device] * (GRID_2D[0] * GRID_2D[1]))

    def host_ms(fn):
        samples = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(samples)

    for key in ("reference", "gaussian5_8k"):
        pipe = Pipeline.parse(SPECS[key])
        want = pipe(x8k)
        t_1d = host_ms(lambda: pipe.sharded(sharded_mesh(), backend="torch", plan="fused")(x8k))
        for backend in ("torch", "auto"):
            for halo_mode in HALO_MODES:
                fn = pipe.sharded(mesh, backend=backend, halo_mode=halo_mode, plan="fused")
                halo.exchanges.reset()
                check_equal(f"2-D {key} {backend}/{halo_mode}", fn(x8k), want)
                rounds = dict(halo.exchanges.axis_rounds)
                if not rounds["rows"] or not rounds["cols"]:
                    raise AssertionError(f"2-D {key}: exchange rounds {rounds}")
                t = host_ms(lambda: fn(x8k))
                print(f"phase 13: 2-D {GRID_2D[0]}x{GRID_2D[1]} {key} [{SPECS[key]}] "
                      f"{backend}/{halo_mode} plan=fused at {MAIN_H}x{MAIN_W}: == golden, "
                      f"rounds {rounds}, host {t:.4f} ms (synchronised); the 1-D {N_SHARDS}-slot "
                      f"runner on the same torch ops {t_1d:.4f} ms")


def phase14_guard(device, x8k) -> None:
    """`run --impl cuda` on the 8K reference (a PNG in a temporary
    directory) in a subprocess, unguarded and with `--device-timeout 300`:
    both exit 0 and their outputs are byte-equal; with a budget of 0.01 s,
    exit code 4 and no output. Prints both wall times (the guard's
    overhead: the watchdog child's start-up and the kernels' load) beside
    the child's two windows."""
    import numpy as np

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image, save_image

    root = os.path.dirname(os.path.abspath(__file__))

    def run(src, out, *extra):
        cmd = [sys.executable, "-m", "mpi_cuda_imagemanipulation_tpu_torch", "run",
               "--input", src, "--output", out, "--impl", "cuda", *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600,
                              stdin=subprocess.DEVNULL)
        return proc, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="mcim_guard_") as td:
        src = os.path.join(td, "in.png")
        plain, guarded, late = (os.path.join(td, f"{n}.png") for n in ("plain", "guarded", "late"))
        save_image(src, x8k.cpu().numpy())
        p_plain, wall_plain = run(src, plain)
        p_guard, wall_guard = run(src, guarded, "--device-timeout", "300", "--show-timing",
                                  "--json-metrics", "-")
        for name, proc in (("unguarded", p_plain), ("guarded", p_guard)):
            if proc.returncode != 0:
                raise AssertionError(f"{name} run: rc {proc.returncode}: {proc.stderr[-2000:]}")
        rec = json.loads(p_guard.stdout.strip().splitlines()[-1])
        if rec["guarded"] is not True or not np.array_equal(load_image(guarded),
                                                            load_image(plain)):
            raise AssertionError("guarded run: output differs from the unguarded run's")
        p_late, wall_late = run(src, late, "--device-timeout", "0.01")
        if p_late.returncode != 4 or os.path.exists(late):
            raise AssertionError(f"guarded run over budget: rc {p_late.returncode}, "
                                 f"{p_late.stderr[-1000:]}")
    print(f"phase 14: run --impl cuda on the 8K reference PNG: unguarded wall {wall_plain:.3f} s, "
          f"--device-timeout 300 wall {wall_guard:.3f} s (byte-equal output; the child's first "
          f"call {rec['compile_and_run_s']:.4f} s, steady {rec['steady_s'] * 1e3:.4f} ms on the "
          f"host clock, synchronised, the numpy input's copy to the card included); a 0.01 s "
          f"budget exits 4 after {wall_late:.3f} s")


# --------------------------------------------------------------------------
# Phases 15-17: T1's batch axis, the engine on the card, CLI batch at 8K
# --------------------------------------------------------------------------

# T1's batched checks: word-aligned shapes just above each halo, word
# widths that are odd or 8 (the smallest T1 takes), one past a strip
T1_BATCH_SHAPES = [(4, 32), (5, 44), (8, 300), (37, 132), (66, 260)]
T1_BATCH_N = (1, 2, 3)
# T1-pw's chains: 1 -> 1, 3 -> 1, 3 -> 3, 1 -> 3
T1_BATCH_CHAINS = ["contrast:3.5", "grayscale,contrast:3.5", "sepia,invert", "gray2rgb,invert"]
T1_FRAMES = 4  # 8K gray planes of the batched pipeline_packed path
ENGINE_DISPATCHES = 64  # 8K reference frames through Engine(inflight=3)
ENGINE_IDLE_DISPATCHES = 16  # each of the inflight 1 and 2 runs
# CLI batch at 8K: the frames of the input directory (seeds), PPM and PNG
BATCH_PPM_SEEDS = range(6)
BATCH_PNG_SEEDS = (6, 7)
# (label, batch arguments) of the PPM runs, each at --inflight 1 and 2
BATCH_CLI_RUNS = [
    ("cuda off", ["--impl", "cuda", "--plan", "off"]),
    ("auto", ["--impl", "auto"]),
    ("swar", ["--impl", "swar"]),
    ("fused-pallas-mxu", ["--impl", "cuda", "--plan", "fused-pallas-mxu"]),
    ("stack 3", ["--impl", "cuda", "--plan", "off", "--stack", "3"]),
    ("shards 4", ["--impl", "cuda", "--plan", "off", "--shards", "4"]),
    ("stack 4 shards 4", ["--impl", "cuda", "--plan", "off", "--stack", "4", "--shards", "4"]),
]


def phase15_t1_batched(device, rows) -> None:
    """T1's batch axis on the card: T1 full mode (every stencil group of
    PACKED_SPECS that T1 takes, so every edge mode, gray and RGB) and T1-pw
    (T1_BATCH_CHAINS) on stacks of N = 1, 2 and 3 small images through the
    same launch entry as one image, each against its plain version image by
    image, one launch counted per call; pipeline_packed on a non-contiguous
    source stack; then pipeline_packed over T1_FRAMES 8K gray planes
    (gaussian:5): each image equal to golden, one T1 launch for the stack,
    ms a frame beside one frame's call, and the batched T1 row of the
    `kernels` line."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.tools import packed_kernels as pk
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    t0 = time.perf_counter()

    def words_of(stack):
        planes = [stack] if stack.ndim == 3 else [stack[..., c] for c in range(stack.shape[3])]
        return [pk._pack(p) for p in planes]

    def check(tag, pw, st, stack, key):
        h, w = stack.shape[1:3]
        words = words_of(stack)
        ck.reset_launch_counts()
        got = pk.run_group_packed_words(pw, st, words, h, w, batched=True)
        torch.cuda.synchronize()
        if ck.TOOL_LAUNCHES[key] != 1:
            raise AssertionError(f"{tag}: {ck.TOOL_LAUNCHES[key]} {key} launches for a stack")
        want = pk.run_group_packed_words_plain(pw, st, words, h, w, batched=True)
        for c, (g, x) in enumerate(zip(got, want)):
            check_equal(f"{tag} plane {c}", g, x)
        return 1

    n = 0
    groups = []
    for spec in PACKED_SPECS:
        for pw, st in ck.group_ops(make_pipeline_ops(spec)):
            if st is not None:
                groups.append((spec, pw, st))
    for spec, pw, st in groups:
        channels = 3 if pw and pw[0].name.startswith(("grayscale", "sepia")) else 1
        for shape in T1_BATCH_SHAPES:
            if not pk.packed_supported(pw, st, shape[1]) or shape[0] <= st.halo:
                continue
            for nb in T1_BATCH_N:
                stack = stack_of(nb, shape, channels, 300 + nb, device)
                n += check(f"T1 batched {spec} N={nb} {shape}", pw, st, stack, "T1")
    for chain in T1_BATCH_CHAINS:
        pw, st = split_group(chain)
        channels = 3 if chain.startswith(("grayscale", "sepia")) else 1
        for shape in T1_BATCH_SHAPES:
            for nb in T1_BATCH_N:
                stack = stack_of(nb, shape, channels, 310 + nb, device)
                n += check(f"T1-pw batched {chain} N={nb} {shape}", pw, st, stack, "T1-pw")
    # a non-contiguous source stack: every other image of a stack of 6
    ops = make_pipeline_ops("grayscale,gaussian:5,invert,sobel")
    src = stack_of(6, (66, 260), 3, 320, device)[::2]
    got = pk.pipeline_packed(ops, src, batched=True)
    gold = Pipeline.parse("grayscale,gaussian:5,invert,sobel")
    for t in range(src.shape[0]):
        check_equal(f"pipeline_packed non-contiguous stack image {t}", got[t], gold(src[t]))
    n += 1
    print(f"phase 15: T1 and T1-pw batched equal to their plain versions (max_abs_err 0) in {n} "
          f"cases, one launch a stack; {time.perf_counter() - t0:.1f} s")

    # pipeline_packed over the 8K gray planes
    ops = make_pipeline_ops("gaussian:5")
    (pw5, st5), = ck.group_ops(ops)
    gray = ck.pointwise_group(split_group("grayscale")[0],
                              stack_of(T1_FRAMES, (MAIN_H, MAIN_W), 3, 0, device), batched=True)
    ck.reset_launch_counts()
    out = pk.pipeline_packed(ops, gray, batched=True)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ck.launch_counts().items() if v}
    if counts != {"T1": 1}:
        raise AssertionError(f"pipeline_packed over {T1_FRAMES} 8K planes launched {counts}")
    golden = Pipeline.parse("gaussian:5")
    for t in range(T1_FRAMES):
        check_equal(f"pipeline_packed 8K gray image {t}", out[t], golden(gray[t]))
    del out
    t_stack = device_time_ms(lambda: pk.pipeline_packed(ops, gray, batched=True), reps=5, inner=2)
    t_single = device_time_ms(lambda: [pk.pipeline_packed(ops, x) for x in gray], reps=5, inner=2)
    print(f"phase 15: pipeline_packed [gaussian:5] N={T1_FRAMES} x {MAIN_H}x{MAIN_W} gray: launches "
          f"{counts}, stack {t_stack:.4f} ms ({t_stack / T1_FRAMES:.4f} a frame), {T1_FRAMES} "
          f"single calls {t_single:.4f} ms ({t_single / T1_FRAMES:.4f} a frame; per frame stack / "
          f"single {t_stack / t_single:.3f})")
    words = [pk._pack(gray)]
    n_pix = T1_FRAMES * MAIN_H * MAIN_W
    fn = lambda: pk.run_group_packed_words(pw5, st5, words, MAIN_H, MAIN_W, batched=True)[0]  # noqa: E731
    plain = lambda: pk.run_group_packed_words_plain(pw5, st5, words, MAIN_H, MAIN_W,  # noqa: E731
                                                    batched=True)[0]
    err = int((fn().int() - plain().int()).abs().max().item())
    if err:
        raise AssertionError(f"T1 batched 8K: kernel != plain, max abs err {err}")
    ms = device_time_ms(fn, reps=7)
    plain_ms = device_time_ms(plain, warmup=1, reps=2, inner=1)
    import torch.nn.functional as F

    xf = F.pad(gray[:, None].float(), (2, 2, 2, 2), mode="reflect")
    wk = torch.as_tensor(st5.kernels[0] * st5.scale, dtype=torch.float32, device=device)[None, None]
    library_ms = device_time_ms(lambda: F.conv2d(xf, wk), reps=7)
    del xf
    bound_ms, bound_by = bound(2 * n_pix, op_count([st5], n_pix, 1))
    rows.append({
        "name": f"T1 packed_stream [gaussian5] batched N={T1_FRAMES} 8K gray words", "route": "cuda",
        "source": "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/packed_stream.cu",
        "replaces": "tools/packed_kernels.py:752", "launches": counts["T1"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    })
    print(f"kernel T1 batched N={T1_FRAMES}: {ms:.4f} ms ({ms / T1_FRAMES:.4f} per image), bound "
          f"{bound_ms:.4f} ms by {bound_by} ({bound_ms / ms:.1%}), plain {plain_ms:.4f} ms, "
          f"library {library_ms:.4f} ms, launches {counts['T1']}")
    del gray, words
    torch.cuda.empty_cache()


def _pct(stages: dict) -> str:
    return "; ".join(
        f"{k} " + ("-" if v is None else f"p50 {v['p50_ms']:.2f} p95 {v['p95_ms']:.2f} ms")
        for k, v in stages.items())


def phase16_engine(device) -> None:
    """The engine on the card: ENGINE_DISPATCHES frames of the 8K reference
    (each a fresh frame: the seed-0 frame plus 37 k, modulo 256) through
    Engine(inflight=3) with device_stager and Pipeline.jit(donate=True),
    each output byte for byte equal to golden (by SHA-256 of the bytes, the
    goldens computed first on the card): the staged buffers' record_stream
    under load. The engine's stage percentiles and device_idle_frac; then
    inflight 1 and 2 with each output also written as a PGM file (the
    native codec) on the encode pool; what pinning a 99.5 MB buffer costs; the pinned
    and pageable H2D and D2H of the frame."""
    import hashlib
    import statistics
    import threading

    import numpy as np
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.engine import Engine, EngineMetrics, device_stager
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import save_image, synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    t0 = time.perf_counter()
    base = synthetic_image(MAIN_H, MAIN_W, seed=0)
    frame = lambda k: base + np.uint8((37 * k) % 256)  # noqa: E731
    spec = SPECS["reference"]
    gold = Pipeline.parse(spec)
    want = [hashlib.sha256(gold(torch.from_numpy(frame(k)).to(device)).cpu().numpy().tobytes())
            .hexdigest() for k in range(ENGINE_DISPATCHES)]
    t_gold = time.perf_counter() - t0

    def run_engine(inflight, n, encode=None):
        fn = Pipeline.parse(spec).jit("cuda", device=device, plan="off", donate=True)
        metrics = EngineMetrics()
        bad, got = [], {}
        lock = threading.Lock()

        def on_done(k, out, info):
            h = hashlib.sha256(out.tobytes()).hexdigest()
            if encode is not None:
                encode(k, out)
            with lock:
                got[k] = h

        def on_error(k, e):
            with lock:
                bad.append((k, repr(e)))

        t = time.perf_counter()
        with Engine(inflight=inflight, io_threads=4, stage=device_stager(device, inflight=inflight),
                    metrics=metrics, name="chip") as eng:
            for k in range(n):
                eng.submit(k, lambda k=k: frame(k), fn, on_done=on_done, on_error=on_error)
            if not eng.flush(timeout=600):
                raise AssertionError("engine did not drain in 600 s")
        wall = time.perf_counter() - t
        if bad:
            raise AssertionError(f"engine failures: {bad[:3]}")
        wrong = [k for k in range(n) if got.get(k) != want[k]]
        if wrong:
            raise AssertionError(f"engine outputs differ from golden at dispatches {wrong[:8]}")
        return metrics.snapshot(), wall

    snap, wall = run_engine(3, ENGINE_DISPATCHES)
    print(f"phase 16: engine inflight=3, {ENGINE_DISPATCHES} dispatches of the 8K reference, every "
          f"output equal to golden (goldens {t_gold:.1f} s); wall {wall:.2f} s "
          f"({ENGINE_DISPATCHES * MAIN_H * MAIN_W / 1e6 / wall:.1f} MP/s), inflight peak "
          f"{snap['inflight_peak']}, device_idle_frac {snap['device_idle_frac']:.4f}; stages: "
          f"{_pct(snap['stages'])}")
    tmp = tempfile.mkdtemp(prefix="mcim_engine_")

    def write_ppm(k, out):
        save_image(os.path.join(tmp, f"{k % 4}.pgm"), out)

    for inflight in (1, 2):
        snap, wall = run_engine(inflight, ENGINE_IDLE_DISPATCHES, encode=write_ppm)
        print(f"phase 16: engine inflight={inflight}, {ENGINE_IDLE_DISPATCHES} dispatches with a PGM "
              f"write each: wall {wall:.2f} s, device_idle_frac {snap['device_idle_frac']:.4f}, "
              f"inflight peak {snap['inflight_peak']}; stages: {_pct(snap['stages'])}")
    # pinning 99.5 MB: page-locking a fresh host buffer in place
    # (cudaHostRegister, and its unregister), and fresh blocks of PyTorch's
    # caching host allocator (three held at once, so that each is a new
    # cudaHostAlloc unless the cache holds that many), then one from its
    # cache after a free
    nbytes = MAIN_H * MAIN_W * 3
    cudart = torch.cuda.cudart()
    fresh = np.ones(nbytes, dtype=np.uint8)  # touched: its pages exist
    t = time.perf_counter()
    rc = cudart.cudaHostRegister(fresh.ctypes.data, nbytes, 0)
    register = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    cudart.cudaHostUnregister(fresh.ctypes.data)
    unregister = (time.perf_counter() - t) * 1e3
    if int(rc) != 0:
        raise AssertionError(f"cudaHostRegister returned {rc}")
    held, allocs = [], []
    for _ in range(3):
        t = time.perf_counter()
        held.append(torch.empty(nbytes, dtype=torch.uint8, pin_memory=True))
        allocs.append((time.perf_counter() - t) * 1e3)
    pinned = held.pop(0)
    held.clear()
    t = time.perf_counter()
    again = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    cached = (time.perf_counter() - t) * 1e3
    del again
    host = torch.from_numpy(base.reshape(-1))
    t = time.perf_counter()
    pinned.copy_(host)
    fill = (time.perf_counter() - t) * 1e3

    def xfer_ms(fn):
        samples = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t) * 1e3)
        return statistics.median(samples)

    dev_buf = pinned.to(device)
    h2d_pin = xfer_ms(lambda: dev_buf.copy_(pinned, non_blocking=True))
    h2d_page = xfer_ms(lambda: dev_buf.copy_(host))
    d2h_pin = xfer_ms(lambda: pinned.copy_(dev_buf, non_blocking=True))
    page_out = torch.empty_like(host)
    d2h_page = xfer_ms(lambda: page_out.copy_(dev_buf))
    rate = lambda ms: nbytes / ms / 1e6  # noqa: E731  GB/s
    print(f"phase 16: pinning a {nbytes / 1e6:.1f} MB buffer: cudaHostRegister {register:.2f} ms "
          f"(unregister {unregister:.2f} ms); caching host allocator, three held "
          f"{', '.join(f'{x:.2f}' for x in allocs)} ms, again after a free {cached:.3f} ms; filling "
          f"it from pageable memory {fill:.2f} ms; H2D pinned {h2d_pin:.3f} ms "
          f"({rate(h2d_pin):.1f} GB/s), pageable {h2d_page:.3f} ms ({rate(h2d_page):.1f} GB/s); D2H pinned {d2h_pin:.3f} ms "
          f"({rate(d2h_pin):.1f} GB/s), pageable {d2h_page:.3f} ms ({rate(d2h_page):.1f} GB/s); "
          f"{time.perf_counter() - t0:.1f} s")
    del pinned, dev_buf, page_out
    torch.cuda.empty_cache()


@contextlib.contextmanager
def one_card_meshes(device):
    """`make_mesh` and `make_mesh_2d` with slot i on card i modulo the cards
    (the earlier phases' 4-slot mesh of one card), for the CLI's --shards."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.parallel import mesh as pmesh

    real1, real2 = pmesh.make_mesh, pmesh.make_mesh_2d
    cards = torch.cuda.device_count()

    def slots(n):
        return [torch.device("cuda", i % cards) for i in range(n)]

    pmesh.make_mesh = lambda n=None, *, devices=None: real1(n, devices=devices or slots(n))
    pmesh.make_mesh_2d = lambda r, c, *, devices=None: real2(r, c, devices=devices or slots(r * c))
    try:
        yield
    finally:
        pmesh.make_mesh, pmesh.make_mesh_2d = real1, real2


def run_batch_cli(argv) -> tuple[int, str]:
    """`batch` through the port's main, in this process; (exit code, stdout)."""
    import io

    from mpi_cuda_imagemanipulation_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["batch", *argv])
    return rc, buf.getvalue()


def phase17_batch_cli(device) -> None:
    """CLI `batch` at 8K (module docstring, phase 17): a directory of the 8K
    RGB synthetic frames BATCH_PPM_SEEDS as PPM (the native codec, whose
    counter must move by every input and output) and BATCH_PNG_SEEDS as PNG;
    the reference pipeline through each of BATCH_CLI_RUNS over the PPM
    files at --inflight 1 and 2, and `cuda --plan off` over the PNG files at
    both; every output file byte-equal to Pipeline.parse(spec)(img) with
    gray replicated to RGB; each run's end-to-end MP/s and device idle
    share as `--show-timing` prints them."""
    import re
    import shutil

    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
        gray_to_rgb,
        load_image,
        save_image,
        synthetic_image,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.runtime import codec

    t0 = time.perf_counter()
    if not codec.available():
        raise AssertionError("the native codec did not build (runtime/build.py)")
    print(f"phase 17: native codec {codec.library_path()}")
    root = tempfile.mkdtemp(prefix="mcim_batch_")
    src = os.path.join(root, "in")
    os.makedirs(src)
    spec = SPECS["reference"]
    gold = Pipeline.parse(spec)
    want = {}
    for seed in [*BATCH_PPM_SEEDS, *BATCH_PNG_SEEDS]:
        img = synthetic_image(MAIN_H, MAIN_W, seed=seed)
        name = f"f{seed}.{'ppm' if seed in BATCH_PPM_SEEDS else 'png'}"
        save_image(os.path.join(src, name), img)
        out = gold(torch.from_numpy(img).to(device)).cpu().numpy()
        want[name] = gray_to_rgb(out) if out.ndim == 2 else out
    t_setup = time.perf_counter() - t0
    runs = [(label, "*.ppm", args, inflight) for label, args in BATCH_CLI_RUNS for inflight in (1, 2)]
    runs += [("cuda off png", "*.png", ["--impl", "cuda", "--plan", "off"], inflight)
             for inflight in (1, 2)]
    with one_card_meshes(device):
        for label, glob, args, inflight in runs:
            dst = os.path.join(root, "out")
            metrics = os.path.join(root, "metrics.jsonl")
            reads, writes = codec.NATIVE_IO["read"], codec.NATIVE_IO["write"]
            rc, text = run_batch_cli(["--input-dir", src, "--output-dir", dst, "--glob", glob,
                                      "--ops", spec, "--device", "cuda", "--inflight",
                                      str(inflight), "--show-timing", "--no-journal",
                                      "--json-metrics", metrics, *args])
            line = next((x for x in text.splitlines() if x.startswith("batch [")), "")
            if rc != 0:
                raise AssertionError(f"batch {label} inflight {inflight}: exit {rc}: {text[-500:]}")
            names = sorted(n for n in want if n.endswith(glob[1:]))
            for name in names:
                check_equal(f"batch {label} inflight {inflight} {name}",
                            torch.from_numpy(load_image(os.path.join(dst, name))),
                            torch.from_numpy(want[name]))
            if glob == "*.ppm":
                moved = (codec.NATIVE_IO["read"] - reads, codec.NATIVE_IO["write"] - writes)
                # the run's reads and writes, and this check's reads
                if moved[0] < 2 * len(names) or moved[1] < len(names):
                    raise AssertionError(f"batch {label}: the native codec read/wrote {moved} for "
                                         f"{len(names)} PPM inputs")
            mps = re.search(r"\(([\d.]+) MP/s end-to-end", line)
            idle = re.search(r"device idle (\d+)%", line)
            if mps is None or idle is None:
                raise AssertionError(f"batch {label}: no MP/s or device idle in {line!r}")
            with open(metrics) as f:
                eng = json.loads(f.read().strip())["engine"]
            os.remove(metrics)
            print(f"phase 17: batch [{spec}] {label} {glob} inflight {inflight}: {len(names)} "
                  f"outputs == golden; {mps.group(1)} MP/s end-to-end, device idle "
                  f"{idle.group(1)}% ({line}); engine stages: {_pct(eng['stages'])}")
            shutil.rmtree(dst)
    shutil.rmtree(root)
    print(f"phase 17: CLI batch at 8K, {len(runs)} runs; set-up {t_setup:.1f} s, "
          f"{time.perf_counter() - t0:.1f} s in all")


STREAM_TILE_ROWS = 512
STREAM_SPECS = (SPECS["reference"], SPECS["megakernel_ab"])
GIGA_H, GIGA_W = 100000, 4096  # the JAX package's gigapixel source (cli.py:657)
GIGA_SMALL_H = 25000
VIDEO_FRAMES = 6
VIDEO_SPATIAL = "grayscale,gaussian:5"
VIDEO_TEMPORAL = ("framediff", "tdenoise:3")
STREAM_BATCH_SEEDS = (30, 31)
RESUME_KILL_AT = 5


def _pnm_body(path) -> bytes:
    """The pixel bytes of a binary PNM file written by PNMTileWriter or the
    native codec (header: magic, width height, 255, one newline each)."""
    with open(path, "rb") as f:
        data = f.read()
    return data[data.index(b"\n", data.index(b"\n", data.index(b"\n") + 1) + 1) + 1:]


def _stream_cli(argv) -> tuple[int, dict, str]:
    """`stream` through the port's main, in this process, with
    --json-metrics to a temporary file: (exit code, its record, stdout)."""
    import io

    from mpi_cuda_imagemanipulation_tpu_torch import cli

    fd, metrics = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["stream", *argv, "--json-metrics", metrics])
    with open(metrics) as f:
        text = f.read().strip()
    os.remove(metrics)
    return rc, (json.loads(text) if text else {}), buf.getvalue()


def phase18_stream_8k(device, gpu: str, tmp: str) -> None:
    """STREAM_SPECS over the 8K RGB frame through stream_pipeline at
    STREAM_TILE_ROWS rows: inflight 1 and 2 x impl torch and mxu x plan off
    and fused into an ArrayTileWriter, then a PNG and a PGM file each; every
    output byte-equal to the whole-image golden Pipeline.parse(spec) on the
    card."""
    import numpy as np
    import torch
    from PIL import Image

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.io.stream_codec import (
        ArrayTileReader,
        ArrayTileWriter,
        open_tile_writer,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.stream import StreamMetrics, stream_pipeline

    img = synthetic_image(MAIN_H, MAIN_W, seed=0)
    for spec in STREAM_SPECS:
        ops = Pipeline.parse(spec).ops
        want = Pipeline.parse(spec)(torch.from_numpy(img).to(device)).cpu()
        runs = [(inflight, impl, plan, None) for inflight in (1, 2) for impl in ("torch", "mxu")
                for plan in ("off", "fused")]
        runs += [(2, "torch", "fused", ext) for ext in (".png", ".pgm")]
        for inflight, impl, plan, ext in runs:
            path = None if ext is None else os.path.join(tmp, f"s8k{ext}")
            writer = (ArrayTileWriter(MAIN_H, MAIN_W, 1) if path is None
                      else open_tile_writer(path, MAIN_H, MAIN_W, 1))
            t = time.perf_counter()
            res = stream_pipeline(ArrayTileReader(img), writer, ops, tile_rows=STREAM_TILE_ROWS,
                                  inflight=inflight, impl=impl, plan=plan, device=device,
                                  metrics=StreamMetrics())
            writer.close()
            wall = time.perf_counter() - t
            if path is None:
                got = writer.array
            elif ext == ".png":
                with Image.open(path) as im:
                    got = np.array(im)
            else:
                got = np.frombuffer(_pnm_body(path), np.uint8).reshape(MAIN_H, MAIN_W).copy()
            check_equal(f"stream {spec} inflight {inflight} {impl} {plan} {ext or 'array'}",
                        torch.from_numpy(got), want)
            idle = res.engine["device_idle_frac"]
            print(f"phase 18: stream 8K [{spec}] inflight {inflight} impl {impl} plan {plan} "
                  f"-> {ext or 'ArrayTileWriter'}: == golden; {res.tiles} tiles, "
                  f"{res.compiles} tile functions, {MAIN_H * MAIN_W / 1e6 / wall:.1f} MP/s "
                  f"end-to-end, peak resident {res.peak_resident_bytes} B, device_idle_frac "
                  f"{idle:.4f} ({gpu})")


def phase18_stream_giga(device, gpu: str, tmp: str) -> None:
    """`stream --synthetic GIGA_HxGIGA_W` (RGB) with the reference chain to a
    PGM, its SHA-256 against the golden of the whole frame computed once on
    the card; then GIGA_SMALL_H rows the same way: MP/s, tiles, tile
    functions, the host peak against resident_bound (flat: the bound takes
    no height, and both peaks are held to it) and the frame's bytes,
    device_idle_frac, and the card's allocator peak during each stream."""
    import hashlib

    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.engine import Engine
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import chain_halo
    from mpi_cuda_imagemanipulation_tpu_torch.stream.runner import resident_bound

    spec = SPECS["reference"]
    gold = Pipeline.parse(spec)
    halo = chain_halo(gold.ops)
    for h in (GIGA_H, GIGA_SMALL_H):
        out = os.path.join(tmp, f"giga{h}.pgm")
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        rc, rec, text = _stream_cli(["--synthetic", f"{h}x{GIGA_W}", "--output", out, "--ops",
                                     spec, "--device", str(device), "--no-journal",
                                     "--tile-rows", str(STREAM_TILE_ROWS), "--show-timing"])
        dev_peak = torch.cuda.max_memory_allocated(device) - base
        if rc != 0:
            raise AssertionError(f"stream --synthetic {h}x{GIGA_W}: exit {rc}: {text[-500:]}")
        t = time.perf_counter()
        got = hashlib.sha256(_pnm_body(out)).hexdigest()
        os.remove(out)
        frame = torch.from_numpy(synthetic_image(h, GIGA_W, seed=0)).to(device)
        want = hashlib.sha256(gold(frame).cpu().numpy().tobytes()).hexdigest()
        del frame
        torch.cuda.empty_cache()
        if got != want:
            raise AssertionError(f"stream {h}x{GIGA_W}: SHA-256 {got} != golden {want}")
        bound = resident_bound(width=GIGA_W, channels=3, out_chan=1, tile_rows=rec["tile_rows"],
                               halo=halo, inflight=rec["inflight"],
                               encode_backlog=Engine(inflight=rec["inflight"],
                                                     io_threads=2).encode_backlog,
                               pinned=True)
        frame_bytes = h * GIGA_W * 3
        if not 0 < rec["peak_resident_bytes"] <= bound:
            raise AssertionError(f"stream {h}x{GIGA_W}: peak resident {rec['peak_resident_bytes']}"
                                 f" B outside (0, {bound}]")
        if rec["compiles"] > 4:
            raise AssertionError(f"stream {h}x{GIGA_W}: {rec['compiles']} tile functions")
        print(f"phase 18: stream --synthetic {h}x{GIGA_W} [{spec}] -> PGM: SHA-256 == golden "
              f"(golden and check {time.perf_counter() - t:.1f} s); {rec['mp']:.1f} MP in "
              f"{rec['wall_s']:.2f} s of stream, {rec['mp_per_s']:.1f} MP/s end-to-end incl. "
              f"encode; {rec['tiles']} tiles, {rec['compiles']} tile functions; host peak "
              f"resident {rec['peak_resident_bytes']} B (bound {bound} B) vs the frame's "
              f"{frame_bytes} B ({frame_bytes / rec['peak_resident_bytes']:.1f}x); "
              f"device_idle_frac {rec['engine']['device_idle_frac']:.4f}; card allocator peak "
              f"during the stream {dev_peak} B ({gpu})")


def phase18_video(device, gpu: str, tmp: str) -> None:
    """VIDEO_FRAMES 8K frames (PPM) through stream_video with each of
    VIDEO_TEMPORAL before VIDEO_SPATIAL, to PGM frames; each equal to the
    temporal op on the host (ops/temporal.py) followed by the golden
    spatial chain on the card."""
    from collections import deque

    import numpy as np
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import save_image, synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops.temporal import split_temporal
    from mpi_cuda_imagemanipulation_tpu_torch.stream import stream_video

    base = synthetic_image(MAIN_H, MAIN_W, seed=3)
    frames, paths = [], []
    for k in range(VIDEO_FRAMES):
        frame = np.roll(base, 64 * k, axis=1) // (1 + k % 3)
        path = os.path.join(tmp, f"v{k}.ppm")
        save_image(path, frame)
        frames.append(frame)
        paths.append(path)
    gold = Pipeline.parse(VIDEO_SPATIAL)
    for top in VIDEO_TEMPORAL:
        spec = f"{top},{VIDEO_SPATIAL}"
        out = os.path.join(tmp, "vout")
        rec = stream_video(paths, out, spec, tile_rows=STREAM_TILE_ROWS, device=device,
                           out_ext=".pgm")
        (op,), _rest = split_temporal(top)
        ring: deque = deque(maxlen=op.window)
        for k, frame in enumerate(frames):
            ring.append(frame)
            want = gold(torch.from_numpy(op(ring)).to(device)).cpu()
            got = np.frombuffer(_pnm_body(os.path.join(out, f"v{k}.pgm")), np.uint8).copy()
            check_equal(f"video [{spec}] frame {k}", torch.from_numpy(got.reshape(MAIN_H, MAIN_W)),
                        want)
        print(f"phase 18: video [{spec}] {VIDEO_FRAMES} 8K frames == golden; {rec['fps']:.2f} fps, "
              f"ring sizes {rec['ring_sizes']}, peak resident {rec['peak_resident_bytes']} B, "
              f"device_idle_frac {rec['engine']['device_idle_frac']:.4f} ({gpu})")


def phase18_batch(device, gpu: str, tmp: str) -> None:
    """`batch --stream-rows STREAM_TILE_ROWS` over two 8K PPM frames against
    `batch --impl cuda --plan off` on the same directory: the files equal
    byte for byte."""
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import save_image, synthetic_image

    src = os.path.join(tmp, "bin")
    os.makedirs(src)
    for seed in STREAM_BATCH_SEEDS:
        save_image(os.path.join(src, f"b{seed}.ppm"), synthetic_image(MAIN_H, MAIN_W, seed=seed))
    lines = {}
    for label, extra in (("stream", ["--stream-rows", str(STREAM_TILE_ROWS), "--impl", "torch"]),
                         ("whole", ["--impl", "cuda", "--plan", "off"])):
        rc, text = run_batch_cli(["--input-dir", src, "--output-dir", os.path.join(tmp, label),
                                  "--ops", SPECS["reference"], "--device", str(device),
                                  "--no-journal", "--show-timing", *extra])
        if rc != 0:
            raise AssertionError(f"batch {label}: exit {rc}: {text[-500:]}")
        lines[label] = next((x for x in text.splitlines() if x.startswith("batch [")), "")
    for seed in STREAM_BATCH_SEEDS:
        name = f"b{seed}.ppm"
        with open(os.path.join(tmp, "stream", name), "rb") as a, \
                open(os.path.join(tmp, "whole", name), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"batch --stream-rows {name} differs from batch's file")
    print(f"phase 18: batch --stream-rows {STREAM_TILE_ROWS} over {len(STREAM_BATCH_SEEDS)} 8K PPM "
          f"frames: files byte-equal to batch --impl cuda --plan off's; {lines['stream']} | "
          f"{lines['whole']} ({gpu})")


def phase18_attribution(device, gpu: str) -> None:
    """obs/cost.attribute_plan on the reference and megakernel_ab plans at
    8K under fused-pallas with pallas=True: exactly one K4 launch a stage,
    every drift ratio in the band; each stage's temp_bytes beside the same
    stage walked by torch."""
    from mpi_cuda_imagemanipulation_tpu_torch.obs import cost as obs_cost
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan

    lo, hi = obs_cost.drift_band()
    for name in ("reference", "megakernel_ab"):
        plan = build_plan(make_pipeline_ops(SPECS[name]), "fused-pallas")
        ck.reset_launch_counts()
        rows = obs_cost.attribute_plan(plan, (MAIN_H, MAIN_W, 3), pallas=True, device=device)
        launches = {k: v for k, v in ck.launch_counts().items() if v}
        if launches.get("K4") != len(plan.stages):
            raise AssertionError(f"attribute_plan {name}: launches {launches}, "
                                 f"{len(plan.stages)} stages")
        walked = obs_cost.attribute_plan(plan, (MAIN_H, MAIN_W, 3), device=device)
        for row, walk in zip(rows, walked):
            r = row["drift_ratio"]
            if r is None or not lo <= r <= hi:
                raise AssertionError(f"attribute_plan {name} {row['stage']}: ratio {r}")
            print(f"phase 18: attribute_plan {name} {row['stage']} {row['names']}: one K4 launch, "
                  f"drift {r:.4f} (band [{lo}, {hi}]), boundary {row['cost']['boundary_bytes']:.0f}"
                  f" B, temp_bytes K4 {row['cost']['temp_bytes']} B vs torch walker "
                  f"{walk['cost']['temp_bytes']} B ({gpu})")


def phase18_resume(device, gpu: str, tmp: str) -> None:
    """`stream --synthetic` 8K to a PGM killed by the stream.tile failpoint
    at tile RESUME_KILL_AT, then --resume: the file byte-equal to golden and
    only the missing tiles run."""
    import numpy as np
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints

    spec = SPECS["reference"]
    out = os.path.join(tmp, "resume.pgm")
    base = ["--synthetic", f"{MAIN_H}x{MAIN_W}", "--output", out, "--ops", spec, "--device",
            str(device), "--tile-rows", str(STREAM_TILE_ROWS)]
    try:
        rc, _rec, text = _stream_cli([*base, "--failpoints", f"stream.tile=after:{RESUME_KILL_AT}"])
    finally:
        failpoints.clear()
    if rc != 1:
        raise AssertionError(f"stream with stream.tile=after:{RESUME_KILL_AT}: exit {rc}, want 1")
    rc, rec, text = _stream_cli([*base, "--resume"])
    if rc != 0 or (rec["tiles_resumed"], rec["tiles_done"]) != (RESUME_KILL_AT,
                                                                rec["tiles"] - RESUME_KILL_AT):
        raise AssertionError(f"stream --resume: exit {rc}, record {rec}")
    want = Pipeline.parse(spec)(torch.from_numpy(synthetic_image(MAIN_H, MAIN_W, seed=0))
                                .to(device)).cpu()
    got = np.frombuffer(_pnm_body(out), np.uint8).reshape(MAIN_H, MAIN_W).copy()
    check_equal("stream --resume", torch.from_numpy(got), want)
    print(f"phase 18: stream killed at tile {RESUME_KILL_AT} then --resume: file == golden; "
          f"{rec['tiles_resumed']} tiles resumed, {rec['tiles_done']} of {rec['tiles']} run ({gpu})")


def phase18_stream(device) -> None:
    """The streaming tile engine on the card (module docstring, phase 18)."""
    import shutil

    t0 = time.perf_counter()
    gpu = nvidia_smi()
    tmp = tempfile.mkdtemp(prefix="mcim_stream_")
    try:
        phase18_stream_8k(device, gpu, tmp)
        phase18_stream_giga(device, gpu, tmp)
        phase18_video(device, gpu, tmp)
        phase18_batch(device, gpu, tmp)
        phase18_attribution(device, gpu)
        phase18_resume(device, gpu, tmp)
    finally:
        shutil.rmtree(tmp)
    print(f"phase 18: the streaming tile engine, {time.perf_counter() - t0:.1f} s in all")


# --------------------------------------------------------------------------
# phase 19: online serving (serve/)
# --------------------------------------------------------------------------

# (a) the padded executor: the chains, then one stencil per edge mode on
# gray stacks ('zero': box:3 with its edge mode set, as no registry op
# extends with zeros)
SERVE_SPECS = {
    "reference": SPECS["reference"],
    "megakernel_ab": SPECS["megakernel_ab"],
    "global": "grayscale,equalize,gaussian:5",
    "interior": "emboss:3",
    "reflect101": "gaussian:5",
    "edge": "erode:3",
    "zero": "box:3",
}
SERVE_GRAY = ("interior", "reflect101", "edge", "zero")
# eight true shapes a bucket, every one different, exact fits and 1 past
# the next bucket down among them
SERVE_SHAPES = {
    2048: [(2048, 2048), (1999, 1500), (1100, 2048), (1025, 1300), (1777, 1111),
           (2047, 1025), (1300, 1950), (1050, 1050)],
    4096: [(4096, 4096), (4000, 3001), (3100, 4096), (2049, 2500), (3333, 2222),
           (4095, 2049), (2600, 3900), (2100, 2100)],
}
SERVE_ROUTES = [(b, p) for b in ("torch", "mxu", "auto")
                for p in ("off", "fused-pallas-mxu", "auto")]
# (b) the JAX package's hardware serve_loadgen lane (bench_suite.py:2463-2480)
SERVE_LANE = dict(buckets=((512, 512), (1024, 1024), (2048, 2048)), max_batch=8,
                  max_delay_ms=4.0, queue_depth=256, channels=(3,))
SERVE_RATES = (64.0, 256.0, 1024.0)
SERVE_RATE_S = 4.0
SERVE_IMAGES = 48
# (c) CLI serve requests: (height, width) of RGB PNGs
SERVE_CLI_SHAPES = ((300, 500), (2000, 1500), (4096, 3000))
SERVE_CLI_BUCKETS = "512,1024,2048,4096"  # serve's default
SERVE_WAIT_S = 120


def phase19_padded(device, gpu: str) -> None:
    """serve/padded.make_serving_fn on the card for every SERVE_SPECS chain
    x SERVE_ROUTES, on a batch of 8 images of 8 true shapes in the 2048 and
    4096 buckets: each crop byte-equal to the golden torch ops on the card,
    which `Pipeline.jit(backend='cuda')` (the kernels) also equals, but on
    the zero-mode stencil, which K2 does not take."""
    import dataclasses

    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.serve import bucketing

    for name, spec in SERVE_SPECS.items():
        pipe = Pipeline.parse(spec)
        if name == "zero":
            pipe = Pipeline(tuple(dataclasses.replace(op, edge_mode="zero") for op in pipe.ops))
        ch = 1 if name in SERVE_GRAY else 3
        # K2 takes no zero-mode stencil (none is in the registry): that
        # chain is held to the golden ops alone
        kernels = None if name == "zero" else pipe.jit("cuda", device=device)
        for bucket, shapes in SERVE_SHAPES.items():
            imgs = [synthetic_image(h, w, channels=ch, seed=19 + k)
                    for k, (h, w) in enumerate(shapes)]
            stack = bucketing.pad_stack(
                [bucketing.pad_to_bucket(i, bucket, bucket) for i in imgs], len(imgs))
            stack = torch.from_numpy(stack).to(device)
            th = torch.tensor([h for h, _ in shapes], dtype=torch.int32, device=device)
            tw = torch.tensor([w for _, w in shapes], dtype=torch.int32, device=device)
            wants = []
            for k, img in enumerate(imgs):
                x = torch.from_numpy(img).to(device)
                want = pipe(x)
                if kernels is not None:
                    check_equal(f"phase 19 {name} {bucket} image {k}: Pipeline.jit('cuda') vs "
                                "golden", kernels(x), want)
                wants.append(want)
            del imgs
            times = []
            for backend, plan in SERVE_ROUTES:
                fn = pipe.serving(bucket, bucket, ch, len(shapes), backend=backend, plan=plan,
                                  device=device)
                torch.cuda.synchronize(device)
                t = time.perf_counter()
                out = fn(stack, th, tw)
                torch.cuda.synchronize(device)
                times.append((time.perf_counter() - t) * 1e3)
                for k, (h, w) in enumerate(shapes):
                    check_equal(f"phase 19 serve {name} bucket {bucket} {backend} {plan} "
                                f"image {k} ({h}x{w})", out[k, :h, :w], wants[k])
                del out
            print(f"phase 19: padded [{name}: {spec}] bucket {bucket} x 8 true shapes, "
                  f"{'gray' if ch == 1 else 'RGB'}: {len(SERVE_ROUTES)} routes (torch/mxu/auto x "
                  f"off/fused-pallas-mxu/auto) == golden"
                  f"{'' if kernels is None else ' == Pipeline.jit(cuda)'}; first call "
                  f"{min(times):.1f}-{max(times):.1f} ms a batch of 8 ({gpu})")
            del stack, wants


class _CheckedClient:
    """A serve Client whose every completed response a verifier thread
    holds to its golden (in submission order) and then drops, so that a
    sweep keeps no result buffers alive; `close()` raises on a mismatch."""

    def __init__(self, app, golden: dict):
        import queue
        import threading

        from mpi_cuda_imagemanipulation_tpu_torch.serve.server import Client

        self._client = Client(app)
        self._golden = golden
        self._q = queue.Queue()
        self.checked = 0
        self.pixels = 0
        self.errors: list[str] = []
        self._thread = threading.Thread(target=self._verify, daemon=True)
        self._thread.start()

    def submit(self, img, *, deadline_ms=None):
        r = self._client.submit(img, deadline_ms=deadline_ms)
        self._q.put((img, r))
        return r

    def _verify(self) -> None:
        import numpy as np

        while True:
            item = self._q.get()
            if item is None:
                return
            img, r = item
            r.done.wait(SERVE_WAIT_S)
            if r.status == "ok":
                if not np.array_equal(r.result, self._golden[id(img)]):
                    self.errors.append(f"{img.shape}: response != golden")
                self.checked += 1
                self.pixels += img.shape[0] * img.shape[1]
                r.result = None

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(SERVE_WAIT_S)
        if self._thread.is_alive() or self.errors:
            raise AssertionError(f"phase 19 sweep: {self.errors[:3] or 'verifier stuck'}")


def phase19_lane(device, gpu: str) -> None:
    """A ServeApp at the JAX hardware lane's settings (SERVE_LANE) on the
    reference pipeline: warmup, then SERVE_RATES offered open-loop for
    SERVE_RATE_S each over SERVE_IMAGES mixed_shapes images; every
    completed response byte-equal to its golden, no first call after
    warmup; per rate the completed and shed counts, e2e percentiles, mean
    batch occupancy, the device's idle share and MP/s; the devmem gauges
    (the allocator peak reset before the app starts)."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen
    from mpi_cuda_imagemanipulation_tpu_torch.serve.padded import min_true_dim
    from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeApp, ServeConfig

    spec = SPECS["reference"]
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    app = ServeApp(ServeConfig(ops=spec, device=str(device), **SERVE_LANE)).start()
    try:
        cache = app.cache.stats()
        print(f"phase 19: lane app warm: {cache['compiled']} functions (buckets "
              f"{'/'.join(str(h) for h, _ in app.cache.buckets)} x batches "
              f"{list(app.cache.batch_buckets)}) in {cache['warmup_s']:.3f} s ({gpu})")
        images = loadgen.mixed_shapes(app.cache.buckets, SERVE_IMAGES, channels=3, seed=7,
                                      min_dim=min_true_dim(app.pipe))
        golden = {id(img): Pipeline.parse(spec)(torch.from_numpy(img).to(device)).cpu().numpy()
                  for img in images}
        stages = app.registry.get("mcim_engine_stage_seconds")

        def stage_totals():
            return {st: (stages.sum(stage=st), stages.count(stage=st))
                    for st in ("h2d", "enqueue", "force", "encode")}

        for rps in SERVE_RATES:
            client = _CheckedClient(app, golden)
            m0 = app.metrics.snapshot()
            idle0 = app.scheduler.engine.metrics.snapshot()["idle_s"]
            st0 = stage_totals()
            rec = loadgen.run_offered_load(client, images, rps, SERVE_RATE_S)
            client.close()
            m1 = app.metrics.snapshot()
            idle = (app.scheduler.engine.metrics.snapshot()["idle_s"] - idle0) / rec["wall_s"]
            # each engine stage's mean ms a dispatch over this rate's dispatches
            st_ms = {st: (s1 - st0[st][0]) / max(n1 - st0[st][1], 1) * 1e3
                     for st, (s1, n1) in stage_totals().items()}
            dispatches = m1["dispatches"] - m0["dispatches"]
            occ = (m1["completed"] - m0["completed"]) / dispatches if dispatches else None
            if client.checked != rec["completed"]:
                raise AssertionError(f"phase 19 sweep {rps}: {client.checked} checked of "
                                     f"{rec['completed']} completed")
            print(f"phase 19: lane offered {rps:.0f} rps x {SERVE_RATE_S:.0f} s: submitted "
                  f"{rec['submitted']}, completed {rec['completed']} (all == golden), shed "
                  f"{rec['shed']}, e2e p50/p95/p99 {rec.get('e2e_p50_ms', float('nan')):.3f}/"
                  f"{rec.get('e2e_p95_ms', float('nan')):.3f}/"
                  f"{rec.get('e2e_p99_ms', float('nan')):.3f} ms, achieved "
                  f"{rec['achieved_rps']:.3f} rps, {client.pixels / rec['wall_s'] / 1e6:.3f} MP/s, "
                  f"mean batch occupancy {occ if occ is None else round(occ, 3)}, "
                  f"device_idle_frac {idle:.4f}; engine mean ms a dispatch "
                  + ", ".join(f"{st} {v:.3f}" for st, v in st_ms.items()) + f" ({gpu})")
        stats = app.cache.stats()
        if stats["traces_since_warmup"] or stats["misses"]:
            raise AssertionError(f"phase 19 lane: {stats}")
        mem = app.devmem.snapshot()
        print(f"phase 19: lane traces_since_warmup 0, misses 0; devmem {json.dumps(mem)} ({gpu})")
    finally:
        app.stop()


def phase19_cli(device, gpu: str, tmp: str) -> None:
    """`serve` in a subprocess on a free port with its default buckets
    (512-4096) and channels 1,3: PNG requests == golden, /healthz, /stats,
    /metrics; SIGTERM drains and exits 0."""
    import re
    import signal
    import socket
    import threading
    import urllib.request

    import numpy as np
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
        decode_image_bytes,
        encode_image_bytes,
        synthetic_image,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import parse_exposition

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    metrics = os.path.join(tmp, "serve.json")
    t0 = time.perf_counter()
    p = subprocess.Popen(
        [sys.executable, "-m", "mpi_cuda_imagemanipulation_tpu_torch", "serve", "--host",
         "127.0.0.1", "--port", str(port), "--device", str(device), "--buckets",
         SERVE_CLI_BUCKETS, "--json-metrics", metrics],
        cwd=root, env=env, stderr=subprocess.PIPE, text=True,
    )
    lines: list[str] = []
    up = threading.Event()

    def read():
        for line in p.stderr:
            lines.append(line)
            if re.search(r"serving \[.*\] on ", line):
                up.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        if not up.wait(SERVE_WAIT_S):
            raise AssertionError("phase 19 cli: serve did not come up:\n" + "".join(lines[-20:]))
        t_up = time.perf_counter() - t0
        base = f"http://127.0.0.1:{port}"
        ref = Pipeline.parse(SPECS["reference"])
        for k, (h, w) in enumerate(SERVE_CLI_SHAPES):
            img = synthetic_image(h, w, channels=3, seed=190 + k)
            req = urllib.request.Request(f"{base}/v1/process", data=encode_image_bytes(img),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=SERVE_WAIT_S) as r:
                if r.status != 200 or r.headers["Content-Type"] != "image/png":
                    raise AssertionError(f"phase 19 cli: {r.status} {r.headers}")
                got = decode_image_bytes(r.read())
            want = ref(torch.from_numpy(img).to(device)).cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"phase 19 cli: response {h}x{w} != golden")
        with urllib.request.urlopen(f"{base}/healthz", timeout=SERVE_WAIT_S) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/stats", timeout=SERVE_WAIT_S) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/metrics", timeout=SERVE_WAIT_S) as r:
            fams = parse_exposition(r.read().decode())
        if (health["state"] != "serving" or stats["completed"] != len(SERVE_CLI_SHAPES)
                or stats["cache"]["traces_since_warmup"] != 0):
            raise AssertionError(f"phase 19 cli: health {health}, stats {stats['cache']}")
        devmem = fams["mcim_devmem_peak_bytes_in_use"]["samples"]
        if "mcim_plan_builds_total" not in fams or (device.type == "cuda" and not devmem):
            raise AssertionError(f"phase 19 cli: /metrics lacks plan or devmem: {sorted(fams)}")
        p.send_signal(signal.SIGTERM)
        rc = p.wait(SERVE_WAIT_S)
        reader.join(SERVE_WAIT_S)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    log = "".join(lines)
    if rc != 0 or "graceful drain" not in log:
        raise AssertionError(f"phase 19 cli: exit {rc}\n{log[-2000:]}")
    with open(metrics) as f:
        rec = json.loads(f.read())
    warm = re.search(r"function cache warm: (\d+) functions in ([\d.]+)s", log)
    print(f"phase 19: CLI serve up in {t_up:.1f} s (warm: {warm.group(1)} functions in "
          f"{warm.group(2)} s, buckets {SERVE_CLI_BUCKETS} x batches 1-8, channels 3 of 1,3); "
          f"{len(SERVE_CLI_SHAPES)} PNG requests == golden; /healthz serving, /stats, /metrics "
          f"(mcim_plan_*, peak {dict(devmem)}); SIGTERM: drained, exit 0, record "
          f"completed {rec['completed']}, health {rec['health']['state']} ({gpu})")


def phase19_faults(device, gpu: str) -> None:
    """The fault lane: a 0.3 transient `serve.dispatch` fault rate under
    concurrent mixed shapes (retries; every completed response == golden),
    then `always` with a one-failure breaker: the first request
    quarantined, the next ones through the degraded golden fallback ==
    golden, and after the fault clears the half-open probe restores the
    fast path."""
    import numpy as np
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen
    from mpi_cuda_imagemanipulation_tpu_torch.serve.server import Client, ServeApp, ServeConfig

    spec = SPECS["reference"]
    ref = Pipeline.parse(spec)
    base = dict(ops=spec, device=str(device), buckets=((512, 512), (1024, 1024)), max_batch=8,
                max_delay_ms=4.0, queue_depth=256, channels=(3,))
    images = loadgen.mixed_shapes(base["buckets"], 16, channels=3, seed=3, min_dim=2)
    golden = [ref(torch.from_numpy(img).to(device)).cpu().numpy() for img in images]
    try:
        failpoints.configure("serve.dispatch=0.3", seed=7)
        app = ServeApp(ServeConfig(**base, retry_attempts=4, retry_base_delay_ms=1.0)).start()
        try:
            client = Client(app)
            reqs = [(k % 16, client.submit(images[k % 16])) for k in range(64)]
            ok = 0
            for k, r in reqs:
                r.done.wait(SERVE_WAIT_S)
                if r.status == "ok":
                    ok += 1
                    if not np.array_equal(r.result, golden[k]):
                        raise AssertionError("phase 19 faults: a retried response != golden")
                elif r.status != "quarantined":
                    raise AssertionError(f"phase 19 faults: status {r.status}: {r.error}")
            m = app.metrics.snapshot()
        finally:
            app.stop()
        if not ok or not m["retries"]:
            raise AssertionError(f"phase 19 faults: {ok} ok, {m['retries']} retries")
        failpoints.configure("serve.dispatch=always")
        app = ServeApp(ServeConfig(**{**base, "buckets": ((512, 512),)}, retry_attempts=2,
                                   retry_base_delay_ms=1.0, breaker_threshold=1,
                                   breaker_reset_s=1.0)).start()
        try:
            client = Client(app)
            small = [k for k, img in enumerate(images) if max(img.shape[:2]) <= 512]
            first = client.submit(images[small[0]])
            first.done.wait(SERVE_WAIT_S)
            if first.status != "quarantined" or app.health.state != "degraded":
                raise AssertionError(f"phase 19 faults: {first.status}, {app.health.state}")
            for k in small:
                out = client.process(images[k], timeout=SERVE_WAIT_S)
                if not np.array_equal(out, golden[k]):
                    raise AssertionError("phase 19 faults: a degraded response != golden")
            degraded = app.metrics.snapshot()["degraded"]
            failpoints.clear()
            time.sleep(1.1)
            out = client.process(images[small[0]], timeout=SERVE_WAIT_S)
            if not np.array_equal(out, golden[small[0]]) or app.health.state != "serving":
                raise AssertionError(f"phase 19 faults: probe, health {app.health.state}")
        finally:
            app.stop()
    finally:
        failpoints.clear()
    print(f"phase 19: faults: serve.dispatch=0.3: {ok}/64 ok (all == golden), {m['retries']} "
          f"retries, {m['quarantined']} quarantined; always + breaker 1: quarantined, "
          f"{degraded} degraded responses == golden, probe restored serving ({gpu})")


def phase19_serve(device) -> None:
    """Online serving on the card (module docstring, phase 19)."""
    import shutil

    t0 = time.perf_counter()
    gpu = nvidia_smi()
    tmp = tempfile.mkdtemp(prefix="mcim_serve_")
    try:
        t = time.perf_counter()
        phase19_padded(device, gpu)
        print(f"phase 19: (a) padded executor {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase19_lane(device, gpu)
        print(f"phase 19: (b) lane sweep {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase19_cli(device, gpu, tmp)
        print(f"phase 19: (c) CLI serve {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase19_faults(device, gpu)
        print(f"phase 19: (d) faults {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(tmp)
    print(f"phase 19: online serving, {time.perf_counter() - t0:.1f} s in all")


# --------------------------------------------------------------------------
# phase 20: the pipeline-graph service, the systolic runner, profiling
# --------------------------------------------------------------------------

# (a) an unsharp DAG on the RGB frame: a gaussian tap read twice, a subtract
# and a blend merge, histogram and stats side outputs of the result
GRAPH_UNSHARP = {
    "version": 1,
    "name": "unsharp-blend",
    "nodes": [
        {"id": "src", "kind": "source"},
        {"id": "blur", "kind": "op", "op": "gaussian:5", "input": "src"},
        {"id": "mask", "kind": "merge", "merge": "subtract", "inputs": ["src", "blur"]},
        {"id": "out", "kind": "merge", "merge": "blend", "inputs": ["src", "mask"]},
    ],
    "outputs": {"image": "out", "histogram": "out", "stats": "out"},
}
# the stats mean against float64 by hand: the port's float32 sum of 256
# products in a fixed order, relative tolerance
GRAPH_MEAN_RTOL = 1e-5
# (b) megakernel_ab's chain after its grayscale (a channel-changing op the
# stage mesh refuses, as the JAX package's does), on the 8K gray plane
SYSTOLIC_OPS = "contrast:3.5,gaussian:5,sharpen,quantize:6"
SYSTOLIC_TILE_ROWS = 540
SYSTOLIC_SLOTS = (2, 4)
# (c)/(d) the multi-tenant lane: two tenants on one pipeline, open loop;
# images up to 512 x 512 (PNG decode and encode of each request run on the
# host, under the interpreter lock)
GRAPH_LANE_BUCKETS = ((256, 256), (512, 512))
GRAPH_LANE_IMAGES = 32
GRAPH_LANE_RPS = 64.0
GRAPH_LANE_S = 4.0
GRAPH_LANE_JITTER = 0.5  # each arrival within half a period of its slot, seeded
GRAPH_PROFILE_S = 1.0


def unsharp_golden(x):
    """GRAPH_UNSHARP composed by hand from the golden torch ops and the
    merges' formulas: (image, histogram)."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    blur = Pipeline.parse("gaussian:5")(x)
    mask = (x.int() - blur.int()).clamp(0, 255)  # subtract: clamp(a - b)
    out = torch.round((x.float() + mask.float()) * 0.5).clamp(0, 255).to(torch.uint8)  # blend
    return out, torch.bincount(out.reshape(-1), minlength=256)


def check_graph_outputs(name, out, want_img, want_hist):
    """A graph call's image and histogram byte-equal to the hand-composed
    golden; its stats equal to the image's count/min/max and its float32
    mean within GRAPH_MEAN_RTOL of the float64 mean."""
    import torch

    check_equal(f"{name} image", out["image"], want_img)
    check_equal(f"{name} histogram", out["histogram"].long(), want_hist.long())
    s = out["stats"]
    mean64 = want_img.double().mean().item()
    if (int(s["count"]) != want_img.numel() or int(s["min"]) != int(want_img.min())
            or int(s["max"]) != int(want_img.max())
            or abs(float(s["mean"]) - mean64) > GRAPH_MEAN_RTOL * mean64
            or s["mean"].dtype != torch.float32):
        raise AssertionError(f"{name} stats {dict((k, v.item()) for k, v in s.items())} "
                             f"vs mean {mean64}")


def host_ms(fn, device, reps: int = 5) -> float:
    """Milliseconds of one synchronised call of `fn` on the host clock,
    the median of `reps` (the walker and the stage-mesh runner enqueue
    many small operations: their wall time, not their kernels', is what a
    caller waits for)."""
    import statistics

    import torch

    fn()
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        samples.append((time.perf_counter() - t) * 1e3)
    return statistics.median(samples)


def phase20_graph(device, x8k, gpu: str) -> None:
    """(a) GRAPH_UNSHARP on the 8K RGB frame under impl torch and mxu, equal
    to the golden ops composed by hand (image, histogram, stats); the
    reference chain as a linear DAG equal to Pipeline.jit(backend='cuda')
    byte for byte; no hand kernel launched by the graph path (it runs the
    stage walker, as the JAX package's runs XLA); times beside the chain's
    cuda and torch routes."""
    from mpi_cuda_imagemanipulation_tpu_torch.graph import compile_graph, graph_callable, parse_spec
    from mpi_cuda_imagemanipulation_tpu_torch.graph.spec import chain_as_spec
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck

    width = x8k.shape[1]
    want_img, want_hist = unsharp_golden(x8k)
    times = {}
    for impl in ("torch", "mxu"):
        fn = graph_callable(compile_graph(parse_spec(GRAPH_UNSHARP), backend=impl, width=width,
                                          device=device), impl=impl)
        ck.reset_launch_counts()
        out = fn(x8k)
        launched = {k: v for k, v in ck.launch_counts().items() if v}
        if launched:
            raise AssertionError(f"phase 20 graph {impl}: launched {launched}")
        check_graph_outputs(f"phase 20 graph unsharp {impl}", out, want_img, want_hist)
        times[f"unsharp/{impl}"] = (padded_device_ms(lambda: fn(x8k)),
                                    host_ms(lambda: fn(x8k), device))
        del out
    ref = SPECS["reference"]
    lin = graph_callable(compile_graph(parse_spec(chain_as_spec(ref)), width=width,
                                       device=device))
    ck.reset_launch_counts()
    got = lin(x8k)["image"]
    if any(ck.launch_counts().values()):
        raise AssertionError("phase 20 graph linear DAG launched a kernel")
    cuda = Pipeline.parse(ref).jit("cuda", device=device, plan="off")
    torch_chain = Pipeline.parse(ref).jit("torch", device=device, plan="off")
    ck.reset_launch_counts()
    check_equal("phase 20 graph linear DAG vs Pipeline.jit(cuda)", got, cuda(x8k))
    check_launches = {k: v for k, v in ck.launch_counts().items() if v}
    check_equal("phase 20 graph linear DAG vs torch chain", got, torch_chain(x8k))
    for name, fn in (("linear DAG", lambda: lin(x8k)), ("chain cuda", lambda: cuda(x8k)),
                     ("chain torch", lambda: torch_chain(x8k))):
        times[name] = (padded_device_ms(fn), host_ms(fn, device))
    print(f"phase 20: graph [{GRAPH_UNSHARP['name']}] on the 8K RGB frame under torch and mxu "
          "== the golden ops composed by hand (image, histogram; stats count/min/max exact, "
          f"mean within {GRAPH_MEAN_RTOL:g}); the reference as a linear DAG == "
          f"Pipeline.jit(cuda) (its launches {check_launches}) == the torch chain; no kernel "
          f"launched by the graph path ({gpu})")
    for name, (dev_ms, wall_ms) in times.items():
        print(f"phase 20: graph time {name}: {dev_ms:.4f} ms device (padded CUDA events), "
              f"{wall_ms:.4f} ms host a synchronised call ({gpu})")


def phase20_systolic(device, gray8k, gpu: str) -> None:
    """(b) parallel/systolic.py on 2 and 4 slots of the one card, tile_rows
    540 over the 8K gray plane: the output equal to the unsharded cuda
    route, and the copies that ran equal to one band per stage boundary
    (tiles_forwarded == n_tiles * (n - 1)), beside the unsharded times."""
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
    from mpi_cuda_imagemanipulation_tpu_torch.parallel.systolic import (
        make_stage_mesh,
        systolic_callable,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan

    h, w = gray8k.shape
    cuda = Pipeline.parse(SYSTOLIC_OPS).jit("cuda", device=device, plan="off")
    want = cuda(gray8k)
    plan = build_plan(make_pipeline_ops(SYSTOLIC_OPS), "off")
    rows = []
    for n in SYSTOLIC_SLOTS:
        build = systolic_callable(plan, height=h, width=w, channels=1,
                                  tile_rows=SYSTOLIC_TILE_ROWS,
                                  mesh=make_stage_mesh(n, devices=[device] * n))
        ck.reset_launch_counts()
        out = build.fn(gray8k)
        if any(ck.launch_counts().values()):
            raise AssertionError("phase 20 systolic launched a kernel")
        check_equal(f"phase 20 systolic {n} slots vs Pipeline.jit(cuda)", out, want)
        last = build.last
        if (last.tiles_forwarded != build.n_tiles * (n - 1)
                or (last.tiles_forwarded, last.exchange_bytes, last.n_exchanges)
                != (build.tiles_forwarded, build.exchange_bytes, build.n_exchanges)):
            raise AssertionError(f"phase 20 systolic {n} slots: counts {last} vs {build}")
        rows.append((n, build, padded_device_ms(lambda: build.fn(gray8k), reps=3),
                     host_ms(lambda: build.fn(gray8k), device, reps=3)))
    unsharded = (padded_device_ms(lambda: cuda(gray8k)), host_ms(lambda: cuda(gray8k), device))
    for n, b, dev_ms, wall_ms in rows:
        print(f"phase 20: systolic [{SYSTOLIC_OPS}] 8K gray, {n} slots of one card, tile_rows "
              f"{SYSTOLIC_TILE_ROWS}: == Pipeline.jit(cuda); groups {list(b.ranges)}, "
              f"{b.n_tiles} tiles, {b.n_steps} steps, tiles_forwarded {b.last.tiles_forwarded} "
              f"(= n_tiles x (n - 1)), exchange_bytes {b.last.exchange_bytes}, exchanges "
              f"{b.last.n_exchanges}; {dev_ms:.4f} ms device (padded events), {wall_ms:.4f} "
              f"ms host a call; unsharded cuda {unsharded[0]:.4f} / {unsharded[1]:.4f} ms "
              f"({gpu})")


def phase20_service(device, gpu: str, tmp: str) -> None:
    """(c) a Server with the graph service: two tenants (interactive and
    batch) registering GRAPH_UNSHARP, loadgen.multi_tenant_run at 64 rps
    for 4 s over mixed_shapes, every ok response (image, histogram and
    stats headers) equal to its hand-composed golden, per-tenant ok, shed
    and p99; (d) POST /control/profile under that traffic: device kernel
    events and a DMA share in the summary, a second call inside the
    interval answered 429."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import decode_image_bytes
    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen
    from mpi_cuda_imagemanipulation_tpu_torch.serve.server import ServeConfig, Server

    def post(base, path, body, headers=None):
        req = urllib.request.Request(base + path, data=body, headers=headers or {},
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=SERVE_WAIT_S) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    images = loadgen.mixed_shapes(GRAPH_LANE_BUCKETS, GRAPH_LANE_IMAGES, channels=3, seed=20,
                                  min_dim=3)
    blobs = [loadgen.encode_blob(img) for img in images]
    golden = []
    for img in images:
        want, hist = unsharp_golden(torch.from_numpy(img).to(device))
        golden.append((want.cpu().numpy(), hist.cpu().tolist()))
    os.environ["MCIM_PROFILE_DIR"] = os.path.join(tmp, "profile")
    os.environ["MCIM_PROFILE_MIN_INTERVAL_S"] = "60"
    cfg = ServeConfig(ops=SPECS["reference"], buckets=GRAPH_LANE_BUCKETS, channels=(3,),
                      max_batch=8, max_delay_ms=4.0, queue_depth=256, device=str(device))
    with Server(cfg, host="127.0.0.1", port=0) as srv:
        base = f"http://127.0.0.1:{srv.address[1]}"
        lanes = []
        for tenant, qos in (("interactive", "interactive"), ("bulk", "batch")):
            code, _, out = post(base, "/v1/tenants",
                                json.dumps({"tenant": tenant, "qos": qos}).encode())
            if code != 200:
                raise AssertionError(f"phase 20 tenants: {code} {out[:200]}")
            code, _, out = post(base, "/v1/pipelines",
                                json.dumps({"tenant": tenant, "spec": GRAPH_UNSHARP}).encode())
            if code != 200:
                raise AssertionError(f"phase 20 register: {code} {out[:200]}")
            pid = json.loads(out)["pipeline"]
            lanes.append({"tenant": tenant, "blobs": blobs,
                          "headers": {"X-MCIM-Tenant": tenant, "X-MCIM-Pipeline": pid}})
        profile: dict = {}

        def capture():
            time.sleep(GRAPH_LANE_S / 4)
            profile["first"] = post(base, "/control/profile",
                                    json.dumps({"seconds": GRAPH_PROFILE_S}).encode())
            profile["second"] = post(base, "/control/profile", b"{}")

        t = threading.Thread(target=capture)
        t.start()
        rec = loadgen.multi_tenant_run(base, lanes, GRAPH_LANE_RPS, GRAPH_LANE_S,
                                       timeout_s=SERVE_WAIT_S, jitter_frac=GRAPH_LANE_JITTER,
                                       seed=20)
        t.join(SERVE_WAIT_S)
        svc = srv.app.graph_service
        coalesced = (svc._m_coalesced.value(outcome="batched"),
                     svc._m_coalesced.value(outcome="fallback"))
        sheds = {r: svc._m_shed.value(reason=r) for r in ("quota", "qos", "inflight")}
        disp = svc._m_dispatch_s
        stages = srv.app.registry.get("mcim_engine_stage_seconds")
        st_ms = {st: stages.sum(stage=st) / max(stages.count(stage=st), 1) * 1e3
                 for st in ("h2d", "enqueue", "force", "encode")}
        idle = srv.app.scheduler.engine.metrics.snapshot()
    print(f"phase 20: lane service: graph dispatch mean {disp.sum() / max(disp.count(), 1) * 1e3:.3f}"
          f" ms over {disp.count()} (admission to result on the host), sheds by reason {sheds}, "
          f"group lane batched/fallback {coalesced}; engine mean ms a dispatch "
          + ", ".join(f"{k} {v:.3f}" for k, v in st_ms.items())
          + f"; device_idle_frac {idle.get('device_idle_frac')} ({gpu})")
    checked = 0
    for tenant, r in rec.items():
        if r["unavailable"]:
            raise AssertionError(f"phase 20 lane {tenant}: {r['unavailable']} unavailable")
        for k, res in r["results"]:
            if res["code"] != 200:
                continue
            want, hist = golden[k]
            if not np.array_equal(decode_image_bytes(res["body"]), want):
                raise AssertionError(f"phase 20 lane {tenant}: response {k} != golden")
            checked += 1
        print(f"phase 20: lane tenant {tenant}: submitted {r['submitted']}, ok {r['ok']} (all "
              f"== golden), shed {r['shed']}, ok_frac {r['ok_frac']:.3f}, e2e p50/p99 "
              f"{r.get('e2e_p50_ms', float('nan')):.3f}/{r.get('e2e_p99_ms', float('nan')):.3f} "
              f"ms, achieved {r['achieved_rps']:.3f} rps ({gpu})")
    if not checked:
        raise AssertionError("phase 20 lane: no ok response")
    code, _, body = profile["first"]
    if code != 200:
        raise AssertionError(f"phase 20 profile: {code} {body[:300]}")
    res = json.loads(body)
    summ = res["summary"]
    if res["device_events"] <= 0 or summ["device_compute_us"] <= 0 or summ["device_dma_us"] <= 0:
        raise AssertionError(f"phase 20 profile: no device kernels or copies: {summ}")
    code2 = profile["second"][0]
    if code2 != 429:
        raise AssertionError(f"phase 20 profile: second capture answered {code2}, not 429")
    dma, comp = summ["device_dma_us"], summ["device_compute_us"]
    top = [(e["process"], e["name"][:40], e["total_us"]) for e in summ["top_events"][:6]]
    print(f"phase 20: /control/profile {res['seconds']} s under the lane: {res['device_events']} "
          f"device-trace events, {res['host_events']} host spans; DMA {dma} us / compute "
          f"{comp} us (DMA share {dma / (dma + comp):.3f}); processes {summ['processes']}; "
          f"top {top}; second call 429 ({gpu})")


def phase20_run_profile(device, gpu: str, tmp: str) -> None:
    """(d) `run --profile-dir` on the 8K frame (a PPM: the native codec)
    in-process: the trace holds the card's kernels and copies."""
    from mpi_cuda_imagemanipulation_tpu_torch.cli import main as cli_main
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import save_image, synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.obs import profile as obs_profile

    src = os.path.join(tmp, "frame8k.ppm")
    save_image(src, synthetic_image(MAIN_H, MAIN_W, seed=0))
    prof_dir = os.path.join(tmp, "run_profile")
    rc = cli_main(["run", "--input", src, "--output", os.path.join(tmp, "out8k.ppm"),
                   "--device", str(device), "--impl", "cuda", "--plan", "off",
                   "--profile-dir", prof_dir, "--show-timing"])
    events = obs_profile.load_device_trace(prof_dir)
    kernels = sum(1 for e in events if e.get("cat") in obs_profile.TORCH_COMPUTE_CATS)
    if rc != 0 or not kernels:
        raise AssertionError(f"phase 20 run --profile-dir: exit {rc}, {kernels} kernel events")
    s = obs_profile.summarize(events)
    print(f"phase 20: run --profile-dir on the 8K reference: {os.listdir(prof_dir)}, "
          f"{len(events)} events, {kernels} kernel events; DMA {s['device_dma_us']} us / compute "
          f"{s['device_compute_us']} us ({gpu})")


def phase20_graph_service(device, x8k) -> None:
    """The pipeline-graph service, the systolic runner and profiling on the
    card (module docstring, phase 20)."""
    import shutil

    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    t0 = time.perf_counter()
    gpu = nvidia_smi()
    tmp = tempfile.mkdtemp(prefix="mcim_graph_")
    try:
        t = time.perf_counter()
        phase20_graph(device, x8k, gpu)
        print(f"phase 20: (a) graph {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        gray8k = Pipeline.parse("grayscale").jit("torch", device=device, plan="off")(x8k)
        phase20_systolic(device, gray8k, gpu)
        print(f"phase 20: (b) systolic {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase20_service(device, gpu, tmp)
        phase20_run_profile(device, gpu, tmp)
        print(f"phase 20: (c, d) graph service lane and profiling {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(tmp)
    print(f"phase 20: graph, systolic and profiling, {time.perf_counter() - t0:.1f} s in all")


# --------------------------------------------------------------------------
# phase 21: the serving fabric
# --------------------------------------------------------------------------

FABRIC_BUCKETS = "512,1024,2048,4096"  # serve's default grid
FABRIC_CHANNELS = "1,3"
FABRIC_REPLICAS = 3
# the mixed-shape byte check: 12 images over the whole grid, 16 requests
FABRIC_CHECK_IMAGES = 12
FABRIC_CHECK_RPS = 8.0
FABRIC_CHECK_S = 2.0
# the in-process pod's churn and profile load: images up to 512 x 512
FABRIC_LOAD_BUCKETS = ((256, 256), (512, 512))
FABRIC_LOAD_IMAGES = 32
FABRIC_CHURN_RPS = 64.0
FABRIC_CHURN_S = 1.0
FABRIC_SESSION_OPS = "tdenoise:3,grayscale,contrast:3.5"
FABRIC_SESSION_SHAPE = (480, 640)
FABRIC_SESSION_FRAMES = 8
FABRIC_WAIT_S = 180.0  # JAX's wait_ready timeout
FABRIC_PROFILE_S = 1.0
# the throughput lane, on pods of their own (`fabric --replicas 1` and
# `serve --replicas 3`, each a process group apart from this one) under
# client processes of their own: the JAX package's fabric_loadgen lane
# (bench_suite.fabric_loadgen_params, _FabricProc): its ops, five bucket
# keys to spread sticky affinity, MCIM_FABRIC_SHED_FRAC 0.25, max batch 8,
# 4 ms, queue 256, 24 images, 4 s windows, heartbeat 0.25 s, stale 1 s.
# Its grid (512-2048) is scaled to 128-512 so that the offered bodies stay
# near 0.1 GB/s and the clients' uploads do not set the ceiling.
FABRIC_LANE_OPS = "grayscale,gaussian:5,contrast:3.5"
FABRIC_LANE_BUCKETS = "128,192,256,384,512"
FABRIC_LANE_IMAGES = 24
# offered rates near one replica's ceiling: far past it (8x) one replica
# collapsed (429s, queues of seconds) and the windows drained for tens of s
FABRIC_LANE_RATES = (96.0, 128.0)
FABRIC_LANE_S = 4.0
FABRIC_LANE_GATE_RPS = 48.0  # the 24 images once, every response checked, before timing
FABRIC_LANE_CLIENTS = 3  # load-generator processes, each offering a third
FABRIC_LANE_WORKERS = 128  # request threads a client
FABRIC_LANE_SERVE = ("--ops", FABRIC_LANE_OPS, "--buckets", FABRIC_LANE_BUCKETS, "--channels", "3",
                     "--max-batch", "8", "--max-delay-ms", "4", "--queue-depth", "256")
FABRIC_LANE_ENV = {"MCIM_FABRIC_SHED_FRAC": "0.25", "MCIM_FABRIC_HEARTBEAT_S": "0.25",
                   "MCIM_FABRIC_STALE_S": "1.0"}


def phase21_fabric(device, x8k, rows) -> None:
    """The serving fabric on the card (module docstring, phase 21)."""
    import shutil

    t0 = time.perf_counter()
    gpu = nvidia_smi()
    tmp = tempfile.mkdtemp(prefix="mcim_fabric_")
    try:
        # no calibration record steers plan='auto' (the mesh lane's
        # sharded function resolves it to 'off': K2g, or K1 + K3 under
        # overlap); the replicas inherit the environment at spawn
        with knobs(MCIM_NO_CALIB="1", MCIM_PROFILE_DIR=os.path.join(tmp, "profile"),
                   MCIM_PROFILE_MIN_INTERVAL_S="60"):
            t = time.perf_counter()
            counts = phase21_mesh_lane(device, x8k, gpu)
            print(f"phase 21: (a) mesh lane {time.perf_counter() - t:.1f} s")
            t = time.perf_counter()
            lane = phase21_lane_start(device, tmp)
            try:
                counts["fabric"] = phase21_pod(
                    device, x8k, gpu, after_ready=lambda: phase21_lane_run(lane, gpu))
            finally:
                phase21_lane_stop(lane)
            print(f"phase 21: (b, c) the pods {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase21_rows(device, x8k, counts, rows)
        print(f"phase 21: (d) the mesh lane's kernel rows {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(tmp)
    print(f"phase 21: the serving fabric, {time.perf_counter() - t0:.1f} s in all")


def phase21_mesh_lane(device, x8k, gpu: str) -> dict:
    """(a) `fabric.mesh.MeshLane` on the 8K RGB frame over N_SHARDS slots of
    the card, the reference pipeline under backend 'cuda' and 'torch' in
    both halo modes: each output byte-equal to ``Pipeline.jit(backend=
    'cuda')``, the cuda lanes' launches as `expected_sharded` implies for
    plan 'off' (no record: 'auto' resolves to it), none under torch; the
    host ms of one `process` call (numpy in and out: H2D and D2H included)
    and the device ms of the sharded function on the resident frame.
    Returns the cuda lanes' launches by halo mode."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.fabric.mesh import MeshLane
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.parallel import halo
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    spec = SPECS["reference"]
    img = x8k.cpu().numpy()
    want = Pipeline.parse(spec).jit("cuda", device=device)(x8k)
    counts_by_mode = {}
    for backend in ("torch", "cuda"):
        for mode in HALO_MODES:
            lane = MeshLane(spec, N_SHARDS, halo_mode=mode, backend=backend, device=device)
            lane.process(img)  # first call: allocations, not timed
            ck.reset_launch_counts()
            halo.exchanges.reset()
            t = time.perf_counter()
            out = lane.process(img)
            host_ms = (time.perf_counter() - t) * 1e3
            counts = ck.launch_counts()
            rounds = halo.exchanges.rounds
            tag = f"phase 21: mesh lane backend={backend} halo_mode={mode}"
            check_equal(tag, torch.from_numpy(out).to(device), want)
            used = {k: v for k, v in counts.items() if v}
            expect = ({k: v for k, v in expected_sharded(lane.pipe.ops, "off", mode)[0].items()
                       if v} if backend == "cuda" else {})
            if used != expect:
                raise AssertionError(f"{tag}: launches {used}, expected {expect}")
            dev_ms = device_time_ms(lambda: lane._fn(x8k), reps=5, inner=2)
            if backend == "cuda":
                counts_by_mode[mode] = counts
            print(f"{tag}: {MAIN_H}x{MAIN_W} RGB over {N_SHARDS} slots of {lane.device} == "
                  f"Pipeline.jit('cuda'), launches {used}, {rounds} exchange round(s); "
                  f"process() {host_ms:.3f} ms host clock (numpy in/out, H2D + D2H), sharded "
                  f"function {dev_ms:.4f} ms device ({gpu})")
    return counts_by_mode


def _get_json(url: str, timeout_s: float = 30.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return json.loads(r.read())


def _replica_stats(fab) -> dict:
    """Each routable replica's own /stats, by replica id."""
    return {v.replica_id: _get_json(f"http://127.0.0.1:{v.hb.port}/stats")
            for v in fab.router._routable()}


def _check_responses(tag: str, rec: dict, golden: list) -> int:
    """Every ok response of an HTTP lane record equal to its golden;
    returns how many were checked."""
    import numpy as np

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import decode_image_bytes

    checked = 0
    for k, r in rec["results"]:
        if r["code"] != 200:
            continue
        if not np.array_equal(decode_image_bytes(r["body"]), golden[k]):
            raise AssertionError(f"{tag}: response {k} from {r['replica']} != golden")
        checked += 1
    return checked


def phase21_pod(device, x8k, gpu: str, after_ready=None) -> dict:
    """(b) `Fabric` with FABRIC_REPLICAS replica processes on the card and
    the mesh lane (backend 'cuda', serial, N_SHARDS slots) in the router:
    each replica's seconds from spawn to its first heartbeat and its
    device memory; a mixed-shape load over the whole bucket grid and the
    8K frame through the router, every response byte-equal to
    ``Pipeline.jit(backend='cuda')`` (the 8K one answered by "mesh"), the
    launches of that run; a live session, and the churn run whose kill
    takes the session's replica
    (ok fraction before, during and after, the respawn's seconds, the
    replica_death dump), the session's second half replayed onto a
    survivor, all frames equal to the offline rings + cuda golden; the
    federated /metrics against the sum of the replicas' /fleet/snapshot,
    /slo; one POST /control/profile through the router under load.
    `after_ready` runs last, with this pod idle (the throughput lane on the
    CLI pods, whose start-up overlaps all of the above). Returns the
    launches of the mixed-shape and 8K run."""
    import collections
    import threading
    import urllib.request

    import numpy as np
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.fabric.router import RouterConfig
    from mpi_cuda_imagemanipulation_tpu_torch.fabric.supervisor import Fabric, FabricConfig
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import (
        decode_image_bytes,
        encode_image_bytes,
        synthetic_image,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.obs.metrics import parse_exposition
    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.ops.temporal import split_temporal
    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen
    from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import parse_buckets
    from mpi_cuda_imagemanipulation_tpu_torch.serve.padded import min_true_dim
    from mpi_cuda_imagemanipulation_tpu_torch.stream.video import (
        FrameRings,
        stream_video_session,
    )

    spec = SPECS["reference"]
    pipe = Pipeline.parse(spec)
    golden_fn = pipe.jit("cuda", device=device)

    def golden(img):
        return golden_fn(torch.from_numpy(img).to(device)).cpu().numpy()

    check_imgs = loadgen.mixed_shapes(parse_buckets(FABRIC_BUCKETS), FABRIC_CHECK_IMAGES,
                                      channels=3, seed=21, min_dim=min_true_dim(pipe))
    check_blobs = [encode_image_bytes(im) for im in check_imgs]
    check_gold = [golden(im) for im in check_imgs]
    # the 8K request as PPM (PIL reads it in the router; a PNG encode of
    # the frame costs seconds); the answer comes back as PNG
    blob8k = encode_image_bytes(x8k.cpu().numpy(), format="PPM")
    want8k = golden_fn(x8k).cpu().numpy()
    load_imgs = loadgen.mixed_shapes(FABRIC_LOAD_BUCKETS, FABRIC_LOAD_IMAGES, channels=3,
                                     seed=7, min_dim=min_true_dim(pipe))
    load_blobs = [encode_image_bytes(im) for im in load_imgs]
    load_gold = [golden(im) for im in load_imgs]
    frames = [synthetic_image(*FABRIC_SESSION_SHAPE, channels=3, seed=300 + i)
              for i in range(FABRIC_SESSION_FRAMES)]
    temporal, rest = split_temporal(FABRIC_SESSION_OPS)
    rings = FrameRings(temporal)
    session_fn = Pipeline.parse(rest).jit("cuda", device=device)
    session_gold = [session_fn(torch.from_numpy(rings.push(f)).to(device)).cpu().numpy()
                    for f in frames]

    cfg = FabricConfig(
        replicas=FABRIC_REPLICAS, ops=spec, buckets=FABRIC_BUCKETS, channels=FABRIC_CHANNELS,
        device=str(device), mesh_shards=N_SHARDS, heartbeat_s=0.25,
        router=RouterConfig(buckets=parse_buckets(FABRIC_BUCKETS), stale_s=1.0,
                            forward_attempts=3, breaker_threshold=2, breaker_reset_s=0.5),
        supervisor_backoff_s=0.25,
    )
    fab = Fabric(cfg)
    # the router-side arrival of each incarnation's first heartbeat
    first_beat: dict = {}
    watching = threading.Event()

    def watch():
        while not watching.is_set():
            for v in fab.router.table.views():
                first_beat.setdefault((v.replica_id, v.hb.incarnation), time.monotonic())
            watching.wait(0.02)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    t_start = time.monotonic()
    try:
        fab.start(ready_timeout_s=FABRIC_WAIT_S)
        ready_s = time.monotonic() - t_start
        for v in fab.router.table.views():  # a beat the watcher has not polled yet
            first_beat.setdefault((v.replica_id, v.hb.incarnation), time.monotonic())
        spawned = {rid: m.spawned_at for rid, m in fab.supervisor._managed.items()}
        startup = {rid: round(min(t for (r, _i), t in first_beat.items() if r == rid)
                              - spawned[rid], 3) for rid in spawned}
        print(f"phase 21: pod of {FABRIC_REPLICAS} replicas (buckets {FABRIC_BUCKETS}, channels "
              f"{FABRIC_CHANNELS}, impl torch) + mesh lane ({N_SHARDS} slots, cuda) serving in "
              f"{ready_s:.3f} s; seconds from spawn to first heartbeat by replica {startup} "
              f"({gpu})")
        stats = _replica_stats(fab)
        mem = {rid: {dev: (d["bytes_in_use"], d["peak_bytes_in_use"])
                     for dev, d in s["devmem"].items()} for rid, s in stats.items()}
        print(f"phase 21: device memory by replica after warmup (bytes in use, peak) {mem}; "
              f"functions warmed {[s['cache']['compiled'] for s in stats.values()]} ({gpu})")
        # -- bytes: the mixed-shape load and the 8K frame, launches counted
        ck.reset_launch_counts()
        rec = loadgen.http_run_offered_load(fab.url, check_blobs, FABRIC_CHECK_RPS,
                                            FABRIC_CHECK_S, timeout_s=120.0)
        t = time.perf_counter()
        r8k = loadgen.http_post_image(fab.url, blob8k, timeout_s=120.0)
        t8k = time.perf_counter() - t
        counts = ck.launch_counts()
        checked = _check_responses("phase 21 mixed-shape check", rec, check_gold)
        if checked != rec["submitted"]:
            raise AssertionError(f"phase 21 mixed-shape check: {checked} ok of "
                                 f"{rec['submitted']}: {rec}")
        if r8k["code"] != 200 or r8k["replica"] != "mesh":
            raise AssertionError(f"phase 21 8K via the router: {r8k['code']} from "
                                 f"{r8k['replica']!r}: {r8k['body'][:200]}")
        if not np.array_equal(decode_image_bytes(r8k["body"]), want8k):
            raise AssertionError("phase 21 8K via the mesh lane != Pipeline.jit('cuda')")
        used = {k: v for k, v in counts.items() if v}
        expect = {k: v for k, v in expected_sharded(pipe.ops, "off", "serial")[0].items() if v}
        if used != expect:
            raise AssertionError(f"phase 21 pod run: launches {used}, expected {expect}")
        print(f"phase 21: {checked} mixed-shape responses (every bucket) == Pipeline.jit('cuda') "
              f"from {sorted({r['replica'] for _k, r in rec['results']})}; the 8K frame via "
              f"{r8k['replica']} == golden in {t8k:.3f} s host clock (PPM in, PNG out); launches "
              f"{used} ({gpu})")

        # -- fleet: the federated /metrics against the replicas' snapshots
        # (before any replica dies: a dead incarnation's counters stay
        # banked in the router's view and are in no live snapshot)
        def replica_ok() -> float:
            total = 0.0
            for v in fab.router._routable():
                snap = _get_json(f"http://127.0.0.1:{v.hb.port}/fleet/snapshot")
                for key, val in snap["metrics"]["mcim_serve_requests_total"]["series"]:
                    if key == ["ok"]:
                        total += val
            return total

        deadline = time.monotonic() + 20.0
        while True:
            want_ok = replica_ok()
            fams = parse_exposition(fab.scrape())
            got_ok = sum(v for (_n, labels), v in
                         fams["mcim_serve_requests_total"]["samples"].items()
                         if 'status="ok"' in labels)
            if got_ok == want_ok:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"phase 21 federation: /metrics ok {got_ok} != replicas' "
                                     f"snapshots {want_ok}")
            time.sleep(0.2)
        devmem = {labels: v for (_n, labels), v in
                  fams["mcim_devmem_bytes_in_use"]["samples"].items()}
        peak = {labels: v for (_n, labels), v in
                fams["mcim_devmem_peak_bytes_in_use"]["samples"].items()}
        print(f"phase 21: federated /metrics ok {got_ok:.0f} == sum of the replicas' "
              f"/fleet/snapshot; mcim_devmem_bytes_in_use {devmem}; peak {peak} ({gpu})")

        # -- a live session, then the churn run whose kill takes its replica
        half = FABRIC_SESSION_FRAMES // 2
        first = stream_video_session(frames[:half], fab.url, FABRIC_SESSION_OPS,
                                     session_id="live-21")
        victim = fab.router.sessions.get("live-21").replica_id
        victim_inc = fab.router.table.get(victim).hb.incarnation
        killed: list = []
        second: dict = {}

        def kill():
            killed.append(time.monotonic())
            fab.kill_replica(victim)

        def session_rest_then_ready():
            # the victim is down: the session's next frame fails over
            second.update(stream_video_session(frames[half:], fab.url, FABRIC_SESSION_OPS,
                                               session_id="live-21", start_seq=half))
            # the victim's new incarnation serving (wait_ready alone may
            # still count the dead one's last heartbeat, fresh for stale_s)
            fab._wait_incarnation_change(victim, victim_inc, timeout_s=FABRIC_WAIT_S)
            fab.wait_ready(FABRIC_REPLICAS, timeout_s=FABRIC_WAIT_S)

        restarts0 = fab.supervisor.restarts(victim)
        phases = loadgen.churn_run(fab.url, load_blobs, offered_rps=FABRIC_CHURN_RPS,
                                   phase_s=FABRIC_CHURN_S, kill=kill,
                                   before_after=session_rest_then_ready, timeout_s=60.0)
        if not killed:
            raise AssertionError("phase 21 churn: the kill never fired")
        for name, ph in phases.items():
            n_ok = _check_responses(f"phase 21 churn {name}", ph, load_gold)
            print(f"phase 21: churn {name}: submitted {ph['submitted']}, ok {n_ok} (all == "
                  f"golden), ok_frac {ph['ok_frac']:.4f}, retried {ph['retried']}, shed "
                  f"{ph['shed']}, unavailable {ph['unavailable']}, e2e p99 "
                  f"{ph.get('e2e_p99_ms', float('nan')):.3f} ms ({gpu})")
            if ph["ok_frac"] != 1.0:
                raise AssertionError(f"phase 21 churn {name}: {ph['submitted'] - ph['ok']} of "
                                     f"{ph['submitted']} not ok")
        if fab.supervisor.restarts(victim) <= restarts0:
            raise AssertionError(f"phase 21 churn: {victim} was not restarted")
        back = [t for (r, _i), t in first_beat.items() if r == victim and t > killed[0]]
        if not back:
            raise AssertionError(f"phase 21 churn: no new incarnation of {victim} heartbeated")
        rec_dir = os.environ["MCIM_RECORDER_DIR"]
        dumps = []
        for p in sorted(os.listdir(rec_dir)):
            if p.startswith("recorder_replica_death"):
                with open(os.path.join(rec_dir, p)) as f:
                    dump = json.load(f)
                if dump["extra"].get("replica") == victim:
                    dumps.append((p, dump))
        if not dumps or not dumps[-1][1]["extra"].get("warm_buckets"):
            raise AssertionError(f"phase 21 churn: no replica_death dump naming {victim}'s warm "
                                 f"buckets in {rec_dir}")
        print(f"phase 21: churn killed {victim} (SIGKILL) mid-phase, restarted and heartbeating "
              f"{min(back) - killed[0]:.3f} s after the kill; dump {dumps[-1][0]} names its warm "
              f"buckets {dumps[-1][1]['extra']['warm_buckets']} ({gpu})")
        outs = first["outputs"] + second["outputs"]
        for k, (got, want) in enumerate(zip(outs, session_gold)):
            if not np.array_equal(got, want):
                raise AssertionError(f"phase 21 session frame {k} != offline rings + golden")
        sess = fab.router.sessions.stats()["by_id"]["live-21"]
        if sess["replica"] == victim or sess["failovers"] < 1:
            raise AssertionError(f"phase 21 session: never failed over: {sess}")
        print(f"phase 21: session live-21 ({FABRIC_SESSION_OPS}, {len(outs)} frames "
              f"{FABRIC_SESSION_SHAPE[0]}x{FABRIC_SESSION_SHAPE[1]}) == offline rings + "
              f"Pipeline.jit('cuda') across the kill: replicas {first['replicas']} then "
              f"{second['replicas']}, failovers {sess['failovers']}, retried "
              f"{first['retried'] + second['retried']} ({gpu})")

        slo_view = _get_json(fab.url + "/slo")
        print(f"phase 21: /slo " + json.dumps({
            name: {k: s.get(k) for k in ("alert", "burn_fast", "burn_slow", "good", "total")}
            for name, s in slo_view["slos"].items()}) + f", p99 {slo_view.get('p99')} ({gpu})")
        # -- one profile capture through the router, under load, on the
        # replica that served most of the churn run's last phase (the
        # load's sticky target: the router's default, the least loaded
        # replica, may see none of it)
        hot = collections.Counter(r["replica"] for _k, r in phases["after"]["results"]
                                  if r["code"] == 200).most_common(1)[0][0]
        req = urllib.request.Request(fab.url + "/control/profile",
                                     data=json.dumps({"seconds": FABRIC_PROFILE_S,
                                                      "replica": hot}).encode(),
                                     method="POST")
        loader = threading.Thread(target=loadgen.http_run_offered_load,
                                  args=(fab.url, load_blobs, FABRIC_CHURN_RPS, 2.0))
        loader.start()
        try:
            with urllib.request.urlopen(req, timeout=60.0) as r:
                prof = json.loads(r.read())
        finally:
            loader.join(120.0)
        summ = prof["summary"]
        if prof["device_events"] <= 0 or summ["device_compute_us"] <= 0:
            raise AssertionError(f"phase 21 profile via the router: no device kernels: {prof}")
        print(f"phase 21: POST /control/profile via the router -> {prof.get('replica')}: "
              f"{prof['device_events']} device events, compute {summ['device_compute_us']:.1f} "
              f"us, DMA {summ.get('device_dma_us', 0.0):.1f} us ({gpu})")
        if after_ready is not None:
            after_ready()
    finally:
        watching.set()
        fab.close(drain=True)
    return counts


def _cli_pod(command: str, replicas: int, device) -> dict:
    """``python -m mpi_cuda_imagemanipulation_tpu_torch <command> --replicas
    N`` on a free port with the throughput lane's settings, in its own
    process group (so that on a failure here the replicas it spawned go
    down with it); a reader thread watches its log for the pod's "fabric
    serving" line."""
    import re
    import socket
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, **FABRIC_LANE_ENV}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pod = {"command": command, "replicas": replicas, "url": f"http://127.0.0.1:{port}",
           "lines": [], "up": threading.Event(), "t0": time.perf_counter()}
    pod["proc"] = subprocess.Popen(
        [sys.executable, "-m", "mpi_cuda_imagemanipulation_tpu_torch", command, "--replicas",
         str(replicas), "--host", "127.0.0.1", "--port", str(port), "--device", str(device),
         *FABRIC_LANE_SERVE],
        cwd=root, env=env, stderr=subprocess.PIPE, text=True, start_new_session=True,
    )

    def read():
        for line in pod["proc"].stderr:
            pod["lines"].append(line)
            if re.search(r"fabric serving \[.*\] on ", line):
                pod["t_up"] = time.perf_counter() - pod["t0"]
                pod["up"].set()

    pod["reader"] = threading.Thread(target=read, daemon=True)
    pod["reader"].start()
    return pod


def phase21_lane_start(device, tmp: str) -> dict:
    """(c) The throughput lane's pods, `fabric --replicas 1` and `serve
    --replicas 3` (the CLI hands it to `cmd_fabric`), and
    FABRIC_LANE_CLIENTS load-generator processes (``chip_smoke.py
    --fabric-client``) holding the lane's PNG blobs and their goldens
    (``Pipeline.jit(backend='cuda')``), all started beside (b)'s pod so
    that the start-ups overlap."""
    import pickle

    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import encode_image_bytes
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen
    from mpi_cuda_imagemanipulation_tpu_torch.serve.bucketing import parse_buckets
    from mpi_cuda_imagemanipulation_tpu_torch.serve.padded import min_true_dim

    lane = {"pods": {}, "clients": []}
    for command, n in (("fabric", 1), ("serve", FABRIC_REPLICAS)):
        lane["pods"][n] = _cli_pod(command, n, device)
    pipe = Pipeline.parse(FABRIC_LANE_OPS)
    imgs = loadgen.mixed_shapes(parse_buckets(FABRIC_LANE_BUCKETS), FABRIC_LANE_IMAGES,
                                channels=3, seed=7, min_dim=min_true_dim(pipe))
    fn = pipe.jit("cuda", device=device)
    golden = [fn(torch.from_numpy(im).to(device)).cpu().numpy() for im in imgs]
    blobs = [encode_image_bytes(im) for im in imgs]
    lane["mbytes"] = sum(len(b) for b in blobs) / len(blobs) / 1e6
    data = os.path.join(tmp, "lane.pkl")
    with open(data, "wb") as f:
        pickle.dump((blobs, golden), f)
    root = os.path.dirname(os.path.abspath(__file__))
    for _ in range(FABRIC_LANE_CLIENTS):
        lane["clients"].append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--fabric-client", data], cwd=root,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, start_new_session=True))
    return lane


def _client_line(p) -> dict:
    line = p.stdout.readline()
    if not line:
        raise RuntimeError(f"phase 21 lane: client {p.pid} exited with {p.wait(10)}")
    msg = json.loads(line)
    if "error" in msg:
        raise AssertionError(f"phase 21 lane: client {p.pid}: {msg['error']}")
    return msg


def _fresh_replicas(pod: dict) -> dict:
    return {rid: r for rid, r in _get_json(pod["url"] + "/stats")["replicas"].items()
            if r["fresh"] and r["state"] in ("serving", "degraded")}


def _proc_cpu_s(pid: int) -> float:
    """User + system CPU seconds of a process, from /proc/<pid>/stat."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _engine_idle_s(stats: dict) -> float:
    """A replica engine's idle seconds so far, the wait in progress
    included, from its /stats."""
    return stats["engine"]["idle_s"] + stats["engine"]["idle_open_s"]


def _lane_window(clients: list, pod: dict, rps: float, duration_s: float, tag: str,
                 gpu: str | None = None) -> dict:
    """One open-loop window of the lane at `rps` against `pod`, split
    evenly over `clients` that start together, each on its own rotation
    of the images: every ok response byte-equal to its golden (checked in
    the client). With `gpu`, printed with its readings over the bracket
    from before the clients start to after the last response (their 0.2 s
    lead and the drain included): the card's idle share (1 - mean
    nvidia-smi utilization.gpu), each replica engine's idle share (raw:
    outside [0, 1] the accounting is wrong, and it raises), and the CPU
    cores used by the pod's router process, each replica process and the
    clients."""
    import collections
    import threading

    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen

    reps = _fresh_replicas(pod)
    pids = {"router": pod["proc"].pid, **{rid: r["pid"] for rid, r in reps.items()}}
    util: list = []
    done = threading.Event()

    def sample():
        while not done.wait(0.25):
            util.append(gpu_utilization())

    sampler = threading.Thread(target=sample, daemon=True)
    if gpu is not None:
        sampler.start()
    t0 = time.monotonic()
    cpu0 = {k: _proc_cpu_s(pid) for k, pid in pids.items()}
    st0 = {rid: _get_json(f"http://{r['addr']}:{r['port']}/stats") for rid, r in reps.items()}
    start_at = time.monotonic() + 0.2
    for j, p in enumerate(clients):
        p.stdin.write(json.dumps({
            "url": pod["url"], "rps": rps / len(clients), "duration_s": duration_s,
            "start_at": start_at, "offset": j * FABRIC_LANE_IMAGES // len(clients),
            "max_workers": FABRIC_LANE_WORKERS}) + "\n")
        p.stdin.flush()
    ends = [_client_line(p) for p in clients]
    st1 = {rid: _get_json(f"http://{r['addr']}:{r['port']}/stats") for rid, r in reps.items()}
    cpu1 = {k: _proc_cpu_s(pid) for k, pid in pids.items()}
    window = time.monotonic() - t0
    done.set()
    outs = [_client_line(p) for p in clients]
    results = [(k, {"code": code, "replica": rep, "attempts": att, "retry_after": ra, "e2e_s": e})
               for o in outs for k, code, rep, att, ra, e in o["results"]]
    rec = loadgen.summarize_http_results(results, max(e["wall_s"] for e in ends), rps)
    checked = sum(o["checked"] for o in outs)
    if rec["unavailable"] or not rec["ok"] or checked != rec["ok"]:
        raise AssertionError(f"phase 21 lane {tag}: {rec['unavailable']} unavailable, "
                             f"{rec['ok']} ok, {checked} checked")
    if gpu is None:
        return rec
    sampler.join()
    idle, inside = {}, {}
    for rid in reps:
        share = (_engine_idle_s(st1[rid]) - _engine_idle_s(st0[rid])) / window
        if not -1e-6 <= share <= 1.0 + 1e-6:
            raise AssertionError(f"phase 21 lane {tag}: replica {rid}'s engine idle share "
                                 f"{share} lies outside [0, 1]")
        idle[rid] = round(share, 4)
        a, b = st0[rid], st1[rid]
        inside[rid] = {
            "dispatches": b["dispatches"] - a["dispatches"],
            "completed": b["completed"] - a["completed"],
            "occupancy": round((b["completed"] - a["completed"])
                               / max(b["dispatches"] - a["dispatches"], 1), 3),
            **{f"{k}_p50_ms": round((b[k] or {}).get("p50_ms", float("nan")), 3)
               for k in ("queue_wait", "device_per_dispatch", "e2e_latency")},
        }
    cores = {k: round((cpu1[k] - cpu0[k]) / window, 3) for k in pids}
    cores["clients"] = round(sum(e["cpu_s"] for e in ends) / window, 3)
    util = [u for u in util if u is not None]
    card_idle = round(1.0 - sum(util) / len(util) / 100.0, 4) if util else None
    by_replica = dict(sorted(collections.Counter(
        r["replica"] or "direct" for _k, r in results if r["code"] == 200).items()))
    print(f"phase 21: lane {tag} offered {rps:.0f} rps x {duration_s} s from {len(clients)} "
          f"client processes: submitted {rec['submitted']}, ok {rec['ok']} (all == golden), "
          f"shed {rec['shed']}, overloaded {rec['overloaded']}, retried {rec['retried']}, e2e "
          f"p50/p99 {rec.get('e2e_p50_ms', float('nan')):.3f}/"
          f"{rec.get('e2e_p99_ms', float('nan')):.3f} ms, achieved {rec['achieved_rps']:.3f} "
          f"rps (ok over {rec['wall_s']:.3f} s, the drain included); ok by replica "
          f"{by_replica}; over the {window:.3f} s bracket: card idle share {card_idle} (1 - "
          f"mean nvidia-smi utilization.gpu, {len(util)} samples), engine idle share by "
          f"replica {idle}, CPU cores by process {cores}; inside each replica (its /stats: "
          f"dispatches and requests over the bracket, p50s of its recent samples) {inside} "
          f"({gpu})")
    rec.update(cores=cores, engine_idle=idle, card_idle=card_idle, by_replica=by_replica)
    return rec


def phase21_lane_run(lane: dict, gpu: str) -> None:
    """(c) Once (b)'s pod is done, with it idle: the clients ready; both CLI
    pods up (seconds from spawn to their "fabric serving" line, every
    replica fresh in /stats); for each, the 24 images once (every response
    checked, untimed), then each of FABRIC_LANE_RATES for FABRIC_LANE_S
    from the clients, the pods in turn (1, 3 at the first rate, 3, 1 at the
    next); the ratio of the best achieved rps of 3 replicas to 1. Then
    SIGTERM drains each pod to exit 0."""
    import signal

    clients = lane["clients"]
    for p in clients:
        if not _client_line(p).get("ready"):
            raise AssertionError(f"phase 21 lane: client {p.pid} not ready")
    for n, pod in sorted(lane["pods"].items()):
        if not pod["up"].wait(FABRIC_WAIT_S):
            raise AssertionError(f"phase 21 {pod['command']} --replicas {n}: not up:\n"
                                 + "".join(pod["lines"][-20:]))
        deadline = time.monotonic() + 30.0
        while len(_fresh_replicas(pod)) != n:
            if time.monotonic() > deadline:
                raise AssertionError(f"phase 21 {pod['command']} --replicas {n}: replicas "
                                     f"{_get_json(pod['url'] + '/stats')['replicas']}")
            time.sleep(0.1)
        print(f"phase 21: {pod['command']} --replicas {n} (ops {FABRIC_LANE_OPS}, buckets "
              f"{FABRIC_LANE_BUCKETS}, channels 3, {FABRIC_LANE_ENV}) serving {pod['t_up']:.3f} "
              f"s after its spawn (beside (b)'s pod), every replica fresh ({gpu})")
    for n, pod in sorted(lane["pods"].items()):
        _lane_window(clients[:1], pod, FABRIC_LANE_GATE_RPS,
                     FABRIC_LANE_IMAGES / FABRIC_LANE_GATE_RPS, f"{n} gate")
    best = {n: 0.0 for n in lane["pods"]}
    for i, rps in enumerate(FABRIC_LANE_RATES):
        for n in sorted(lane["pods"], reverse=bool(i % 2)):
            pod = lane["pods"][n]
            rec = _lane_window(clients, pod, rps, FABRIC_LANE_S,
                               f"{n} replica(s) via the router", gpu)
            best[n] = max(best[n], rec["achieved_rps"])
    a1, a3 = best[1], best[FABRIC_REPLICAS]
    print(f"phase 21: lane {FABRIC_REPLICAS} replicas / 1 replica = {a3 / a1:.3f} (the best "
          f"achieved rps of each, {a3:.3f} / {a1:.3f}; {lane['mbytes']:.4f} MB a request body; "
          f"{os.cpu_count()} CPU cores on the host) ({gpu})")
    for pod in lane["pods"].values():
        pod["proc"].send_signal(signal.SIGTERM)
    for n, pod in sorted(lane["pods"].items()):
        p = pod["proc"]
        rc = p.wait(timeout=90)
        pod["reader"].join(10)
        if rc != 0:
            raise AssertionError(f"phase 21 {pod['command']} --replicas {n}: exit {rc}:\n"
                                 + "".join(pod["lines"][-20:]))
        print(f"phase 21: {pod['command']} --replicas {n}: SIGTERM, exit 0 after "
              f"{time.perf_counter() - pod['t0']:.3f} s in all")


def phase21_lane_stop(lane: dict) -> None:
    """Whatever is left of the lane's clients and pods (nothing of the pods
    after a clean drain)."""
    import signal

    for p in lane["clients"]:
        with contextlib.suppress(OSError):
            p.stdin.close()
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    for pod in lane["pods"].values():
        with contextlib.suppress(ProcessLookupError):
            os.killpg(pod["proc"].pid, signal.SIGKILL)
        pod["proc"].wait()


def fabric_client(data_path: str) -> int:
    """``chip_smoke.py --fabric-client DATA``: one load-generator process
    of phase 21's throughput lane. DATA holds the lane's blobs and their
    goldens. It reads one JSON command a line on stdin (url, rps,
    duration_s, start_at on the monotonic clock, offset, max_workers),
    runs that open-loop window from `start_at` on its rotation of the
    blobs, and answers with two lines: its wall and CPU seconds as soon as
    the last response is in, then each request's (image, code, replica,
    attempts, retry-after, e2e seconds) after it has checked every ok
    response against its golden. It needs no card."""
    import pickle

    import numpy as np

    from mpi_cuda_imagemanipulation_tpu_torch.io.image import decode_image_bytes
    from mpi_cuda_imagemanipulation_tpu_torch.serve import loadgen

    def say(msg: dict) -> None:
        sys.stdout.write(json.dumps(msg) + "\n")
        sys.stdout.flush()

    try:
        with open(data_path, "rb") as f:
            blobs, golden = pickle.load(f)
        say({"ready": True})
        for line in sys.stdin:
            cmd = json.loads(line)
            n, off = len(blobs), cmd["offset"]
            mine = blobs[off:] + blobs[:off]
            time.sleep(max(cmd["start_at"] - time.monotonic(), 0.0))
            c0 = os.times()
            rec = loadgen.http_run_offered_load(cmd["url"], mine, cmd["rps"], cmd["duration_s"],
                                                timeout_s=60.0, max_workers=cmd["max_workers"])
            c1 = os.times()
            say({"wall_s": rec["wall_s"],
                 "cpu_s": (c1.user + c1.system) - (c0.user + c0.system)})
            out, checked = [], 0
            for k, r in rec["results"]:
                k = (k + off) % n
                if r["code"] == 200:
                    if not np.array_equal(decode_image_bytes(r["body"]), golden[k]):
                        raise AssertionError(f"response for image {k} from {r['replica']!r} "
                                             f"!= golden")
                    checked += 1
                out.append([k, r["code"], r["replica"], r["attempts"], r["retry_after"],
                            r["e2e_s"]])
            say({"checked": checked, "results": out})
    except Exception as e:  # noqa: BLE001 - reported to the parent, which raises
        say({"error": f"{type(e).__name__}: {e}"})
        return 1
    return 0


def phase21_rows(device, x8k, counts, rows) -> None:
    """(d) The `kernels` rows of the mesh lane's launches: K2g on the
    reference group over a middle 1080 x 7680 shard (the fabric's 8K run,
    serial), and under overlap K1 on the shard's prologue and K3 on the
    gray interior and one boundary band; each against its plain version,
    CUDA-event times, the bound from bytes and operations."""
    import torch

    from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
    from mpi_cuda_imagemanipulation_tpu_torch.utils.timing import device_time_ms

    k1 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/pointwise.cu"
    k2 = "mpi_cuda_imagemanipulation_tpu_torch/ops/csrc/stream_stencil.cu"
    pk = "mpi_cuda_imagemanipulation_tpu/ops/pallas_kernels.py"
    local_h = MAIN_H // N_SHARDS
    y0 = local_h  # the second of four shards: neither edge
    pw, st = split_group(SPECS["reference"])
    h = st.halo
    tile = x8k[y0:y0 + local_h].contiguous()
    top, bottom = x8k[y0 - h:y0].contiguous(), x8k[y0 + local_h:y0 + local_h + h].contiguous()
    gray = ck.pointwise_group(pw, tile)
    band = torch.cat([ck.pointwise_group(pw, top), gray[:2 * h]]).contiguous()

    def record(name, source, replaces, launches, fn, plain, c_in, c_out, ops, n_pix,
               strip_bytes=0, library=None):
        got, want = fn(), plain()
        err = int((got.int() - want.int()).abs().max().item())
        if err:
            raise AssertionError(f"{name}: kernel != plain, max abs err {err}")
        if not launches:
            raise AssertionError(f"{name}: the fabric's paths never launched it")
        ms = device_time_ms(fn, reps=7)
        plain_ms = device_time_ms(plain, reps=3, inner=2)
        library_ms = device_time_ms(library, reps=7) if library is not None else None
        bound_ms, bound_by = bound((c_in + c_out) * n_pix + strip_bytes,
                                   op_count(ops, n_pix, c_in))
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        })
        print(f"kernel {name}: {ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({bound_ms / ms:.1%}), plain {plain_ms:.4f} ms, library {library_ms}, "
              f"launches {launches}")

    kw = dict(y0=y0, image_h=MAIN_H, image_w=MAIN_W)
    names = ",".join(op.name for op in pw + [st])
    record(f"K2g stream_stencil_ghost [{names}] fabric mesh lane", k2, f"{pk}:377",
           counts["fabric"]["K2g"], lambda: ck.stream_stencil_ghost(pw, st, tile, top, bottom, **kw),
           lambda: ck.stream_stencil_ghost_plain(pw, st, tile, top, bottom, **kw),
           3, 1, pw + [st], local_h * MAIN_W, strip_bytes=2 * h * MAIN_W * 3)
    record(f"K1 pointwise_group [{','.join(op.name for op in pw)}] mesh lane overlap", k1,
           f"{pk}:540", counts["overlap"]["K1"], lambda: ck.pointwise_group(pw, tile),
           lambda: ck.pointwise_group_plain(pw, tile), 3, 1, pw, local_h * MAIN_W)
    record(f"K3 stencil_tile [{st.name}] gray mesh lane overlap interior", k2, f"{pk}:787",
           counts["overlap"]["K3"], lambda: ck.stencil_tile(st, gray),
           lambda: ck.stencil_tile_plain(st, gray), 1, 1, [st], (local_h - 2 * h) * MAIN_W,
           strip_bytes=2 * h * MAIN_W, library=conv_library(st, gray, pad_rows=False))
    record(f"K3 stencil_tile [{st.name}] gray mesh lane overlap band", k2, f"{pk}:787",
           counts["overlap"]["K3"], lambda: ck.stencil_tile(st, band),
           lambda: ck.stencil_tile_plain(st, band), 1, 1, [st], h * MAIN_W,
           strip_bytes=2 * h * MAIN_W, library=conv_library(st, band, pad_rows=False))


def ptxas_summary(name: str, lines: list[str]) -> str:
    """One line of a source's `-Xptxas -v` report: its kernel
    instantiations, the most registers one uses and the spilled bytes
    (stores and loads) of all of them."""
    entries = ptxas_entries(lines)
    return (f"ptxas {name}: {len(entries)} kernel instantiations, at most "
            f"{max((r for _, r, _ in entries), default=0)} registers, "
            f"{sum(s for _, _, s in entries)} bytes spilled in all")


def ptxas_entries(lines: list[str]) -> list[tuple[str, int, int]]:
    """(kernel, registers, spilled bytes) of each instantiation in a
    source's `-Xptxas -v` report."""
    import re

    out, name, spill = [], None, 0
    for line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def sass_loops(lib_path, function: str) -> list[dict]:
    """The loops of the kernels whose names hold `function` in a built
    library's SASS (`cuobjdump -sass`): one dict per backward branch, with
    the kernel, the loop's instruction count and the count of each opcode
    in it (its name before the first dot). [] where cuobjdump is missing."""
    import collections
    import os
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return []
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120).stdout
    loops = []
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = chunk.split("\n", 1)
        if function not in name:
            continue
        ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]
        for addr, op, rest in ins:
            m = re.match(r"\s*(0x[0-9a-f]+)", rest)
            if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
                body_ops = [o for a, o, _ in ins if int(m.group(1), 16) <= a <= addr]
                loops.append({"kernel": name.strip(), "instructions": len(body_ops),
                              "opcodes": dict(collections.Counter(
                                  o.split(".")[0] for o in body_ops).most_common())})
    return loops


def t3_build_summary() -> str:
    """T3's instantiations from its build log (registers, spilled bytes;
    raises if one spills) and the loops of their SASS."""
    from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels

    path = kernels.library_path("swar_proto")
    entries = ptxas_entries(path.with_suffix(".log").read_text().splitlines())
    spilled = [e for e in entries if e[2]]
    if spilled:
        raise AssertionError(f"T3 spills: {spilled}")
    loops = sass_loops(path, "swar_proto_kernel")
    return ("; ".join(f"{n} {r} registers, {s} bytes spilled" for n, r, s in entries)
            + "; SASS loops: " + (json.dumps(loops) if loops else "not measured (no cuobjdump)"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA device", file=sys.stderr)
        return 1
    from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
    from mpi_cuda_imagemanipulation_tpu_torch.runtime import build as native_build
    from mpi_cuda_imagemanipulation_tpu_torch.runtime import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # phases 1-4 run with an empty calibration store wherever the script
    # runs: a store file in the working directory must not steer them
    os.environ["MCIM_CALIB_FILE"] = os.path.join(tempfile.mkdtemp(prefix="mcim_"), "none.json")
    # flight-recorder dumps land in a temporary directory, never in the tree
    os.environ["MCIM_RECORDER_DIR"] = tempfile.mkdtemp(prefix="mcim_recorder_")
    device = torch.device("cuda")
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    paths = kernels.build()
    print(f"build: {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    codec_lib = native_build.build()
    if codec_lib is None:
        raise RuntimeError("the native codec did not build (runtime/build.py: make and g++)")
    print(f"build: native codec {codec_lib} in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        for line in lines:
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
        print(ptxas_summary(name, lines))

    phase1(device)
    phase1_k5(device)
    phase1_reference(device)
    x8k = torch.from_numpy(synthetic_image(MAIN_H, MAIN_W, seed=0)).to(device)
    phase1_k5_main(device, x8k)
    phase1_k5_sums(device, x8k)
    phase1_k5_redesign(device)
    gray8k = Pipeline.parse("grayscale").jit("torch", device=device, plan="off")(x8k)
    phase1_swar(device, gray8k)
    phase1_swar_redesign(device)
    phase1_tools(device, gray8k)
    phase1_t1(device, gray8k, x8k)
    phase1_t1_redesign(device)
    launches = phase2(device, x8k)
    sharded_launches = phase2_sharded(device, x8k)
    phase2_long_stages(device)
    mxu_launches = phase2_mxu(device, x8k)
    swar_launches = phase2_swar(device, x8k, gray8k)
    tool_runs = phase2_tools(device)
    tool_runs["t1_ghost"] = (phase2_t1_ghost(device, gray8k), [])
    rows = phase3(device, x8k, launches, sharded_launches, mxu_launches, gray8k, swar_launches,
                  tool_runs)
    phase4_registry(device, x8k, gray8k)
    store = phase5_auto(device, x8k)
    phase6_soak(device)
    phase7_trace(device, x8k)
    phase8_recorder(device)
    phase9_online(device, x8k, store)
    phase10_batched_kernels(device)
    phase11_batched_paths(device, rows, store)
    phase12_data_parallel(device)
    phase13_2d(device, x8k)
    phase14_guard(device, x8k)
    phase15_t1_batched(device, rows)
    phase16_engine(device)
    phase17_batch_cli(device)
    phase18_stream(device)
    phase19_serve(device)
    phase20_graph_service(device, x8k)
    phase21_fabric(device, x8k, rows)
    torch.cuda.synchronize()

    print(f"gpu: {nvidia_smi()}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fabric-client"]:
        sys.exit(fabric_client(sys.argv[2]))
    sys.exit(main())
