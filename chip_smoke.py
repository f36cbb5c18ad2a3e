"""Drive gstk_torch's render, train, eval and export paths, its three
methods, the raytraced data, mono co-gs, the live viewer, data processing,
the parallel paths, the quality workflow, the reference's published
quality configurations and its benchmark, profiling and preflight tools on
one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero before the last
line:
  1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off
     for matmul and cuDNN in this process (the package's convolutions run
     in f32 either way; phase 13's subprocess keeps PyTorch's defaults);
  2. build: compile the CUDA kernels (``gstk_torch/csrc``) for sm_90a and
     print nvcc's register / shared-memory / spill report and the resident
     CTAs per SM of K1 and K2 (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
  3. scene: the render scene of ``bench.py`` (100k Gaussians, capacity
     104*1024, SH degree 3, 800x800, fx = fy = 1111) from a torch
     generator, written as a gstk_tpu-layout checkpoint;
  4. kernel K3 (segment broadcast) against its plain twin on the scene's
     tile-count cumsum, 1 and 3 columns, length 2**20, and edge cases (a
     long tail past the last boundary, a run of equal boundaries wider than
     a CTA's run): exact equality;
  5. kernel K1 (tile compositing) against its plain twin on the scene's
     intersections at ch = 4: rtol 1e-3 / atol 1e-4;
  6. render path: ``Renderer(checkpoint, device="cuda")`` answers 8 requests
     (the bench camera and 7 pose offsets) with the launch counters reset
     just before; request 0 is compared with the same render through the
     plain twins on the card;
  7. K1 and K3 timings at the render shapes (K1 given the packed record, as
     the render path gives it), the device time of ``pack_records`` and of
     a fill of K3's output (a floor for its bytes);
     kernel times are torch.profiler's mean over the launches it recorded,
     printed with that count and the total over the calls made;
  8. train scene: ``bench.py``'s training point (the phase-3 scene,
     ``isect_capacity`` 3<<18, black background, default optimizer, a
     uniform gt image from the seed-0 generator), no truncation; the tile
     range lengths (mean, p99, max);
  9. kernels K2 (compositing backward) and K4 (segment sum) against their
     plain twins on the scene's intersections and the cotangents of the
     step's loss (K2 rtol 5e-3 / atol 1e-4 max|g| per column, and again with
     a random final_t cotangent; K4 rtol 1e-5 / atol 1e-6 of each segment's
     sum of magnitudes); K2 -> gather -> K4 twice must be bit-identical;
     the segment lengths K4 sums (mean, p99, max, empty, longer than a
     thread sums alone) and the device time of the gather by expansion
     position and of an attribute-major copy of its result;
     the (tile, warp, entry) triples with a kept pixel, from the plain
     walk, for warps of 32 pixels (one pixel a thread) and
     of 64 (two a thread, as K2's), and the time their warp shuffles
     take at 5 (6 + ch) and at 16 shuffles each;
  10. train path: one step through the kernels, with the launch counters
     reset just before, against the same step with ``backend="plain"``
     from the same state (loss, gradients, updates, statistics, with the
     CPU step test's tolerances); then 2 warm-up and 10 timed steps (host
     clock, synchronized), one traced step (its cat launches listed), and
     K2 / K4 / ``pack_records`` timings, with one ``torch.sum`` over the
     values K4 covers (a floor for its bytes); ``refine`` on this state
     (capacity 104*1024, 100k alive) at a densifying step, synchronized;
     the launch counters here and in the later phases that reset them
     count the projection kernels PF and PB too (phase 6 counts PF);
  10b. the projection kernels PF and PB (``ops/project_cuda.py``) at the
     30k operating point's lanes (2^21, 1.76M alive, SH degree 3, drawn on
     the card), 800x800, antialiased, against ``splat_inputs_plain`` on the
     same inputs: float outputs rtol 1e-5 / atol 1e-6, radii and tile
     counts equal on all but 0.001% of lanes and never more than 1 apart,
     the six gradients and the view matrices' against the plain path in
     f64 as ``tests/test_torch_gpu.py`` judges them, PF and PB once each;
     both timed beside the plain forward and its backward alone, their
     bytes at the HBM's rate the bound in the ``kernels`` line;
  10c. the Adam kernel AF (``train/adam_cuda.py``) at the same 2^21 lanes
     (SH degree 3, a tenth dead with NaN gradients) against
     ``adam_step_plain`` on copies of one state: parameters, moments and
     count bit for bit after a step at steps 0, 12,093 and 29,998 (the
     count equal to the step: the largest bias corrections, then across
     the means decay's end), with a norm clip through ``adam_step`` at
     12,093, and for the camera group (37 cameras, CameraOptConfig's
     decay) from counts 1 and 29,998 at step 29,998; one launch a call;
     AF timed beside the plain step, 28 B an element of its 59 a lane at
     the HBM's rate the bound in the ``kernels`` line. Phase 10's step and
     the later phases that reset the counters count AF too, once an Adam
     state a step;
  11. trainer path: the port's synthetic-dataset generator writes 24 views
     at 800x800 of its 500-point object on the card, the dataset's seed
     cloud is rewritten with 100k points drawn around the object's, and
     ``gstk_torch.scripts.train.main`` trains gaussian-splatting on it for
     400 steps in this process (every step at 800x800, SH degree 3 from
     step 300, refinement densifying at steps 200-400, one eval view every
     100 steps), with the launch counters reset just before; K1-K4 must
     each launch, the losses stay finite, ``num_alive`` change, the final
     eval PSNR beat the first ``eval_image`` PSNR (step 99), the final
     checkpoint render an eval view through ``Renderer(..., device="cuda")``
     as the trainer renders it, one trainer step from the trained state
     and one eval render match the same through the plain twins (phase
     10's and phase 6's tolerances), ``refine`` on the card equal
     ``refine`` on the CPU from the same state and noise, and Pillow,
     OpenCV and PyYAML stay unimported; prints the trainer's per-step wall
     time (its ``ITER_TRAIN_TIME``, and 20 more steps synchronized),
     ``refine`` at the trained capacity, ``eval_all`` per view, each
     capacity growth up to the 2^21 ceiling (forced after the run) and
     ``refine`` at that ceiling, synchronized; then the d = 4 bucket of the
     train split (the default coarse-to-fine start) is built with the
     device peak measured, which must stay under the bytes the trainer's
     budget check counts, and must equal the per-frame path bit for bit;
     and ``read_png`` reads an 800x800 Paeth-filtered PNG built here with
     numpy and zlib, bit-exact and timed;
  12. probes: with the probes' launch counters reset just before, the
     entry points ``gstk_torch.tools.ablate_fwd.main`` (P1: K1's ablation
     clones at the tool's two shapes, T=2048/C=1 and T=128/C=16) and
     ``gstk_torch.tools.bench_dynrow.main`` (P2 and P3: row scatters at
     n = 2^20 rows against their plain twins and ``index_copy_`` bit for
     bit, beside the gather baseline) each launch; then every P1 clone
     against its plain twin at both shapes (rtol 1e-3 / atol 1e-4,
     ``dmaonly`` rtol 1e-6), ``full`` and ``marg_none`` against K1 and
     ``noexit`` against ``full`` bit for bit, and ``full``, ``noexit`` and
     ``dmaonly`` timed on phase 7's render inputs beside K1;
  13. back end, on phase 11's run directory (its step-400 checkpoint),
     through the CLIs' ``main``: gs-eval (``--skip-lpips``) launches K1 and
     K3 once a view and equals the trainer's final eval (PSNR rtol 1e-4,
     SSIM atol 1e-4), as do ``--force-host-loop`` and a fresh ``python -m
     gstk_torch.scripts.eval`` process under PyTorch's default TF32 flags;
     its device loop timed and one view traced; SSIM of one view with
     cuDNN's TF32 against f32; gs-eval with random LPIPS weights written as
     an npz gives a finite LPIPS, and LPIPS on a 128x128 crop of one pair
     on the card equals the CPU's (rtol 1e-4); gs-render ``pose`` writes
     21 rgb and depth PNGs, each equal to the Renderer's output quantized
     alike, and ``poses.json``; gs-render ``trajectory`` renders 8 poses at
     1920x1080 in four bands, K1 and K3 four times a frame, each band's
     tile ranges ordered and ending at its intersection count, one frame
     against the plain twins (phase 6's tolerances, 0.1% of values
     outside), frames timed and one traced; gs-export ``gaussian-splat``
     byte for byte ``--device cpu``'s, ``camera-poses``, ``point-cloud``,
     ``offline-tsdf`` at its defaults (200^3 voxels) with marching
     tetrahedra, and with Poisson, ``--clean`` and ``--mask-method
     threshold``, each mesh non-empty; the fused volume on the card against
     the CPU on the same frames (tsdf and colors within atol 1e-5 on all
     but 0.1% of voxels, weights equal outside them), integration, Poisson
     and marching tetrahedra timed; Pillow, OpenCV, PyYAML, torchvision and
     transformers stay unimported;
  14. methods, on phase 11's dataset (800x800, 21 train views, the 100k
     seed cloud in 2^19 lanes): (b) ``gstk_torch.scripts.train co-gs`` for
     300 steps with sensor depth from step 0 and SO3xR3 camera optimisation
     (``ITER_TRAIN_TIME``, final eval PSNR, the depth-L1 term at its first
     and last log, the camera adjustments finite and moved); (a) from its
     trained state (step 300: every gate open, scales anisotropic), one
     co-gs step (sensor depth L1, the sparse term, the planar term on 32x32
     patches, the camera group over the 21 views) through the kernels,
     with the launch counters reset just before (K1-K4 once each, AF
     twice: the scene's Adam state and the camera group's), against
     the same step with ``backend="plain"`` and a generator of the same
     seed (phase 10's tolerances, the camera group's moments and update
     too); K2's depth column is nonzero, the camera gradient finite and
     nonzero, no moment non-finite; the step timed and traced beside the
     vanilla method's step from the same state, and ``torch.linalg.eigh``
     on (16, 3, 3) timed; (c) ``surface-gs`` for 300 steps through d = 4,
     2, 1 (a bucket every 100 steps), refining from step 100: every alive
     mean equals the seed cloud's bit for bit, no split or dup, the step
     time of each bucket; (b) and (c) with the counters reset just before
     each and K1-K4 launched; the phase's wall time;
  15. data and viewer: (a) ``gstk_torch.data.raytraced`` writes 24 views of
     the raytraced scene at 800x800 with 3x3 supersampling on the card, and
     4 at ss 1 (seconds a view, files included, and the shading alone;
     device peak); one view at ss 1 shaded on the card against the CPU:
     RGBA and depth equal in >= 99.9% of pixels, alpha equal, depth within
     1 mm; (b) ``gstk_torch.tools.make_mono_depth`` writes its mono-depth
     variant (its recovery report; it refuses above a 2% median scale
     error) and co-gs trains on it through gs-train for 300 steps with the
     est-depth terms (Pearson, scaled estimate, regulariser) from step 0,
     the counters reset just before: K1-K4 launch, losses and terms finite
     (``ITER_TRAIN_TIME``, the terms at the first and last log past step
     0, final eval PSNR and SSIM); (c) gs-viewer (``python -m
     gstk_torch.scripts.viewer``) on that run as a subprocess on a free
     port, which must load within 180 s and is killed afterwards, answers
     ``/``, 10 rgb ``/render`` at 640x480 over an orbit, 2 depth, 2 with the
     crop box, a keyframe pair with ``/trajectory`` and one
     ``/render_traj``, each PNG decoded by ``read_png`` (shape, not blank);
     the same requests to an in-process ``TrainingViewer`` served alike,
     with the counters reset just before, give equal frames and one K1 and
     one K3 a frame; frame 0 against the plain twins' render (uint8 within
     1 level, 0.1% of pixels outside); request ms (host clock), the
     ``encode_png`` ms and one traced render; (d) 200 vanilla steps on
     15(a)'s data without a viewer and with ``--vis viewer`` while a client
     thread requests ``/render`` every 50 ms, the counters reset before
     each: ``ITER_TRAIN_TIME`` of both, frames served, none blank after the
     first snapshot, and K1 and K3 of the viewer's run equal the other
     run's plus one a frame rendered from a snapshot (K2, K4 equal);
     Pillow, OpenCV and PyYAML stay unimported;
  16. data processing: (a) 15(a)'s 24 views, renamed ``frame_00001.png``...
     so that the pipeline's rename is the identity, with a COLMAP text
     model written here (PINHOLE, the known poses, the 96,000 seed points,
     up to 400 unoccluded observations a view) and 15(b)'s mono estimates
     go through ``python -m gstk_torch.scripts.process_data images
     --skip-colmap --num-downscales 3 --mono-depth-data`` in a fresh
     process: every frame gets a scale and shift, ``images_2/4/8`` lie
     within 0.5 of the block mean, ``colmap/point_cloud.ply`` holds the
     seed cloud, and each frame's scale is held against a dense fit of
     its estimate to the true depth (median within 2%); gs-train then
     runs 200 steps on the processed set with the counters reset just
     before (K1-K4 launch, losses finite, ``ITER_TRAIN_TIME``);
     ``estimate_depths`` with a torch model registered on the card, and
     the CLI with ``--using-est-depth --depth-method gradient
     --allow-toy-depth`` (never ``auto``, which would try the network);
     (b) 8 pinhole views at 960x720 out of a 2048x4096 equirect capture,
     timed; Pillow, OpenCV, PyYAML and transformers stay unimported;
  17. parallelism: (a) gs-train with ``--coordinator-address
     127.0.0.1:<free port> --num-processes 1 --process-id 0`` (a one-rank
     NCCL group) for 100 steps on phase 11's dataset, counters reset just
     before, ``ITER_TRAIN_TIME`` beside phase 11's; a DP step over that
     group from phase 11's trained state equals the plain step bit for bit;
     (b) two gloo ranks on the card (``chip_smoke.py --rank r 2 <dir>``,
     spawned, joined within 420 s, killed after): the DP step at
     bench.py's train point (rank r at pose(r)) against one Adam step on
     the mean of the two one-camera gradients computed here (visibility
     counts exactly; moments, parameter updates, grad norms, max_2dsize
     and loss with phase 10's tolerances), both ranks' states equal; the
     tile-sharded render of a 1920x1080 frame of
     phase 11's scene against the one-rank render (phase 6's tolerances;
     K1 and K3 on each rank); the Gaussian-sharded render and train step
     from phase 11's trained state (2^19 lanes) bit-equal to the
     replicated ones (an op off by rounding at the shard's row count would
     be named and held to phase 10's tolerances), one refine of the
     gathered state equal to the replicated refine, and the sharded refine
     of the shards (``refine(..., mesh=)``) equal to it bit for bit, the
     generator's state after it too, with a peak above the resident shard
     under half the whole-state gather's; each rank's device peak, sharded
     and replicated, and the ms of the collectives; at 2^21 global lanes
     (SH 3, each rank making the whole state from the seed and keeping
     its lanes of the reference on the host): the sharded refine against
     the replicated one and the sharded growth 2^20 -> 2^21 against the
     padded state sharded again, bit for bit, each timed with its peak
     beside the whole-state gather's (the refine's under half of it),
     and the sharded checkpoint against one written from the gathered
     state (members equal byte for byte); then gs-train with
     ``--param-sharding auto`` on the two ranks (50 steps on phase 11's
     dataset from a full capacity, every visible Gaussian densifying, few
     culled: refines at 10-50, a capacity growth after step 40),
     counters reset just before (K1-K4 launch on each rank), the whole
     state gathered no time; gs-eval loads its rank-0 checkpoint;
  18. quality path: (a) ``gstk_torch.tools.gen_raytraced_sharded`` (the
     quality reference's band-limited capture) writes 6 views at 160x160
     ss 3 on the card and on the CPU, every file equal byte for byte (PNGs,
     ``transforms.json``, ``sparse.ply``); (b) ``gstk_torch.tools.
     run_quality`` (the 15k recipe's flags, gs-train in process) on a copy
     of 15(a)'s views whose seed cloud holds 460,000 points (15(a)'s,
     picked with repeats and jittered by N(0, 0.12)), cut to 40 steps in
     two stretches (the second resumed from the first's checkpoint), at
     full resolution from step 0 and with ``--initial-capacity-headroom
     1.0``, the counters reset just before: the trainer grows its capacity
     2^19 -> 2^20 once, grows its intersection buffer to 2^21 and splits
     into >= 2 bands on its own, the resumed stretch keeps both; K1-K4
     launch once a band a step; (c) at the grown state, one train step in
     those bands through the kernels against the same step in one band of
     2^22 intersections (phase 10's tolerances): gradients add across
     bands through K2 and K4; (d) gs-eval on (b)'s checkpoint equal to the
     trainer's final eval bit for bit; (e) ``gstk_torch.tools.
     convert_lpips_weights`` on random VGG16 and LPIPS-head state dicts,
     its self-test on the card within rtol 1e-4 of the same on the CPU;
  19. configurations: (a) ``quality_workflow``'s 1-spp capture (the serial
     generator) writes 18(a)'s 6 views at 160x160 on the card and on the
     CPU, every file equal byte for byte, and its mono-depth variant from
     the card's; (b) one ``rasterize_mode="antialiased"`` train step
     through K1-K4 against the same step with ``backend="plain"`` (phase
     10's tolerances) on bench.py's scene with log-scales in
     ``AA_SCALES``, where the compensation runs from under 0.05 to over
     0.9; (c) co-gs with sensor depth, mono co-gs and antialiased vanilla
     on (a)'s capture, each through ``quality_workflow`` (exact cameras,
     20 steps in two stretches in child processes, the second resuming
     the first's checkpoint, gs-eval equal to the trainer's final eval,
     two counted steps here) and through
     ``tpu_precision_probe --rounded fullmat`` (20 steps here, the
     trainer's eval equal to the rounded gs-eval), after which the exact
     camera and SH functions are back in place; (d) the surface-gs
     refinement (``--method surface-gs --iters 40 --stretch 10``: the
     vanilla recipe to step 20, standing for 15k, then surface-gs from that
     checkpoint in two stretches of 10, standing for 16k and 17k) through
     both, gs-eval equal to the trainer's eval at every stretch, the
     refinement's final checkpoint against the vanilla one it resumed
     (``frozen_check``: no lane born, the means' moments only decayed and
     no mean moved without the checkpoint's momentum), in both the exact
     and the rounded run; the counters reset just
     before each run and read just after;
  20. the largest operating points: (a) ``bench_render_4k``'s point at
     full size (3840x2160, 300k Gaussians, ``bands=0``, 2^20 a band): 13
     bands, K1 and K3 13 launches each a frame, K2 and K4 none, the frame
     against the same frame through the plain twins on every band (rtol
     1e-3, atol 1e-4, 0.1% outside), each band's intersection count equal
     to the CPU's count of the same projection, no band truncated, its
     device ms; (b) a continuation at 160x160: gs-train to a checkpoint
     at a saturated capacity with the split window closed, then resumed
     with a four times larger ``--max-capacity`` and the split window
     reopened: the capacity grows on the first metrics window, the resumed
     ``config.yml`` holds the new flags, gs-eval equals the trainer's eval
     bit for bit; (c) the two 30k configurations (``--iters 30000`` on
     the 1-spp capture with ``--max-capacity 2097152``, and on the ss 3
     capture with its continuation) at a small size through
     ``quality_workflow`` (80 steps in four stretches standing for the
     recipe's 7500) and the probe, K1-K4 once a step;
  21. the last tools: (a) ``profile_step`` at bench.py's point: K1-K4 in
     its table, every launch made recorded, device busy within the traced
     window, ``--parse-only`` equal; (b) ``bench_kernels`` at its point,
     K1 and K2 against their plain twins at phases 5 and 9's tolerances;
     (c) ``bench_render``'s frame against the plain twins; (d)
     ``bench_refine``'s inputs at 2^16 lanes refined on the card equal to
     the CPU's; (e) ``bench_sort``, ``bench_scatter`` and ``bench_gather``
     at a reduced size and ``bench_gather port`` at bench.py's point, each
     case equal to numpy, and ``bench_render_4k``'s ``main`` at 1920x1080
     (K1 and K3 once a band, the Renderer's bands equal); (f) the round-2
     64-view run (``tools/run_15k.sh``) at 160x160, two stretches of 300
     steps standing for 7500 each, the downstream stage (gs-export
     gaussian-splat, gs-render pose, the tetra TSDF mesh, not empty) and
     a 20-step co-gs smoke, gs-eval equal to the trainer's eval, K1-K4
     once a step;
     (g) ``quality_workflow`` on CUDA refused (exit 3) without a preflight
     stamp; then, every phase passed, the preflight stamp is written and
     ``preflight check`` exits 0;
then one ``kernels`` JSON line (K1-K4, PF, PB and AF: launches per train step,
times, bounds, phase 6's render launches under ``launches_render``, phase
14's launches under ``launches_methods``, phase 15's
under ``launches_data_viewer``, phase 16's under
``launches_process_data``, phase 17's under ``launches_parallel``, per
rank and path, phase 18's under ``launches_quality`` and phase 19's, a
step of each configuration and each probe run, under
``launches_configs``, phase 20's 4K frame under ``launches_4k`` and its
continuation and 30k runs under ``launches_30k``, phase 21's under
``launches_tools``; P1-P3:
launches in phase 12's run of the probes; phase 10b's errors under
``projection``, phase 10c's numbers under ``adam``; phase 11's numbers under
``trainer``, phase 12's under ``probes``, phase 13's, K1 and K3 launches a
view and a frame included, under ``backend``, phase 14's under
``methods``, phase 15's under ``data_viewer``, phase 16's under
``process_data``, phase 17's under ``parallel``, phase 18's under
``quality``, phase 19's under ``configs``, phase 20's under
``largest``, phase 21's under ``tools``), the card's name and
power limit, and the last line ``{"ok":
true, "device": {...}}``.
Kernel times are torch.profiler's device time; a kernel it records no
launch of after three sessions fails the run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zipfile
import zlib
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from gstk_torch import _build
from gstk_torch.core import cameras as cameras_mod
from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import (
    FIELD_NAMES,
    GaussianScene,
    init_scene,
    scene_from_numpy,
    scene_to_numpy,
)
from gstk_torch.models import vanilla as vanilla_mod
from gstk_torch.ops import sh as sh_mod
from gstk_torch.models.vanilla import (
    VanillaConfig,
    composite_gt_with_background,
    render_scene,
    rgb_loss,
    splat_inputs,
)
from gstk_torch.ops.binning import bin_gaussians, expansion_positions
from gstk_torch.ops.projection import tight_extents, tile_bbox
from gstk_torch.ops.raster_cuda import (
    composite_tiles_bwd,
    composite_tiles_bwd_plain,
    composite_tiles_fwd,
    composite_tiles_fwd_plain,
    KERNEL_CHANNELS,
    _walk,
    pack_records,
    resident_ctas,
)
from gstk_torch.ops import project_cuda
from gstk_torch.ops.project_cuda import project_bwd, project_fwd
from gstk_torch.ops.rasterize import RasterizeConfig, _tiles_to_image, rasterize
from gstk_torch.ops.segment_kernel import (
    segment_broadcast,
    segment_broadcast_plain,
    segment_sum_sorted,
    segment_sum_sorted_plain,
)
from gstk_torch.configs.methods import method_configs
from gstk_torch.configs.serialize import load_config
from gstk_torch.core.camera_opt import CameraOptConfig
from gstk_torch.data.datamanager import FullImageDatamanager
from gstk_torch.data.dataparser import parse_transforms
from gstk_torch.data.raytraced import (
    build_scene,
    camera_dirs,
    generate_raytraced_dataset,
    render_view,
    view_images,
    view_pose,
)
from gstk_torch.data.synthetic import ISECT_CAPACITY, generate_synthetic_dataset
from gstk_torch.exporter.poisson import poisson_indicator
from gstk_torch.parallel import gaussian_sharding
from gstk_torch.parallel.gaussian_sharding import (
    gather_train_state,
    grow_train_state,
    make_gauss_mesh,
    render_scene_gauss_sharded,
    shard_train_state,
)
from gstk_torch.parallel.mesh import DATA_AXIS, get_mesh
from gstk_torch.parallel.tile_sharding import make_tile_mesh, rasterize_tile_sharded
from gstk_torch.process_data.equirect import (
    generate_planar_projections_from_equirectangular,
)
from gstk_torch.process_data.mono_depth import estimate_depths, register_depth_model
from gstk_torch.exporter.tsdf import integrate_frames, make_volume, marching_tetrahedra
from gstk_torch.render.renderer import Renderer
from gstk_torch.scripts import eval as eval_cli
from gstk_torch.scripts import export as export_cli
from gstk_torch.scripts import render as render_cli
from gstk_torch.scripts.process_data import main as process_data_main
from gstk_torch.scripts.train import main as train_main
from gstk_torch.tools import (
    F32_FLOP_PER_S,
    HBM_BYTES_PER_S,
    K1_FLOP_PER_PAIR,
    ablate_fwd,
    bench_dynrow,
    bench_gather,
    bench_kernels,
    bench_point,
    bench_refine,
    bench_render,
    bench_render_4k,
    bench_scatter,
    bench_sort,
    convert_lpips_weights,
    event_ms,
    event_samples,
    gen_raytraced_sharded,
    k1_work,
    k2_work,
    kernel_device_ms,
    launches_during,
    make_mono_depth,
    preflight,
    profile_step,
    quality_workflow,
    run_quality,
    tpu_precision_probe,
)
from gstk_torch.train.checkpoint import (
    latest_checkpoint,
    peek_meta,
    save_checkpoint,
    save_scene,
    train_state_from_numpy,
    train_state_to_numpy,
)
from gstk_torch.train.adam_cuda import adam_fused
from gstk_torch.train.optim import (
    AdamState,
    OptimizerConfig,
    adam_step,
    adam_step_plain,
)
from gstk_torch.train.step import init_train_state, make_train_step
from gstk_torch.train.strategy import RefineState, refine
from gstk_torch.train import trainer as trainer_mod
from gstk_torch.train.trainer import Trainer, area_downscale, train_cache_bytes
from gstk_torch.utils.colors import EVAL_BACKGROUND
from gstk_torch.utils import losses
from gstk_torch.utils.io import (
    encode_png,
    read_ply,
    read_ply_points,
    read_png,
    write_ply,
    write_png,
)
from gstk_torch.utils.lpips import lpips, random_lpips_params
from gstk_torch.utils.profiler import PROFILER
from gstk_torch.viewer import http_viewer
from gstk_torch.viewer.http_viewer import (
    DEFAULT_SETTINGS,
    FRAME_PNG_LEVEL,
    TrainingViewer,
    orbit_pose,
)

SEED = 0
N_POINTS, CAPACITY, SH_DEGREE = 100_000, 104 * 1024, 3
H = W = 800
FOCAL = 1111.0
REQUESTS = 8
TRAIN_ISECT = 3 << 18  # bench.py's training isect_capacity
TRAIN_STEPS = 10  # timed, after 2 warm-ups
K4_SHORT = 32  # the longest segment a thread of K4 sums alone (kShort)
DEVICE = "cuda"
PARITY = dict(rtol=1e-3, atol=1e-4)  # gstk_tpu's image parity tolerances
RTOL_GRAD = 5e-3  # gstk_tpu's gradient parity tolerance
MAX_OUTSIDE = 0.005  # share of a group allowed outside it (cutoff flips)
# phase 11: the synthetic object's points, few enough that no 800x800 view
# of the generator's render exceeds its ISECT_CAPACITY (2^17) intersections
# (it raises if one does; the count grows with the points)
SYN_POINTS, SYN_VIEWS = 500, 24
# the trainer's seed cloud: phase 10's count, each point one of the
# object's, picked at random, jittered by N(0, SEED_JITTER) on each axis
SEED_POINTS, SEED_JITTER = N_POINTS, 0.05
TRAIN_ITERS = 400
REFINE_TIMES = 5  # synchronized refine calls timed, median reported
REFINE_STEP = 1000  # phase 10's refine: past warmup, densifying
# phase 10(b): the projection kernels at the 30k operating point's lanes
# (2^21, about 1.76M alive), SH degree 3, on phase 3's camera
PROJ_LANES, PROJ_ALIVE = 1 << 21, 1_760_000
# phase 10(c): AF on PROJ_LANES lanes of these rows (SH degree 3), the
# steps it is held at, and the camera group's cameras
ADAM_ROWS = {"means": (3,), "scales": (3,), "quats": (4,),
             "features_dc": (3,), "features_rest": (15, 3), "opacities": (1,)}
ADAM_STEPS, ADAM_CAMERAS = (0, 12_093, 29_998), 37
# phase 13: gs-eval against the trainer's eval (PSNR rtol, SSIM atol)
EVAL_RTOL, EVAL_ATOL = 1e-4, 1e-4
LPIPS_CROP = 128  # LPIPS on the card against the CPU on this square of a pair
# gs-render trajectory: 8 poses at the camera path's default size, which
# the Renderer splits into ceil(1920 * 1080 / 640,000) = 4 bands
TRAJ_POSES, TRAJ_W, TRAJ_H, TRAJ_BANDS = 8, 1920, 1080, 4
# gs-export offline-tsdf's defaults: a 2 m cube of 1 cm voxels (200^3)
TSDF_SIZE, TSDF_VOXEL, TSDF_TRUNC, POISSON_ITERS = 2.0, 0.01, 0.04, 200
TSDF_ATOL, TSDF_OUTSIDE = 1e-5, 1e-3  # voxels where a round of u or v flips
# phase 14: the runs take 300 steps (at the co-gs run's last, the sparse
# gate, step % 100 == 0, and the depth and planar gates, step > 0, are all
# open), surface-gs's buckets 100 each
PLANAR_PATCH, METHOD_ITERS, SURFACE_SCHEDULE = 32, 300, 100
K2_DEPTH_COLUMN = 6 + 3  # K2's rows: [x, y, a, b, c, opacity, r, g, b, depth]
# phase 15: the raytraced scene at 800x800 with 3x3 supersampling, 24 views
# (cut from the quality reference's 240); 4 views at ss 1 timed beside it
RT_VIEWS, RT_SS, RT_SS1_VIEWS = 24, 3, 4
RT_EQUAL = 0.999  # pixels and depths of the card's view equal to the CPU's
MONO_MAX_ERR = 0.02  # the mono tool's own refusal threshold
# gs-viewer: 10 rgb frames over an orbit at the viewer's default 640x480,
# elevation 0.35 rad; the crop box half-width as a share of the radius
VIEWER_REQUESTS, VIEWER_W, VIEWER_H, VIEWER_EL, VIEWER_CROP = 10, 640, 480, 0.35, 0.3
VIEWER_DEADLINE_S = 180  # gs-viewer must print its port and load the scene by then
VIEWER_ITERS, POLL_S = 200, 0.05  # 15(d): steps a run; the client's poll period
# phase 16: observations a view in the COLMAP model; gs-train's steps on
# the processed set; the equirect capture and its views
PD_OBS, PD_ITERS = 400, 200
EQ_H, EQ_W, EQ_VIEWS = 2048, 4096, 8
# phase 17: gs-train's steps over a one-rank NCCL group; the two gloo
# ranks' deadline; the 1080p frame's single-band intersection buffer
PAR_ITERS, RANK_DEADLINE_S, TILE_ISECT = 100, 420, 1 << 22
# 17(b): the sharded refine, growth and checkpoint at the trainer's default
# max_capacity (2^21 global lanes, 2^20 a rank); the sharded gs-train run's
# steps (refines at 10-50, densifying at 40 and 50, a growth between)
BIG_CAPACITY, GAUSS_TRAIN_ITERS = 1 << 21, 50
# phase 18: the sharded capture on the card and the CPU; the quality run's
# seed cloud (enough intersections at 800x800 for the trainer to reach
# 2^21 and split), headroom (460,000 seeds fill 0.877 of 2^19 lanes, past
# the 0.85 growth threshold) and stretches; the one-band step's buffer
Q_VIEWS, Q_SIDE, Q_SEEDS = 6, 160, 5000
Q_POINTS, Q_JITTER, Q_HEADROOM = 460_000, 0.12, 1.0
Q_STRETCHES, ONE_BAND_ISECT = (20, 40), 1 << 22
# phase 19: the 1-spp capture at 18(a)'s size; the configurations' short
# runs (two stretches through quality_workflow, one through the probe);
# the antialiased step's log-scales, wide enough that sub-pixel Gaussians
# have a compensation far below 1
C_ITERS, C_FIRST = 20, 10
AA_SCALES = (-7.5, -2.5)
CONFIGS = {  # quality_workflow / probe flags, gs-train flags
    "240_cogs": (["--method", "co-gs"], []),
    "240_mono_cogs": (["--mono"], []),
    "240_aa": ([], ["--model.rasterize-mode", "antialiased"]),
}
# the surface-gs refinement: stretches of 10 steps, two of the vanilla
# recipe standing for 7500 each, then two of surface-gs for 1000 each
REFINE_FLAGS, R_ITERS, R_STRETCH = ["--method", "surface-gs"], 40, 10
# phase 20: the 4K frame's timed repeats; the continuation's seed cloud
# (7,500 seeds fill 0.92 of 8192 lanes at headroom 1, past the 0.85 growth
# threshold), its two gs-train runs and the flags the resume changes; the
# 30k configurations at a small size, four stretches of 20 steps
R4K_ITERS = 5
CONT_SEEDS, CONT_STEPS = 7500, (20, 40)
CONT_CAPACITY = 8192
CONFIGS_30K = {  # capture, quality_workflow / probe flags, gs-train flags
    "240_30k": ("1spp", [], ["--max-capacity", "2097152"]),
    "240_ss3_30k": ("ss3", [], []),
}
C30_ITERS, C30_STRETCH = 80, 20
# phase 21: profile_step's traced steps; the refine's lanes; the sort, scatter
# and gather sizes; the 64-view workflow at 18(a)'s side, two stretches of
# 20 steps standing for the recipe's 7500 each, and a 20-step co-gs smoke
PROFILE_STEPS, TOOL_REFINE_CAP = 3, 1 << 16
TOOL_SORT_LOGN, TOOL_ROWS = (16, 18), 1 << 16
TOOL_4K_GAUSSIANS = 30_000
R15_VIEWS, R15_ITERS, R15_STRETCH, R15_COGS_ITERS = 64, 600, 300, 20
VGG_LAYERS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
REPO = Path(__file__).resolve().parent
R15_PUBLISHED = REPO / "gstk_torch" / "tools" / "published" / "results_15k.json"


def phase(name):
    print(f"== {name}", flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bench_scene(device, log_scales=(-4.5, -2.5)):
    """bench.py's scene: uniform points in front of an identity camera,
    kNN scales replaced by tight log-scales (uniform in ``log_scales``),
    opacities in [0.3, 0.9]."""
    g = torch.Generator().manual_seed(SEED)

    def u(lo, hi, *shape):
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).numpy()

    pts = u(-3.0, 3.0, N_POINTS, 3)
    pts[:, 2] = u(-9.0, -2.0, N_POINTS)
    rgb = u(0.0, 255.0, N_POINTS, 3)
    arrays = scene_to_numpy(init_scene(
        g, CAPACITY, (pts, rgb), sh_degree=SH_DEGREE, device="cpu"
    ))
    arrays["scales"][:N_POINTS] = u(*log_scales, N_POINTS, 3)
    op = u(0.3, 0.9, N_POINTS)
    arrays["opacities"][:N_POINTS, 0] = np.log(op / (1.0 - op))
    return scene_from_numpy(arrays, device)


def pose(i: int) -> np.ndarray:
    """Request i's c2w: the bench camera (i = 0) and small offsets of it."""
    c2w = np.eye(4, dtype=np.float32)[:3]
    if i:
        a = 0.02 * np.array([math.sin(i), math.cos(2 * i), math.sin(3 * i)])
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        u, _, vt = np.linalg.svd(np.eye(3) + K)
        c2w[:, :3] = u @ vt
        c2w[:, 3] = 0.1 * np.array([math.cos(i), math.sin(2 * i), 0.5 * math.sin(i)])
    return c2w


def assert_close(name, got, want, rtol, atol, max_outside=0.0):
    """|got - want| <= atol + rtol |want| for all but a ``max_outside``
    share of the values; ``atol`` may be a tensor that broadcasts (a
    tolerance per column or row). Returns the number outside."""
    ok = (got - want).abs() <= atol + rtol * want.abs()
    bad = int((~ok).sum())
    if bad > max_outside * ok.numel():
        raise AssertionError(
            f"{name}: {bad} of {ok.numel()} values outside rtol {rtol}, max "
            f"abs err {float((got - want).abs().max())}"
        )
    return bad


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--rank"]:  # one rank of phase 17(b)
        return rank_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    if sys.argv[1:2] == ["--tools"]:  # phase 21's timed tools
        return tools_main(Path(sys.argv[2]), sys.argv[3])
    with tempfile.TemporaryDirectory(prefix="gstk_torch_smoke_") as ckpt_dir:
        return run(ckpt_dir)


def run(ckpt_dir: str) -> int:
    """The phases; the checkpoint goes to ``ckpt_dir``."""
    dev = torch.device(DEVICE)
    # this script is the card parity run that writes the preflight stamp,
    # once every phase has passed; its own quality runs go ahead before it
    os.environ[preflight.SKIP_ENV] = "1"

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    phase("2 build")
    build = _build.build()
    print(f"build {build.seconds:.2f} s (compiled now: {build.built}) -> {build.library}")
    for line in build.ptxas_log.splitlines():
        if line.startswith("==") or any(k in line for k in ("registers", "spill", "Compiling entry")):
            print("  " + line.strip())
    resident = {}
    for name, kernel in (("composite_tiles_fwd", "fwd"), ("composite_tiles_bwd", "bwd")):
        resident[name] = {ch: resident_ctas(kernel, ch) for ch in KERNEL_CHANNELS}
        print(f"{name}: resident CTAs per SM by ch {resident[name]}")

    phase("3 scene")
    t0 = time.perf_counter()
    scene = bench_scene(dev)
    path = save_scene(ckpt_dir, scene, step=0, extras={
        "isect_capacity": 3 << 18, "bands": 1, "sh_degree": SH_DEGREE,
    })
    camera = Camera.create(FOCAL, FOCAL, W / 2, H / 2, pose(0), device=dev)
    raster = RasterizeConfig(isect_capacity=1 << 20)
    with torch.no_grad():
        inputs = splat_inputs(scene, camera, H, W, sh_degree=SH_DEGREE,
                              config=VanillaConfig())
        # rasterize's footprints and tile counts at one band
        ext = tight_extents(inputs["conics"], inputs["opacities"],
                            inputs["radii"].float())
        tiles = ((W + 15) // 16, (H + 15) // 16)
        tmin, tmax = tile_bbox(inputs["xys"], ext, tiles, 16)
        area = (tmax[:, 0] - tmin[:, 0]) * (tmax[:, 1] - tmin[:, 1])
        counts = torch.where((ext[:, 0] > 0) & (ext[:, 1] > 0), area, 0).int()
        isect = bin_gaussians(inputs["xys"], inputs["depths"], ext, counts,
                              tiles, 16, raster.isect_capacity)
    n_isect = int(isect.num_intersects)
    print(f"scene {N_POINTS} Gaussians (capacity {CAPACITY}), {W}x{H}, "
          f"{n_isect} intersections of capacity {raster.isect_capacity}, "
          f"{time.perf_counter() - t0:.1f} s; checkpoint {path}")
    assert 0 < n_isect <= raster.isect_capacity, "truncated or empty"

    phase("4 K3 segment_broadcast vs plain twin")
    cum = torch.cumsum(counts.long(), 0).int()
    g = torch.Generator(device=dev).manual_seed(SEED)
    rand_i32 = lambda n: torch.randint(-2**31, 2**31, (n,), generator=g,
                                       device=dev, dtype=torch.int64).int()
    ones = torch.ones(CAPACITY, dtype=torch.int32, device=dev)
    depth_bits = inputs["depths"].contiguous().view(torch.int32)
    zeroed = torch.where(torch.rand(CAPACITY, generator=g, device=dev) < 0.5, 0, counts)
    k3_cases = {
        "main path (1 column)": (cum, [ones]),
        "3 columns": (cum, [ones, torch.diff(depth_bits, append=depth_bits[:1]),
                            rand_i32(CAPACITY)]),
        "past length": (cum * 3, [ones, rand_i32(CAPACITY)]),
        "zero counts": (torch.cumsum(zeroed.long(), 0).int(), [ones, rand_i32(CAPACITY)]),
        # the last boundary at about 0.35 of length
        "long tail": (cum // 2, [ones, rand_i32(CAPACITY)]),
        # 3000 boundaries at slot 5001: runs of 64 that own no slot
        "wide window": (torch.sort(torch.cat([
            cum[:-3000], torch.full((3000,), 5001, dtype=cum.dtype, device=dev),
        ])).values, [ones, rand_i32(CAPACITY)]),
    }
    for name, (b, ds) in k3_cases.items():
        got = segment_broadcast(b, ds, raster.isect_capacity)
        want = segment_broadcast_plain(b, ds, raster.isect_capacity)
        torch.cuda.synchronize()
        for c, (x, y) in enumerate(zip(got, want)):
            if not torch.equal(x, y):
                raise AssertionError(f"K3 {name} column {c}: "
                                     f"{int((x != y).sum())} slots differ")
        print(f"K3 {name}: {len(ds)} x {raster.isect_capacity} slots equal, "
              f"boundaries up to {int(b.max())}, "
              f"{max(raster.isect_capacity - int(b.max()), 0)} slots past the last")

    phase("5 K1 composite_tiles_fwd vs plain twin (ch = 4)")
    k1_args = (inputs["xys"], inputs["conics"], inputs["opacities"],
               inputs["colors"], isect.gaussian_ids, isect.tile_bins, tiles)
    acc, final_t = composite_tiles_fwd(*k1_args)
    acc_p, final_t_p, visited = composite_tiles_fwd_plain(*k1_args)
    torch.cuda.synchronize()
    assert_close("K1 acc", acc, acc_p, **PARITY)
    assert_close("K1 final_t", final_t, final_t_p, **PARITY)
    k1_err = max(float((acc - acc_p).abs().max()), float((final_t - final_t_p).abs().max()))
    pairs = int(visited.sum())
    print(f"K1 max abs err {k1_err:.3g} (acc {tuple(acc.shape)}, final_t "
          f"{tuple(final_t.shape)}); {pairs} (pixel, entry) pairs evaluated")

    phase("6 render path: Renderer, 8 requests")
    renderer = Renderer(ckpt_dir, device=dev)
    assert renderer.raster_config.isect_capacity == raster.isect_capacity
    args = lambda i: (pose(i), FOCAL, FOCAL, W / 2, H / 2, H, W)
    for _ in range(2):  # warm-ups
        renderer.get_output_from_pose(*args(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in (composite_tiles_fwd, segment_broadcast, project_fwd):
        f.launches = 0
    outs, ms = [], []
    for i in range(REQUESTS):
        t0 = time.perf_counter()
        out = renderer.get_output_from_pose(*args(i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = {f.__name__: f.launches
                for f in (composite_tiles_fwd, segment_broadcast, project_fwd)}
    peak = torch.cuda.max_memory_allocated()
    print(f"request ms: median {statistics.median(ms):.3f}, min {min(ms):.3f} "
          f"(host clock, synchronized; {REQUESTS} requests after 2 warm-ups)")
    print(f"num_intersects {[o['num_intersects'] for o in outs]} of capacity "
          f"{raster.isect_capacity}; peak memory {peak / 2**20:.1f} MiB; "
          f"launches {launches}")
    for name, n in launches.items():
        assert n >= REQUESTS, f"{name} launched {n} times for {REQUESTS} requests"
    for i, o in enumerate(outs):
        assert o["num_intersects"] <= raster.isect_capacity, f"request {i} truncated"
        assert o["rgb"].shape == (H, W, 3) and o["depth"].shape == (H, W)
        for k in ("rgb", "depth", "accumulation"):
            assert np.isfinite(o[k]).all(), f"request {i} {k} not finite"
        assert 0.05 < o["accumulation"].mean() < 1.0, "request renders nothing"
    assert outs[0]["num_intersects"] == n_isect
    plain = Renderer(ckpt_dir, device=dev, raster_config=RasterizeConfig(
        isect_capacity=raster.isect_capacity, bands=0, backend="plain"))
    ref = plain.get_output_from_pose(*args(0))
    main_err = {}
    for k in ("rgb", "depth", "accumulation"):
        assert_close(f"request 0 {k}", torch.from_numpy(outs[0][k]),
                     torch.from_numpy(ref[k]), **PARITY)
        main_err[k] = float(np.abs(outs[0][k] - ref[k]).max())
    print(f"request 0 vs plain twins on the card: max abs err {main_err}")
    trace("request", lambda: renderer.get_output_from_pose(*args(0)))

    phase("7 K1 and K3 timings (render shapes)")
    iters = 20
    length = raster.isect_capacity
    j = torch.arange(length, dtype=torch.int32, device=dev)
    k3_in = (torch.clamp(cum, max=length), [ones], length)
    k3 = {
        **kernel_device_ms(lambda: segment_broadcast(*k3_in),
                           "segment_broadcast_kernel", iters),
        "wrapper_ms": event_ms(lambda: segment_broadcast(*k3_in), iters),
        "plain_ms": event_ms(lambda: segment_broadcast_plain(*k3_in), iters),
        # with d = 1 the function is #{i: b[i] <= j}: one searchsorted
        "library_ms": event_ms(lambda: torch.searchsorted(k3_in[0], j, right=True), iters),
    }
    # a yardstick for K3's bytes: a fill of its 4-B-a-slot output
    fill_out = torch.empty(length, dtype=torch.int32, device=dev)
    floors = {"k3_fill": kernel_device_ms(lambda: fill_out.fill_(7), None, iters)}
    k3_bytes = 4 * CAPACITY * 2 + 4 * length  # b and d read, one column written
    k3_ops = length * math.ceil(math.log2(CAPACITY)) * 4  # search steps
    k1_rec = pack_records(*k1_args[:4])
    k1 = {
        **kernel_device_ms(lambda: composite_tiles_fwd(*k1_args, records=k1_rec),
                           "composite_fwd_kernel", iters),
        "wrapper_ms": event_ms(lambda: composite_tiles_fwd(*k1_args, records=k1_rec),
                               iters),
        "plain_ms": event_ms(lambda: composite_tiles_fwd_plain(*k1_args), 3),
        "library_ms": None,  # no single PyTorch call composites tiles
    }
    ch = inputs["colors"].shape[1]
    num_tiles = tiles[0] * tiles[1]
    k1_bytes, k1_ops = k1_work(n_isect, num_tiles, ch, pairs)
    # the record K1 and K2 read, built once per band outside both kernels
    pack = {"render": kernel_device_ms(lambda: pack_records(*k1_args[:4]),
                                       None, iters)}
    print(f"K3 {k3}\nK1 {k1}\npack_records {pack['render']}")
    del renderer, plain, outs

    phase("8 train scene")
    model_cfg = VanillaConfig(sh_degree=SH_DEGREE, background_color="black")
    train_raster = RasterizeConfig(isect_capacity=TRAIN_ISECT)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gt = torch.rand((H, W, 3), generator=gen, device=dev)
    scene = bench_scene(dev)
    with torch.no_grad():
        t_in = splat_inputs(scene, camera, H, W, sh_degree=SH_DEGREE,
                            config=model_cfg)
        ext = tight_extents(t_in["conics"], t_in["opacities"],
                            t_in["radii"].float())
        tmin, tmax = tile_bbox(t_in["xys"], ext, tiles, 16)
        area = (tmax[:, 0] - tmin[:, 0]) * (tmax[:, 1] - tmin[:, 1])
        t_counts = torch.where((ext[:, 0] > 0) & (ext[:, 1] > 0), area, 0).int()
        t_isect = bin_gaussians(t_in["xys"], t_in["depths"], ext, t_counts,
                                tiles, 16, TRAIN_ISECT)
    t_n_isect = int(t_isect.num_intersects)
    print(f"train scene: {t_n_isect} intersections of capacity {TRAIN_ISECT}")
    assert 0 < t_n_isect <= TRAIN_ISECT, "training intersections truncated"
    lengths = (t_isect.tile_bins[:, 1] - t_isect.tile_bins[:, 0]).double()
    tile_lengths = {"mean": float(lengths.mean()),
                    "p99": float(torch.quantile(lengths, 0.99)),
                    "max": float(lengths.max())}
    print(f"tile range lengths over {lengths.numel()} tiles: mean "
          f"{tile_lengths['mean']:.3f}, p99 {tile_lengths['p99']:.3f}, max "
          f"{tile_lengths['max']:.0f} (max / mean "
          f"{tile_lengths['max'] / tile_lengths['mean']:.3f})")

    phase("9 K2 composite_tiles_bwd and K4 segment_sum_sorted vs plain twins")
    fwd_args = (t_in["xys"], t_in["conics"], t_in["opacities"], t_in["colors"],
                t_isect.gaussian_ids, t_isect.tile_bins, tiles)
    acc, final_t = composite_tiles_fwd(*fwd_args)
    _, _, t_visited = composite_tiles_fwd_plain(*fwd_args)
    g_acc, g_final_t = step_cotangents(acc, final_t, tiles, gt, scene, model_cfg)
    bwd_args = fwd_args[:6] + (acc, final_t, g_acc, g_final_t, tiles)
    g_t_random = torch.randn(final_t.shape, generator=gen, device=dev)
    k2_err = 0.0
    # With a random final_t cotangent, an entry at T ~ 1e-4 carries a large
    # gradient, and where the kernel's sequential T and the twin's cumprod
    # round to opposite sides of the 1e-4 stop, one of them has that entry
    # and the other not: a few in a million may fall outside.
    for label, args, max_outside in (
        ("the step's cotangents", bwd_args, 0.0),
        ("a random final_t cotangent", bwd_args[:9] + (g_t_random, tiles), 1e-5),
    ):
        gout = composite_tiles_bwd(*args)
        gout_p, t_kept = composite_tiles_bwd_plain(*args)
        torch.cuda.synchronize()
        scale = gout_p.abs().amax(0, keepdim=True)
        bad = assert_close(f"K2 gout ({label})", gout, gout_p, rtol=RTOL_GRAD,
                           atol=1e-4 * scale, max_outside=max_outside)
        err = float((gout - gout_p).abs().max())
        print(f"K2 with {label}: max abs err {err:.3g}, {bad} values outside "
              f"the tolerance, column max {[round(float(x), 6) for x in scale[0]]}")
        if max_outside == 0.0:
            k2_err = err
    gout = composite_tiles_bwd(*bwd_args)
    positions = expansion_positions(t_isect)
    hi = torch.clamp(torch.cumsum(t_counts.long(), 0), max=TRAIN_ISECT)
    g_et = gout.index_select(0, positions).t()  # entry-major, as K4 reads it
    sums = segment_sum_sorted(g_et, hi)
    sums_p = segment_sum_sorted_plain(g_et, hi)
    torch.cuda.synchronize()
    # f32 summation error grows with the segment's sum of magnitudes
    mag = segment_sum_sorted_plain(g_et.abs(), hi)
    assert_close("K4 sums", sums, sums_p, rtol=1e-5, atol=1e-6 * mag)
    k4_err = float((sums - sums_p).abs().max())

    def backward_once():
        g = composite_tiles_bwd(*bwd_args)
        return segment_sum_sorted(g.index_select(0, positions).t(), hi)

    first, second = backward_once(), backward_once()
    torch.cuda.synchronize()
    assert torch.equal(first, second), "K2 -> gather -> K4 is not deterministic"
    t_pairs, t_kept_pairs = int(t_visited.sum()), int(t_kept.sum())
    print(f"K2 max abs err {k2_err:.3g} (gout {tuple(gout.shape)}); K4 max abs "
          f"err {k4_err:.3g} (sums {tuple(sums.shape)}); backward bit-identical "
          f"over two runs; {t_pairs} (pixel, entry) pairs evaluated, "
          f"{t_kept_pairs} kept")
    seg_len = torch.diff(hi, prepend=hi.new_zeros(1))
    k4_segments = {"mean": float(seg_len.double().mean()),
                   "p99": float(torch.quantile(seg_len.double(), 0.99)),
                   "max": int(seg_len.max()), "empty": int((seg_len == 0).sum()),
                   f"longer_than_{K4_SHORT}": int((seg_len > K4_SHORT).sum()),
                   "segments": int(seg_len.numel())}
    print(f"K4 segment lengths: {k4_segments}")
    gathered = gout.index_select(0, positions)
    k4_glue = {
        # the gather the backward runs before K4
        "gather": kernel_device_ms(lambda: gout.index_select(0, positions), None, iters),
        # the attribute-major copy K4 no longer needs
        "attribute_major_copy": kernel_device_ms(lambda: gathered.t().contiguous(),
                                                 None, iters),
    }
    print(f"K4 glue: {k4_glue}")
    warp_entries = kept_warp_entries(fwd_args)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    shuffle_ms = lambda n, s: n * s / (sms * mhz * 1e6) * 1e3
    for px, n in warp_entries.items():
        print(f"{n} (tile, warp, entry) triples with a kept pixel for warps of "
              f"{px} pixels; at one warp shuffle per SM and clock ({sms} SMs, "
              f"{mhz:.0f} MHz max SM clock) their shuffles take "
              f"{shuffle_ms(n, 5 * (6 + ch)):.4f} ms at {5 * (6 + ch)} each, "
              f"{shuffle_ms(n, 16):.4f} ms at 16 each")

    phase("10 train path: one step through the kernels vs backend='plain'")
    step_fn = make_train_step(model_cfg, train_raster, OptimizerConfig(), H, W,
                              sh_degree=SH_DEGREE)
    plain_fn = make_train_step(
        model_cfg, RasterizeConfig(isect_capacity=TRAIN_ISECT, backend="plain"),
        OptimizerConfig(), H, W, sh_degree=SH_DEGREE,
    )
    state = init_train_state(bench_scene(dev))
    state_p = init_train_state(bench_scene(dev))
    before = train_state_to_numpy(state)
    torch.cuda.synchronize()
    counters = (composite_tiles_fwd, composite_tiles_bwd, segment_broadcast,
                segment_sum_sorted, project_fwd, project_bwd, adam_fused)
    for f in counters:
        f.launches = 0
    state, metrics = step_fn(state, camera, gt)
    torch.cuda.synchronize()
    step_launches = {f.__name__: f.launches for f in counters}
    state_p, metrics_p = plain_fn(state_p, camera, gt)
    torch.cuda.synchronize()
    print(f"launches in one train step: {step_launches}")
    for name, n in step_launches.items():
        assert n >= 1, f"{name} not launched by the train step"
    assert step_launches["adam_fused"] == 1, step_launches
    compare_steps(metrics, metrics_p, before, train_state_to_numpy(state),
                  train_state_to_numpy(state_p), OptimizerConfig())

    ms_steps = []
    for i in range(2 + TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, camera, gt)
        torch.cuda.synchronize()
        ms_steps.append((time.perf_counter() - t0) * 1e3)
    ms_steps = ms_steps[2:]
    assert all(math.isfinite(float(metrics[k])) for k in ("loss", "psnr"))
    print(f"train step ms: median {statistics.median(ms_steps):.3f}, min "
          f"{min(ms_steps):.3f} (host clock, synchronized; {TRAIN_STEPS} steps "
          f"after 2 warm-ups); loss {float(metrics['loss']):.5f}, psnr "
          f"{float(metrics['psnr']):.3f}, num_intersects "
          f"{int(metrics['num_intersects'])}")
    # the cat of pack_records is one of the step's CatArrayBatchedCopy launches
    trace("train step", lambda: step_fn(state, camera, gt),
          show=("CatArrayBatchedCopy",))

    k2_rec = pack_records(*fwd_args[:4])
    k2 = {
        **kernel_device_ms(lambda: composite_tiles_bwd(*bwd_args, records=k2_rec),
                           "composite_bwd_kernel", iters),
        "wrapper_ms": event_ms(lambda: composite_tiles_bwd(*bwd_args, records=k2_rec),
                               iters),
        "plain_ms": event_ms(lambda: composite_tiles_bwd_plain(*bwd_args), 3),
        "library_ms": None,  # no single PyTorch call composites backward
    }
    rows = g_et.shape[0]
    n_seg = hi.shape[0]
    covered = int(hi[-1])
    lib_vals = g_et.t()[:covered]  # entry-major, as K4 reads it
    lib_vals_t = g_et[:, :covered].contiguous()  # attribute-major
    lib_lengths_t = seg_len[None].expand(rows, n_seg).contiguous()
    k4 = {
        **kernel_device_ms(lambda: segment_sum_sorted(g_et, hi),
                           "segment_sum_kernel", iters),
        "wrapper_ms": event_ms(lambda: segment_sum_sorted(g_et, hi), iters),
        "plain_ms": event_ms(lambda: segment_sum_sorted_plain(g_et, hi), iters),
        "library_ms": event_ms(lambda: torch.segment_reduce(
            lib_vals, "sum", lengths=seg_len, axis=0), iters),
        "library_axis1_ms": event_ms(lambda: torch.segment_reduce(
            lib_vals_t, "sum", lengths=lib_lengths_t, axis=1), iters),
    }
    # a yardstick for K4's bytes: one read of the values it covers
    floors["k4_read"] = kernel_device_ms(lambda: torch.sum(lib_vals), None, iters)
    lib = torch.segment_reduce(lib_vals, "sum", lengths=seg_len, axis=0)
    assert_close("segment_reduce vs K4", lib.t(), sums, rtol=1e-5, atol=1e-6 * mag)
    pack["train"] = kernel_device_ms(lambda: pack_records(*fwd_args[:4]), None, iters)
    print(f"K2 {k2}\nK4 {k4}\npack_records {pack['train']}")
    _, bench_info, bench_refine_ms = refine_runs(
        train_state_to_numpy(state), model_cfg, 1, W, DEVICE, REFINE_STEP,
        REFINE_TIMES)
    print(f"refine at capacity {CAPACITY} ({N_POINTS} alive), step "
          f"{REFINE_STEP}: {[round(x, 3) for x in bench_refine_ms]} ms "
          f"(synchronized); info {bench_info}")
    k2_bytes, k2_ops = k2_work(TRAIN_ISECT, t_n_isect, num_tiles,
                                             ch, t_pairs, t_kept_pairs)
    k4_bytes = rows * covered * 4 + n_seg * 4 + rows * n_seg * 4
    k4_ops = rows * covered
    proj = projection_phase(dev, camera, iters)
    adam = adam_phase(dev, iters)

    trainer_numbers = trainer_phase(Path(ckpt_dir), counters)
    trainer_numbers["bench_refine_ms"] = statistics.median(bench_refine_ms)
    probe_kernels, probe_numbers = probes_phase(
        (k1_rec, isect.gaussian_ids, isect.tile_bins, tiles[0]), k1["ms"],
        k1_bytes, k1_ops)
    backend_numbers = backend_phase(Path(ckpt_dir), trainer_numbers)
    method_numbers = methods_phase(Path(ckpt_dir), counters)
    data_numbers = data_viewer_phase(Path(ckpt_dir), counters)
    process_numbers = process_data_phase(Path(ckpt_dir), counters)
    parallel_numbers = parallel_phase(Path(ckpt_dir), counters, trainer_numbers)
    quality_numbers = quality_phase(Path(ckpt_dir), counters)
    configs_numbers = configs_phase(Path(ckpt_dir), counters)
    largest_numbers = largest_phase(Path(ckpt_dir), counters)
    tools_numbers = tools_phase(Path(ckpt_dir), counters)
    # every phase has passed: the kernel files carry a card parity pass
    stamp = preflight.write_stamp("chip_smoke")
    os.environ.pop(preflight.SKIP_ENV)
    assert preflight.main(["check"]) == 0, "the stamp just written is stale"
    tools_numbers["preflight_stamp"] = stamp
    print(f"preflight: stamped {stamp['hash'][:16]}... via chip_smoke; "
          f"check exits 0")

    kernels = []
    for name, t, nbytes, ops, src, replaces, err in (
        ("segment_broadcast", k3, k3_bytes, k3_ops,
         "gstk_torch/csrc/segment_broadcast.cu",
         "gstk_tpu/ops/segment_kernel.py:57", 0.0),
        ("composite_tiles_fwd", k1, k1_bytes, k1_ops,
         "gstk_torch/csrc/composite_fwd.cu",
         "gstk_tpu/ops/raster_pallas.py:409", k1_err),
        ("composite_tiles_bwd", k2, k2_bytes, k2_ops,
         "gstk_torch/csrc/composite_bwd.cu",
         "gstk_tpu/ops/raster_pallas.py:661", k2_err),
        ("segment_sum_sorted", k4, k4_bytes, k4_ops,
         "gstk_torch/csrc/segment_sum.cu",
         "gstk_tpu/ops/segment_kernel.py:227", k4_err),
        # no TPU kernel: XLA fuses gstk_tpu's projection and SH
        ("project_fwd", proj["fwd"], proj["fwd_bytes"], None,
         "gstk_torch/csrc/project_fwd.cu",
         "gstk_tpu/models/vanilla.py::splat_inputs (XLA-fused)",
         proj["fwd_err"]),
        ("project_bwd", proj["bwd"], proj["bwd_bytes"], None,
         "gstk_torch/csrc/project_bwd.cu",
         "gstk_tpu/models/vanilla.py::splat_inputs (jax.grad, XLA-fused)",
         proj["bwd_err"]),
        # no TPU kernel: XLA fuses gstk_tpu's Adam
        ("adam_fused", adam["t"], adam["bytes"], None,
         "gstk_torch/csrc/adam_fused.cu",
         "gstk_tpu/train/optim.py::adam_step (XLA-fused)", 0.0),
    ):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # the projection and Adam kernels' operations are not counted: a
        # lane's few hundred flops take far less than its bytes at the
        # HBM's rate
        ops_ms = 0.0 if ops is None else ops / F32_FLOP_PER_S * 1e3
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": step_launches[name],
            "max_abs_err": err, "max_err": err,
            "ms": t["ms"], "ms_per_call": t["ms_per_call"],
            "profiler_launches": t["profiler_launches"], "profiler_calls": iters,
            "wrapper_ms": t["wrapper_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops,
            "library_ms": t["library_ms"],
        }
        if "library_axis1_ms" in t:
            entry["library_axis1_ms"] = t["library_axis1_ms"]
        if name in launches:
            entry["launches_render"] = launches[name]
        # PF, PB and AF are counted where a phase counts through `counters`;
        # the subprocesses and the tools count K1-K4 alone (None)
        entry["launches_methods"] = {
            run: n.get(name) for run, n in method_numbers["launches"].items()}
        entry["launches_data_viewer"] = {
            run: n.get(name) for run, n in data_numbers["launches"].items()}
        entry["launches_process_data"] = {
            run: n.get(name) for run, n in process_numbers["launches"].items()}
        entry["launches_parallel"] = {
            "nccl_world1_run": parallel_numbers["launches"]["nccl_world1_run"].get(name),
            "ranks": [{path: n.get(name) for path, n in rank.items()}
                      for rank in parallel_numbers["launches"]["ranks"]]}
        entry["launches_quality"] = quality_numbers["launches"].get(name)
        entry["launches_configs"] = {
            run: n.get(name) for run, n in configs_numbers["launches"].items()}
        entry["launches_4k"] = largest_numbers["launches"]["4k_frame"].get(name)
        entry["launches_30k"] = {
            run: n.get(name) for run, n in largest_numbers["launches"].items()
            if run != "4k_frame"}
        entry["launches_tools"] = {
            run: n.get(name) for run, n in tools_numbers["launches"].items()}
        if name in resident:
            entry["resident_ctas_per_sm"] = resident[name][ch]
        kernels.append(entry)
    kernels.extend(probe_kernels)
    print(json.dumps({"kernels": kernels,
                      "projection": proj["numbers"],
                      "adam": adam["numbers"],
                      "train_tile_lengths": tile_lengths,
                      "train_kept_warp_entries": warp_entries,
                      "k4_segments": k4_segments, "k4_glue": k4_glue,
                      "floors": floors,
                      "pack_records": pack,
                      "request_ms_median": statistics.median(ms),
                      "request_ms_min": min(ms),
                      "train_step_ms_median": statistics.median(ms_steps),
                      "train_step_ms_min": min(ms_steps),
                      "trainer": trainer_numbers, "probes": probe_numbers,
                      "backend": backend_numbers,
                      "methods": method_numbers,
                      "data_viewer": data_numbers,
                      "process_data": process_numbers,
                      "parallel": parallel_numbers,
                      "quality": quality_numbers,
                      "configs": configs_numbers,
                      "largest": largest_numbers,
                      "tools": tools_numbers,
                      "power": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


def write_seed_cloud(data: Path, n: int, jitter: float = SEED_JITTER) -> None:
    """Rewrite the dataset's ``sparse.ply`` with ``n`` seed points: each a
    point of the generator's own cloud, picked at random, moved by
    N(0, jitter) on each axis, with that point's color. The generator
    writes the points of its object, as few as its fixed intersection
    buffer allows; the trainer starts from this cloud, at the size of
    phase 10's scene."""
    rng = np.random.default_rng(SEED)
    pts, rgb = read_ply_points(data / "sparse.ply")
    pick = rng.integers(0, len(pts), n)
    xyz = (pts[pick] + rng.normal(0.0, jitter, (n, 3))).astype(np.float32)
    write_ply(data / "sparse.ply", {"vertex": {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "red": rgb[pick, 0], "green": rgb[pick, 1], "blue": rgb[pick, 2],
    }})


def trainer_phase(work_dir: Path, counters) -> dict:
    """Phase 11: the trainer's CLI on a synthetic dataset, in process."""
    phase("11 trainer path: gstk_torch.scripts.train, 400 steps at 800x800")
    t0 = time.perf_counter()
    data = generate_synthetic_dataset(
        work_dir / "synthetic", n_points=SYN_POINTS, n_views=SYN_VIEWS,
        img_wh=(W, H), seed=SEED, device=DEVICE,
    )
    write_seed_cloud(data, SEED_POINTS)
    print(f"synthetic dataset: {SYN_POINTS} points, {SYN_VIEWS} views at "
          f"{W}x{H}, no view over the generator's {ISECT_CAPACITY} "
          f"intersections (it raises otherwise); seed cloud {SEED_POINTS} "
          f"points; {time.perf_counter() - t0:.1f} s")
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    trainer = train_main([
        "--device", DEVICE, "gaussian-splatting", "--data", str(data),
        "--output-dir", str(work_dir / "runs"),
        "--max-num-iterations", str(TRAIN_ITERS),
        "--model.num-downscales", "0", "--model.sh-degree-interval", "100",
        "--model.warmup-length", "100", "--steps-per-eval-image", "100",
        "--steps-per-eval-all-images", "400", "--steps-per-save", "400",
        "--dataparser.eval-mode", "interval", "--dataparser.eval-interval", "8",
    ])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    print(f"trainer run {run_s:.1f} s (setup, {TRAIN_ITERS} steps, evals, "
          f"checkpoints); launches {launches}")
    for name, n in launches.items():
        assert n >= 1, f"{name} not launched by the trainer"

    run_dir = trainer.config.run_dir
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]
    col = lambda key: [(r["step"], r[key]) for r in rows if key in r]
    losses, alive = col("loss"), col("num_alive")
    assert losses and all(math.isfinite(v) for _, v in losses), "loss not finite"
    assert alive[0][1] != alive[-1][1], "num_alive never changed"
    images = col("eval_image_psnr")
    final_eval = col("eval_psnr")[-1]
    print(f"num_alive {alive[0][1]:.0f} -> {alive[-1][1]:.0f}; loss "
          f"{losses[0][1]:.5f} -> {losses[-1][1]:.5f}; eval_image PSNR "
          f"{[(s, round(v, 3)) for s, v in images]} (step, dB), final eval "
          f"PSNR {final_eval[1]:.3f} (step {final_eval[0]})")
    # the amortized wall time per step of each log window; the first holds
    # the caching of the train split
    iter_ms = [v * 1e3 for _, v in col("Train Iter (time)")][1:]
    step_ms = {"median": statistics.median(iter_ms), "min": min(iter_ms),
               "max": max(iter_ms), "windows": len(iter_ms)}
    print(f"trainer per-step wall time (ITER_TRAIN_TIME over "
          f"{len(iter_ms)} log windows after the first): median "
          f"{step_ms['median']:.3f} ms, min {step_ms['min']:.3f}, max "
          f"{step_ms['max']:.3f}")

    # the final checkpoint, rendered by the Renderer as the trainer renders it
    frame = trainer.datamanager.eval_frames[0]
    assert frame.image.shape == (H, W, 4)  # the generator writes RGBA
    gt = frame.image[..., :3] * frame.image[..., 3:] + (
        1.0 - frame.image[..., 3:]) * np.asarray(EVAL_BACKGROUND, np.float32)
    psnr = lambda pred: float(-10.0 * np.log10(np.mean((pred - gt) ** 2)))
    renderer = Renderer(run_dir, background=EVAL_BACKGROUND, device=DEVICE)
    out = renderer.get_output_from_pose(frame.c2w, frame.fx, frame.fy,
                                        frame.cx, frame.cy, H, W)
    assert np.isfinite(out["rgb"]).all() and out["accumulation"].mean() > 0.01
    ckpt_psnr = psnr(out["rgb"])
    own_psnr = psnr(trainer._render_eval(frame)["rgb"].cpu().numpy())
    print(f"checkpoint step {renderer.step} through Renderer: eval view 0 PSNR "
          f"{ckpt_psnr:.4f}, the trainer's own render {own_psnr:.4f}")
    assert abs(ckpt_psnr - own_psnr) < 0.01, "the checkpoint renders otherwise"
    del renderer

    frames = trainer.datamanager.eval_frames
    eval_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._score_views(frames)
        torch.cuda.synchronize()
        eval_ms.append((time.perf_counter() - t0) * 1e3 / len(frames))
    print(f"eval_all per view: {[round(x, 3) for x in eval_ms]} ms over "
          f"{len(frames)} views (synchronized)")

    trainer_vs_plain(trainer)
    cache_numbers = cache_check(trainer)
    png_numbers = png_check(work_dir)
    refine_numbers = refine_check(trainer)
    grow_numbers = grow_check(trainer)
    loaded = [m for m in ("PIL", "cv2", "yaml") if m in sys.modules]
    assert not loaded, f"the trainer path imported {loaded}"
    # read; left in place, the profiler's exit report would print after
    # the last line
    PROFILER.totals.clear()
    PROFILER.counts.clear()
    assert final_eval[1] > images[0][1], (
        f"the final eval ({final_eval[1]:.3f} dB) is no better than the "
        f"first eval_image ({images[0][1]:.3f} dB at step {images[0][0]})")
    return {"launches": launches, "run_s": run_s, "step_ms": step_ms,
            "eval_all_ms_per_view": statistics.median(eval_ms),
            "num_alive": [alive[0][1], alive[-1][1]],
            "eval_image_psnr": images, "final_eval_psnr": final_eval[1],
            "final_eval_ssim": col("eval_ssim")[-1][1],
            **cache_numbers, **png_numbers, **refine_numbers, **grow_numbers}


def trainer_vs_plain(trainer) -> None:
    """One trainer step from the trained state through the kernels (the
    trainer's own step function) against the same step through the plain
    twins (``backend="plain"``, the trainer's raster config otherwise),
    from one carried-over state and one generator state (the random
    background), with phase 10's tolerances; then one eval render both
    ways, with phase 6's."""
    cfg = trainer.config
    step = int(trainer.state.step)
    sh = trainer._sh_degree(step)
    plain_raster = dataclasses.replace(trainer.raster_cfg, backend="plain")
    fns = (trainer._step_fn(H, W, sh, False),
           make_train_step(cfg.model, plain_raster, cfg.optim, H, W, sh))
    idx, frame = trainer.datamanager.next_train()
    inputs = trainer._train_inputs(idx, frame, 1)
    before = train_state_to_numpy(trainer.state)
    gen_state = trainer.generator.get_state()
    outs = []
    for fn in fns:
        gen = torch.Generator(device=DEVICE)
        gen.set_state(gen_state)
        s, m = fn(train_state_from_numpy(before, DEVICE), *inputs[:2], gen,
                  *inputs[2:])
        torch.cuda.synchronize()
        outs.append((train_state_to_numpy(s), m))
    (got, m_k), (want, m_p) = outs
    print(f"trainer step {step} ({int(m_k['num_intersects'])} intersections "
          f"of {trainer.raster_cfg.isect_capacity}):", end=" ")
    compare_steps(m_k, m_p, before, got, want, cfg.optim, step)

    frame = trainer.datamanager.eval_frames[0]
    setting = trainer._eval_setting()
    got = trainer._render_eval(frame, setting)
    saved, trainer.raster_cfg = trainer.raster_cfg, plain_raster
    want = trainer._render_eval(frame, setting)
    trainer.raster_cfg = saved
    errs = {}
    for k in ("rgb", "depth", "alpha"):
        assert_close(f"trainer eval render {k}", got[k], want[k], **PARITY)
        errs[k] = float((got[k] - want[k]).abs().max())
    print(f"trainer eval render vs plain twins: max abs err {errs}")


def refine_runs(flat, cfg, num_train, img_size, device, step=None,
                reps=1, noise=None):
    """``refine`` from the carried-over state ``flat`` on ``device`` at
    ``step`` (the state's when None), ``reps`` times, each from a fresh
    copy and synchronized; the noise is one seed-0 draw when not given.
    Returns the last state, its ``info`` and the times in ms."""
    if noise is None:
        cap = flat[".scene/.means"].shape[0]
        noise = torch.randn((cfg.n_split_samples, cap, 3),
                            generator=torch.Generator().manual_seed(SEED))
    step = int(flat[".step"]) if step is None else step
    ms = []
    for _ in range(reps):
        s = train_state_from_numpy(flat, device)
        n = noise.to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, info = refine(s.scene, s.adam, s.refine, step, cfg,
                               num_train, img_size, noise=n)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return s, {k: v.item() for k, v in info.items()}, ms


def refine_check(trainer) -> dict:
    """``refine`` at the trained capacity: 20 more steps (timed one by
    one, synchronized) give it statistics, and one more, traced, the
    trainer step's device idle share; then from that state and one noise
    draw, on the card (timed, synchronized) and on the CPU, which must
    agree: equal alive masks and ``info``, parameters within rtol 1e-6
    (means within 1e-6 of the largest ``|mean|``: a child's mean sums its
    parent's and an offset whose ``exp`` rounds differently on the two
    devices)."""
    step_fn = trainer._step_fn(H, W, trainer._sh_degree(TRAIN_ITERS), False)
    step_ms = []
    for _ in range(20):
        idx, frame = trainer.datamanager.next_train()
        t0 = time.perf_counter()
        inputs = trainer._train_inputs(idx, frame, 1)
        trainer.state, _ = step_fn(trainer.state, *inputs[:2],
                                   trainer.generator, *inputs[2:])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"trainer step at the trained state: median "
          f"{statistics.median(step_ms):.3f} ms, min {min(step_ms):.3f} "
          f"(host clock, synchronized, 20 steps)")
    trace("trainer step", lambda: step_fn(trainer.state, *inputs[:2],
                                          trainer.generator, *inputs[2:]))
    flat = train_state_to_numpy(trainer.state)
    cap = trainer.state.scene.capacity
    args = (trainer.config.model, trainer.datamanager.num_train,
            max(trainer.datamanager.image_size))
    got, got_info, refine_ms = refine_runs(flat, *args, DEVICE,
                                           reps=REFINE_TIMES)
    want, want_info, cpu_ms = refine_runs(flat, *args, "cpu")
    print(f"refine at step {int(flat['.step'])}, capacity {cap}: card "
          f"{[round(x, 3) for x in refine_ms]} ms (synchronized), CPU "
          f"{cpu_ms[0]:.1f} ms; info {want_info}")
    assert got_info == want_info, f"refine info: card {got_info}, CPU {want_info}"
    assert want_info["num_split"] + want_info["num_dup"] > 0, "nothing densified"
    got, want = train_state_to_numpy(got), train_state_to_numpy(want)
    flips = int((got[".scene/.alive"] != want[".scene/.alive"]).sum())
    assert flips == 0, f"refine alive masks differ in {flips} lanes"
    means_atol = 1e-6 * float(np.abs(want[".scene/.means"]).max())
    worst = 0.0
    for k, v in want.items():
        atol = means_atol if k == ".scene/.means" else 1e-7
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=atol, err_msg=k)
        worst = max(worst, float(np.abs(got[k].astype(np.float64) - v).max()))
    print(f"refine card vs CPU: alive masks and info equal, max abs diff {worst:.3g}")
    return {"synced_step_ms": statistics.median(step_ms),
            "refine_ms": statistics.median(refine_ms),
            "refine_cpu_ms": cpu_ms[0], "refine_capacity": cap,
            "refine_alive": int(want[".scene/.alive"].sum()),
            "refine_info": want_info}


def grow_check(trainer) -> dict:
    """Each capacity growth of the run (host clock, from the trainer's
    profiler), then forced growths up to ``max_capacity`` (2^21 by
    default), each synchronized, and ``refine`` at that capacity."""
    grew = PROFILER.counts.get("grow_capacity", 0)
    in_run = PROFILER.totals.get("grow_capacity", 0.0) / max(grew, 1) * 1e3
    forced = []
    while trainer.state.scene.capacity < trainer.config.max_capacity:
        cap = trainer.state.scene.capacity
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._maybe_grow({"num_alive": cap, "num_intersects": 0})
        torch.cuda.synchronize()
        forced.append((cap, trainer.state.scene.capacity,
                       (time.perf_counter() - t0) * 1e3))
        assert trainer.state.scene.capacity > cap, "forced growth did not grow"
    print(f"capacity growth: {grew} in the run ({in_run:.3f} ms each, host "
          f"clock); forced after it (from, to, ms): {forced}")
    cap = trainer.state.scene.capacity
    _, info, ms = refine_runs(
        train_state_to_numpy(trainer.state), trainer.config.model,
        trainer.datamanager.num_train, max(trainer.datamanager.image_size),
        DEVICE, reps=REFINE_TIMES)
    print(f"refine at capacity {cap}: {[round(x, 3) for x in ms]} ms "
          f"(synchronized); info {info}")
    return {"grew_in_run": grew, "grow_in_run_ms": in_run if grew else None,
            "grow_forced_ms": forced, "refine_max_capacity": cap,
            "refine_max_capacity_ms": statistics.median(ms)}


def cache_check(trainer) -> dict:
    """The d = 4 bucket of the trained split (gs-train's default
    coarse-to-fine start; phase 11 trains at d = 1): built on the card
    after the d = 1 bucket is dropped, with the device peak over the bytes
    allocated before; the peak must stay under what the trainer's budget
    check counts (``train_cache_bytes``), and the bucket must equal the
    per-frame path and ``area_downscale`` of the whole stack bit for bit.
    Beside it, how far the build before the repair (the uint8 stack
    uploaded whole, divided by the host scalar 255, downscaled at once)
    lies from it."""
    frames = trainer.datamanager.train_frames
    shape = frames[0].image.shape
    checked = train_cache_bytes(len(frames), shape, 4,
                                frames[0].mask is not None,
                                frames[0].depth is not None)
    trainer._dev_cache = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, imgs, *_ = trainer._device_train_cache(4)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    kept = imgs.numel() * imgs.element_size()
    stack_np = np.stack([f.image for f in frames])
    full_stack = stack_np.size * 4
    print(f"train cache at d = 4: {len(frames)} frames {shape} -> "
          f"{tuple(imgs.shape)}, {build_ms:.1f} ms; device peak {peak / 2**20:.2f} "
          f"MiB over the {base / 2**20:.1f} MiB before, bucket {kept / 2**20:.2f} "
          f"MiB, checked {checked / 2**20:.2f} MiB, the full-resolution f32 "
          f"stack {full_stack / 2**20:.2f} MiB")
    assert peak <= checked, f"the build peaked at {peak} B over the {checked} B checked"
    for i in (0, len(frames) - 1):
        gt = trainer._frame_to_device(frames[i], 4)[1]
        assert torch.equal(imgs[i], gt), f"bucket frame {i} differs from the per-frame path"
    stack = torch.from_numpy(stack_np).to(DEVICE)
    assert torch.equal(imgs, area_downscale(stack, 4)), (
        "the bucket differs from area_downscale of the whole stack")
    before = torch.from_numpy(np.rint(stack_np * 255).astype(np.uint8)).to(DEVICE)
    before = area_downscale(before.to(torch.float32) / 255.0, 4)
    diff = float((imgs - before).abs().max())
    print(f"bucket equals the per-frame path and one product over the stack; "
          f"the build before the repair differs by up to {diff:.3g}")
    del stack, before, imgs
    trainer._dev_cache = {}
    return {"cache_d4": {"peak_bytes": peak, "checked_bytes": checked,
                         "bucket_bytes": kept, "full_stack_bytes": full_stack,
                         "build_ms": build_ms, "before_repair_max_diff": diff}}


def png_check(work_dir: Path) -> dict:
    """``read_png`` on an 800x800 RGB PNG of photo-like content whose rows
    are all Paeth-filtered, built here with numpy and zlib (the card's
    machine has no Pillow): bit-exact, and its host time (median of 3)."""
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:H, 0:W]
    shade = 60.0 * np.sin(0.05 * xx + 0.03 * yy)[..., None] * [1.0, 0.8, 0.6]
    img = np.clip(128 + shade + rng.normal(0, 2, (H, W, 3)), 0, 255).astype(np.uint8)
    x = img.reshape(H, -1).astype(np.int16)
    a = np.pad(x, ((0, 0), (3, 0)))[:, :-3]  # left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]  # up
    c = np.pad(a, ((1, 0), (0, 0)))[:-1]  # up-left
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((H, 1), 4, np.uint8),
                           ((x - pred) % 256).astype(np.uint8)], axis=1)
    chunk = lambda tag, data: (len(data).to_bytes(4, "big") + tag + data
                               + zlib.crc32(tag + data).to_bytes(4, "big"))
    path = work_dir / "paeth.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", W.to_bytes(4, "big") + H.to_bytes(4, "big")
                             + bytes([8, 2, 0, 0, 0]))
                     + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                     + chunk(b"IEND", b""))
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = read_png(path)
        ms.append((time.perf_counter() - t0) * 1e3)
    assert np.array_equal(got, img), "read_png differs on the Paeth PNG"
    print(f"read_png, {W}x{H} RGB, every row Paeth: bit-exact, "
          f"{[round(v, 2) for v in ms]} ms (host clock)")
    return {"read_png_paeth_ms": statistics.median(ms)}


def check_ablation(records, gids, bins, tiles_x, variants) -> dict:
    """Each P1 clone in ``variants`` against its plain twin on the card
    (rtol 1e-3 / atol 1e-4; ``dmaonly``, whose sum the twin takes in the
    kernel's order, rtol 1e-6), ``full`` and ``marg_none`` against K1 and
    ``noexit`` against ``full`` bit for bit. Returns each clone's largest
    difference from its twin."""
    xys, conics, op, colors = (records[:, 0:2], records[:, 2:5], records[:, 5],
                               records[:, 6:6 + ablate_fwd.KERNEL_CH])
    tiles = (tiles_x, bins.shape[0] // tiles_x)
    k1_out = composite_tiles_fwd(xys, conics, op, colors, gids, bins, tiles,
                                 records=records)
    outs, errs = {}, {}
    for variant in variants:
        outs[variant] = ablate_fwd.run_variant(variant, records, gids, bins, tiles_x)
        twin = ablate_fwd.ablate_fwd_plain(variant, records, gids, bins, tiles_x)
        tol = dict(rtol=1e-6, atol=0.0) if variant == "dmaonly" else PARITY
        for name, got, want in zip(("acc", "final_t"), outs[variant], twin):
            assert_close(f"P1 {variant} {name}", got, want, **tol)
        errs[variant] = max(float((g - w).abs().max())
                            for g, w in zip(outs[variant], twin))
    for variant, ref in (("full", k1_out), ("marg_none", k1_out),
                         ("noexit", outs["full"])):
        if variant in outs:
            assert all(torch.equal(g, w) for g, w in zip(outs[variant], ref)), (
                f"P1 {variant} is not bit-identical to its reference")
    return errs


def projection_scene(dev) -> GaussianScene:
    """PROJ_LANES lanes at SH degree 3, the first PROJ_ALIVE alive, drawn on
    the card from the seed: phase 3's box of means in front of its camera,
    log scales from -6 to -2.5, random rotations, opacities and colours."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    n = PROJ_LANES
    u = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(
        shape, generator=g, device=dev)
    means = torch.stack([u(-3.0, 3.0, n), u(-3.0, 3.0, n), u(-9.0, -2.0, n)], -1)
    rest_rows = (SH_DEGREE + 1) ** 2 - 1
    return GaussianScene(
        means=means, scales=u(-6.0, -2.5, n, 3),
        quats=torch.randn((n, 4), generator=g, device=dev),
        features_dc=u(-1.5, 1.5, n, 3),
        features_rest=0.3 * torch.randn((n, rest_rows, 3), generator=g,
                                        device=dev),
        opacities=u(-2.0, 3.0, n, 1),
        alive=torch.arange(n, device=dev) < PROJ_ALIVE)


def lane_errors(got, exact):
    """Per lane, the largest |got - exact| over the lane's largest |exact|
    (tests/test_torch_gpu.py's measure)."""
    got = got.reshape(got.shape[0], -1).double()
    exact = exact.reshape(exact.shape[0], -1).double()
    return (got - exact).abs().amax(1) / (exact.abs().amax(1) + 1e-30)


def projection_phase(dev, camera, iters: int) -> dict:
    """Phase 10(b): PF and PB (``ops/project_cuda.py``) at the main path's
    lanes and SH degree, 800x800, antialiased, against
    ``splat_inputs_plain`` on the same inputs at the gpu tests'
    tolerances: the float outputs within rtol 1e-5 / atol 1e-6, radii and
    tile counts equal on all but 0.001% of lanes and never more than 1
    apart; the six gradients of a random weighting of the float outputs
    against the plain path in f64, the kernels' per-lane error within 1.5x
    the plain f32 path's at the median and 99th percentile and 20x at the
    worst lane; the view matrices' gradients (camera optimisation) within
    4x the plain path's error plus 1e-5. PF once and PB once, as counted.
    Then both kernels timed (profiler, events) beside the plain path's
    forward and its backward alone, with their bytes at the HBM's rate."""
    phase("10b projection kernels PF and PB at 2^21 lanes vs splat_inputs_plain")
    t0 = time.perf_counter()
    config = VanillaConfig(sh_degree=SH_DEGREE, rasterize_mode="antialiased")
    scene = projection_scene(dev)
    exact = GaussianScene(**{k: getattr(scene, k).detach().double()
                             for k in project_cuda.PARAM_NAMES},
                          alive=scene.alive)
    cam64 = Camera(*(getattr(camera, k).double()
                     for k in ("fx", "fy", "cx", "cy", "c2w")))
    viewmat, fullmat = cameras_mod.camera_matrices(camera, H, W)
    setting = project_cuda.Setting(H, W, 16, SH_DEGREE, False, True)
    params = [getattr(scene, k) for k in project_cuda.PARAM_NAMES]
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    floats = ("xys", "depths", "conics", "colors", "opacities")
    weights = {}
    outs, grads, view_grads = {}, {}, {}
    for run in ("kernels", "plain", "f64"):
        dtype = torch.float64 if run == "f64" else torch.float32
        vm, fm = (m.detach().to(dtype).requires_grad_()
                  for m in (viewmat, fullmat))
        sc = exact if run == "f64" else scene
        for f in (project_fwd, project_bwd):
            f.launches = 0
        if run == "kernels":
            out = project_cuda.project_splats(
                sc, sc.alive, project_cuda.view_params(camera, vm, fm),
                setting)
        else:
            out = vanilla_mod.splat_inputs_plain(
                sc, cam64 if run == "f64" else camera, vm, fm, sc.alive, H, W,
                sh_degree=SH_DEGREE, config=config)
        for k in floats:
            if k not in weights:
                weights[k] = torch.randn(out[k].shape, generator=g, device=dev)
        loss = sum((out[k] * weights[k].to(dtype)).sum() for k in floats)
        wrt = [getattr(sc, k) for k in project_cuda.PARAM_NAMES]
        got = torch.autograd.grad(loss, [*wrt, vm, fm])
        grads[run] = got[:-2]
        view_grads[run] = (got[-2][:3], got[-1])
        outs[run] = {k: v.detach() for k, v in out.items()}
        if run == "kernels":
            assert (project_fwd.launches, project_bwd.launches) == (1, 1), (
                project_fwd.launches, project_bwd.launches)
        del out, loss
    fused, plain = outs["kernels"], outs["plain"]
    fwd_err = 0.0
    for k in floats:
        assert_close(f"PF {k}", fused[k], plain[k], rtol=1e-5, atol=1e-6)
        fwd_err = max(fwd_err, float((fused[k] - plain[k]).abs().max()))
    flips = {}
    for k in ("radii", "num_tiles_hit"):
        diff = (fused[k] - plain[k]).abs()
        flips[k] = int((diff > 0).sum())
        assert flips[k] <= 1e-5 * PROJ_LANES and int(diff.max()) <= 1, (k, flips)
    visible = int((plain["radii"] > 0).sum())
    assert 0.05 * PROJ_ALIVE < visible <= PROJ_ALIVE, visible
    lane_err = {}
    for name, got, want, ref in zip(project_cuda.PARAM_NAMES, grads["kernels"],
                                    grads["plain"], grads["f64"]):
        e_got, e_plain = lane_errors(got, ref), lane_errors(want, ref)
        q = torch.tensor([0.5, 0.99], dtype=torch.float64, device=dev)
        qg, qp = torch.quantile(e_got, q).tolist(), torch.quantile(e_plain, q).tolist()
        worst = (float(e_got.max()), float(e_plain.max()))
        lane_err[name] = {"kernels_p50_p99_max": [*qg, worst[0]],
                          "plain_p50_p99_max": [*qp, worst[1]]}
        assert all(a <= 1.5 * b + 1e-7 for a, b in zip(qg, qp)), (name, lane_err[name])
        assert worst[0] <= 20 * worst[1] + 1e-7, (name, lane_err[name])
        assert float(ref.abs().max()) > 0, name
    bwd_err = max(float((a - b).abs().max())
                  for a, b in zip(grads["kernels"], grads["plain"]))
    view_err = {}
    for j, name in enumerate(("viewmat", "fullmat")):
        got, want, ref = (view_grads[r][j] for r in ("kernels", "plain", "f64"))
        norm = lambda x: float(x.double().norm())
        err = (norm(got.double() - ref) / norm(ref),
               norm(want.double() - ref) / norm(ref))
        view_err[name] = err
        assert err[0] <= 4 * err[1] + 1e-5, (name, err)
    print(f"{PROJ_LANES} lanes ({PROJ_ALIVE} alive, {visible} visible), SH "
          f"{SH_DEGREE}, {W}x{H}, antialiased: PF max abs err {fwd_err:.3g}, "
          f"radii / tile counts differing on {flips} lanes; gradient error a "
          f"lane against f64 (p50, p99, max; kernels and plain) {lane_err}; "
          f"view gradients' error against f64 (kernels, plain) {view_err}")
    del outs, grads, view_grads, exact

    # timings: the wrappers and kernels alone, the plain forward, and the
    # plain backward alone (its graph kept across calls)
    alive = scene.alive
    view = project_cuda.view_params(camera, viewmat, fullmat)
    with torch.no_grad():
        cot = [torch.randn(x.shape, generator=g, device=dev) for x in (
            plain["xys"], plain["depths"], plain["conics"], plain["colors"],
            plain["opacities"])]
    pf = lambda: project_fwd([p.detach() for p in params], alive, view, setting)
    pb = lambda: project_bwd([p.detach() for p in params], alive, view, cot,
                             setting)
    alive_plain = scene.alive

    def plain_fwd():
        with torch.no_grad():
            return vanilla_mod.splat_inputs_plain(
                scene, camera, viewmat, fullmat, alive_plain, H, W,
                sh_degree=SH_DEGREE, config=config)

    graph = vanilla_mod.splat_inputs_plain(
        scene, camera, viewmat, fullmat, alive_plain, H, W,
        sh_degree=SH_DEGREE, config=config)
    graph_loss = sum((graph[k] * c).sum() for k, c in zip(floats, cot))
    plain_bwd = lambda: torch.autograd.grad(graph_loss, params,
                                            retain_graph=True)
    fwd = {**kernel_device_ms(pf, "project_fwd_kernel", iters),
           "wrapper_ms": event_ms(pf, iters), "plain_ms": event_ms(plain_fwd, 5),
           "library_ms": None}
    bwd = {**kernel_device_ms(pb, "project_bwd_kernel", iters),
           "wrapper_ms": event_ms(pb, iters), "plain_ms": event_ms(plain_bwd, 5),
           "library_ms": None}
    del graph, graph_loss
    rest = 4 * 3 * ((SH_DEGREE + 1) ** 2 - 1)
    lane_in = 12 + 12 + 16 + 4 + 12 + rest + 1  # the parameters and alive
    lane_out = 8 + 4 + 4 + 12 + 4 + 16 + 4  # the seven outputs
    lane_cot = 8 + 4 + 12 + 16 + 4  # xys, depths, conics, colors, opacities
    lane_grads = 12 + 12 + 16 + 12 + rest + 4
    fwd_bytes = PROJ_LANES * (lane_in + lane_out)
    bwd_bytes = PROJ_LANES * (lane_in + lane_cot + lane_grads)
    print(f"PF {fwd}\nPB {bwd}\nbytes PF {fwd_bytes} PB {bwd_bytes}; "
          f"{time.perf_counter() - t0:.1f} s")
    return {"fwd": fwd, "bwd": bwd, "fwd_bytes": fwd_bytes,
            "bwd_bytes": bwd_bytes, "fwd_err": fwd_err, "bwd_err": bwd_err,
            "numbers": {"lanes": PROJ_LANES, "alive": PROJ_ALIVE,
                        "visible": visible, "flips": flips,
                        "lane_errors": lane_err, "view_errors": view_err}}


def adam_phase(dev, iters: int) -> dict:
    """Phase 10(c): AF (``train/adam_cuda.py``) at the main path's lanes
    and SH degree, a tenth of the lanes dead with NaN gradients, against
    ``adam_step_plain`` on copies of one state: the parameters, moments
    and count bit for bit after one step at each of ``ADAM_STEPS`` (the
    count equal to the step), after one step with a norm clip through
    ``adam_step`` (the scales computed on the device), and for the camera
    group (``ADAM_CAMERAS`` x 6, no mask, CameraOptConfig's decay) at step
    29,998 from counts 1 and 29,998; AF once a call, as counted. Then AF
    timed (profiler, events) beside the plain step, with its bytes at the
    HBM's rate: 28 B an element (p, g, m and v read; p, m and v
    written)."""
    phase("10c Adam kernel AF at 2^21 lanes vs adam_step_plain")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    draw = lambda shape, scale: scale * torch.randn(shape, generator=g,
                                                    device=dev)

    def state_of(rows, lanes):
        shapes = {k: (lanes, *r) for k, r in rows.items()}
        return ({k: draw(s, 1.0) for k, s in shapes.items()},
                {k: draw(s, 1e-2) for k, s in shapes.items()},
                {k: draw(s, 1e-3) for k, s in shapes.items()},
                {k: draw(s, 1e-2).square() for k, s in shapes.items()})

    def twins(fused, state, step, count, config, mask=None):
        params, grads, mu, nu = state
        runs = []
        for fn in (fused, adam_step_plain):
            p = {k: v.clone() for k, v in params.items()}
            st = AdamState(
                count=torch.tensor(count, dtype=torch.int32, device=dev),
                mu={k: v.clone() for k, v in mu.items()},
                nu={k: v.clone() for k, v in nu.items()})
            adam_fused.launches = 0
            st = fn(p, grads, st, torch.tensor(step, dtype=torch.int32,
                                               device=dev), config, mask)
            torch.cuda.synchronize()
            runs.append((p, st, adam_fused.launches))
        (p0, s0, n0), (p1, s1, n1) = runs
        assert (n0, n1) == (1, 0), (n0, n1)
        assert int(s0.count) == int(s1.count) == count + 1
        for k in p1:
            for what, a, b in (("p", p0, p1), ("m", s0.mu, s1.mu),
                               ("v", s0.nu, s1.nu)):
                diff = int((a[k] != b[k]).sum())
                assert diff == 0, (
                    f"AF {k} {what} at step {step}: {diff} elements differ, "
                    f"the most by {float((a[k] - b[k]).abs().max())}")
        return p0

    scene = state_of(ADAM_ROWS, PROJ_LANES)
    alive = torch.rand(PROJ_LANES, generator=g, device=dev) > 0.1
    for v in scene[1].values():
        v[~alive] = float("nan")
    cfg = OptimizerConfig()
    for step in ADAM_STEPS:
        moved = twins(adam_fused, scene, step, step, cfg, alive)
        assert torch.equal(moved["means"][~alive], scene[0]["means"][~alive])
    twins(adam_step, scene, 12_093, 12_093, OptimizerConfig(max_norm=16.0),
          alive)
    cam = CameraOptConfig(mode="SO3xR3")
    cam_cfg = OptimizerConfig(
        lrs=(("camera_opt", cam.lr),),
        extra_exp=(("camera_opt", cam.lr_final, cam.max_steps),))
    camera_state = state_of({"camera_opt": (6,)}, ADAM_CAMERAS)
    for count in (1, 29_998):
        twins(adam_fused, camera_state, 29_998, count, cam_cfg)
    print(f"AF bit for bit against adam_step_plain: {PROJ_LANES} lanes "
          f"({int(alive.sum())} alive), steps {ADAM_STEPS}, a norm clip at "
          f"12,093, the camera group from counts 1 and 29,998")

    params, grads, mu, nu = scene
    state = AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=mu, nu=nu)
    step = torch.tensor(12_093, dtype=torch.int32, device=dev)
    af = lambda: adam_fused(params, grads, state, step, cfg, alive)
    plain = lambda: adam_step_plain(params, grads, state, step, cfg, alive)
    t = {**kernel_device_ms(af, "adam_fused_kernel", iters),
         "wrapper_ms": event_ms(af, iters), "plain_ms": event_ms(plain, 5),
         "library_ms": None}
    elements = PROJ_LANES * sum(math.prod(r) for r in ADAM_ROWS.values())
    nbytes = 28 * elements
    print(f"AF {t}\nbytes {nbytes} ({elements} elements); "
          f"{time.perf_counter() - t0:.1f} s")
    return {"t": t, "bytes": nbytes,
            "numbers": {"lanes": PROJ_LANES, "alive": int(alive.sum()),
                        "elements": elements, "steps": list(ADAM_STEPS),
                        "bit_equal": True}}


def probes_phase(k1_render, k1_ms, k1_bytes, k1_ops):
    """Phase 12: the probes' entry points with their launch counters reset
    just before (P1 at the tool's two shapes, P2 and P3 at n = 2^20), then
    P1's checks at both shapes and ``full``, ``noexit`` and ``dmaonly`` on
    K1's render inputs ``k1_render`` (records, gids, tile bins, tiles_x)
    beside K1's time. Returns the probes' ``kernels`` entries and the
    numbers behind them."""
    phase("12 probes: P1 K1 ablation clones, P2 and P3 row scatters")
    counters = (ablate_fwd.run_variant, bench_dynrow.local_perm,
                bench_dynrow.dynwrite)
    for f in counters:
        f.launches = 0
    p1 = ablate_fwd.main(["--device", DEVICE])
    p23 = bench_dynrow.main(["--device", DEVICE])
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in counters}
    print(f"launches in the probes' run: {launches}")
    for name, n in launches.items():
        assert n >= 1, f"{name} not launched by the probes"
    assert sum(r["launches"] for r in p1.values()) == launches["run_variant"]

    ch = ablate_fwd.KERNEL_CH
    bound = lambda nbytes, ops: max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S) * 1e3
    bound_by = lambda nbytes, ops: ("bytes" if nbytes / HBM_BYTES_PER_S
                                    >= ops / F32_FLOP_PER_S else "operations")
    entries, numbers = [], {"p1": {}, "p23": {}}
    for c_per_tile, shape in p1.items():
        records, gids, bins, tiles_x = ablate_fwd.probe_scene(c_per_tile, device=DEVICE)
        errs = check_ablation(records, gids, bins, tiles_x, ablate_fwd.VARIANTS)
        tiles = (tiles_x, 1)
        xys, conics, op, colors = (records[:, 0:2], records[:, 2:5], records[:, 5],
                                   records[:, 6:6 + ch])
        _, _, visited = composite_tiles_fwd_plain(xys, conics, op, colors, gids,
                                                  bins, tiles)
        pairs = int(visited.sum())
        assert pairs == gids.shape[0] * 256, "a pixel of the probe scene stopped"
        nbytes = (gids.shape[0] * (4 + 4 * (6 + ch)) + tiles_x * 8
                  + tiles_x * 256 * (ch + 1) * 4)
        ops = pairs * K1_FLOP_PER_PAIR
        variants_ms = {v: t["ms"] for v, t in shape["variants"].items()}
        plain_ms = event_ms(lambda: ablate_fwd.ablate_fwd_plain(
            "full", records, gids, bins, tiles_x), 1)
        label = f"T={tiles_x} C={c_per_tile}"
        print(f"P1 {label}: every clone within its twin's tolerance "
              f"{ {v: f'{e:.3g}' for v, e in errs.items()} }; full and "
              f"marg_none equal K1, noexit equals full; {pairs} pairs; ms "
              f"{ {v: round(m, 5) for v, m in variants_ms.items()} }")
        entries.append({
            "name": f"ablate_fwd {label}", "route": "cuda",
            "source": "gstk_torch/csrc/ablate_fwd.cu",
            "replaces": "tools/ablate_fwd.py:34", "launches": shape["launches"],
            "max_abs_err": errs["full"], "max_err": max(errs.values()),
            "ms": variants_ms["full"], "variants_ms": variants_ms,
            "plain_ms": plain_ms, "bound_ms": bound(nbytes, ops),
            "bound_by": bound_by(nbytes, ops), "bytes": nbytes,
            "operations": ops, "library_ms": None,
        })
        numbers["p1"][label] = {"variants_ms": variants_ms, "errors": errs,
                                "pairs": pairs}

    # K1's gap at the render point: staging floor and loop control
    records, gids, bins, tiles_x = k1_render
    render_vars = ("full", "noexit", "dmaonly")
    errs = check_ablation(records, gids, bins, tiles_x, render_vars)
    render_ms = {v: kernel_device_ms(
        lambda v=v: ablate_fwd.run_variant(v, records, gids, bins, tiles_x),
        "ablate_fwd_kernel", 20)["ms"] for v in render_vars}
    gap = {"k1_ms": k1_ms, "variants_ms": render_ms, "errors": errs,
           "bound_ms": bound(k1_bytes, k1_ops),
           "staging_share": render_ms["dmaonly"] / render_ms["full"],
           "noexit_minus_full_ms": render_ms["noexit"] - render_ms["full"]}
    print(f"P1 at the render point: {gap}")
    numbers["p1"]["render point"] = gap

    for tag, r in p23.items():
        if tag == "A_gather":
            numbers["p23"][tag] = {"ms": r["library"]["ms"]}
            continue
        R, rows = r["case"]
        n = bench_dynrow.ROWS_CARD
        nbytes = n * bench_dynrow.ROW * 4 * 2 + n // rows * 4
        kind, label = (("local_perm", f"R={R} g={rows}") if tag.startswith("B")
                       else ("dynwrite", f"R={R} W={rows}"))
        entries.append({
            "name": f"{kind} {label}", "route": "cuda",
            "source": "gstk_torch/csrc/dynrow.cu",
            "replaces": ("tools/bench_dynrow.py:103" if kind == "local_perm"
                         else "tools/bench_dynrow.py:193"),
            "launches": r["launches"], "max_abs_err": 0.0, "max_err": 0.0,
            "ms": r["kernel"]["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound(nbytes, 0), "bound_by": "bytes", "bytes": nbytes,
            "operations": 0, "library_ms": r["library"]["ms"],
            "gather_ms": p23["A_gather"]["library"]["ms"],
        })
        numbers["p23"][tag] = {k: entries[-1][k] for k in
                               ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"P2 / P3 (ms): {numbers['p23']}")
    return entries, numbers


def backend_phase(work_dir: Path, trained: dict) -> dict:
    """Phase 13: gs-eval, gs-render and gs-export on phase 11's run
    directory (its step-400 checkpoint), through the CLIs' ``main``."""
    phase("13 back end: gs-eval, gs-render and gs-export on phase 11's run")
    run_dir = work_dir / "runs" / "synthetic" / "gaussian-splatting"
    out = work_dir / "backend"
    out.mkdir()
    counters = (composite_tiles_fwd, segment_broadcast)
    numbers = {**eval_check(run_dir, out, trained, counters),
               **render_check(run_dir, out, counters),
               **export_check(run_dir, out)}
    loaded = [m for m in ("PIL", "cv2", "yaml", "torchvision", "transformers")
              if m in sys.modules]
    assert not loaded, f"the back end imported {loaded}"
    return numbers


def methods_phase(work_dir: Path, counters) -> dict:
    """Phase 14: co-gs, surface-gs and camera optimisation on phase 11's
    dataset (800x800, 21 train views, the 100k-point seed cloud in 2^19
    lanes), each path driven with the launch counters reset just before
    and read just after."""
    phase("14 methods: a co-gs + camera-opt step vs plain, co-gs and "
          "surface-gs through gs-train")
    t0 = time.perf_counter()
    data = work_dir / "synthetic"
    trainer, cogs = cogs_run(work_dir, data, counters)
    step = methods_step(trainer, counters)
    del trainer
    surface = surface_run(work_dir, data, counters)
    launches = {"co_gs_step": step.pop("launches"),
                "co_gs_run": cogs.pop("launches"),
                "surface_gs_run": surface.pop("launches")}
    # read; left in place, the profiler's exit report would print after
    # the last line
    PROFILER.totals.clear()
    PROFILER.counts.clear()
    wall_s = time.perf_counter() - t0
    print(f"phase 14 wall time {wall_s:.1f} s")
    return {"step": step, "co_gs": cogs, "surface_gs": surface,
            "launches": launches, "wall_s": wall_s}


def methods_step(trainer, counters) -> dict:
    """Phase 14(a): from the co-gs run's trained state (step 300, so with
    anisotropic scales: at the isotropic kNN init a Gaussian's covariance
    does not depend on its rotation, the rotations' gradient is exactly 0
    and both steps give rounding noise there), one co-gs step through the
    kernels against the same step through the plain twins (``backend=
    "plain"``), with phase 10's tolerances: sensor depth L1, the sparse term
    and the planar term (patches of ``PLANAR_PATCH``), SO3xR3 camera
    optimisation over the 21 train views; both steps draw the background and
    the patch origins from generators of one seed. K1-K4 launch once, AF
    twice (the scene's Adam state and the camera group's); K2's
    depth column is nonzero, the camera group's gradient finite and
    nonzero, no moment non-finite. Then the step timed and traced beside
    the vanilla method's step from the same state, and ``torch.linalg.eigh``
    on (16, 3, 3) covariances timed."""
    cfg = trainer.config
    model = dataclasses.replace(
        cfg.model, depth_loss_start_iteration=0, planar_loss_start_iteration=0,
        use_sparse_loss=True, using_planar_loss=True,
        local_patch_size=PLANAR_PATCH)
    state = trainer.state
    step = int(state.step)
    n_train = trainer.datamanager.num_train
    assert step % 100 == 0 and state.cam_adjust.shape == (n_train, 6)
    print(f"co-gs state: step {step}, {n_train} train views, capacity "
          f"{state.scene.capacity}, {int(state.scene.num_alive)} alive")
    sh = trainer._sh_degree(step)
    idx, frame = trainer.datamanager.next_train()
    inputs = trainer._train_inputs(idx, frame, 1)
    assert inputs[3] is not None, "the dataset has no sensor depth"
    index = trainer._camera_index(idx)
    kernel_fn = make_train_step(model, trainer.raster_cfg, cfg.optim, H, W, sh,
                                camera_opt=cfg.camera_opt)
    plain_fn = make_train_step(
        model, dataclasses.replace(trainer.raster_cfg, backend="plain"),
        cfg.optim, H, W, sh, camera_opt=cfg.camera_opt)
    before = train_state_to_numpy(state)
    run_step = lambda fn, st: fn(
        st, *inputs[:2], torch.Generator(device=DEVICE).manual_seed(SEED),
        *inputs[2:], camera_index=index)

    rast = importlib.import_module("gstk_torch.ops.rasterize")
    k2_rows = []

    def k2_recorded(*args, **kwargs):
        rows = composite_tiles_bwd(*args, **kwargs)
        k2_rows.append(rows)
        return rows

    state_k = train_state_from_numpy(before, DEVICE)
    torch.cuda.synchronize()
    for f in counters:
        f.launches = 0
    rast.composite_tiles_bwd = k2_recorded
    try:
        state_k, m_k = run_step(kernel_fn, state_k)
        torch.cuda.synchronize()
    finally:
        rast.composite_tiles_bwd = composite_tiles_bwd
    launches = launches_of(counters)
    state_p, m_p = run_step(plain_fn, train_state_from_numpy(before, DEVICE))
    torch.cuda.synchronize()
    print(f"launches in one co-gs + camera-opt step: {launches}")
    for name, n in launches.items():
        # AF steps the scene's Adam state and the camera group's
        once = 2 if name == "adam_fused" else 1
        assert n == once, f"{name} launched {n} times by the co-gs step"
    got, want = train_state_to_numpy(state_k), train_state_to_numpy(state_p)
    bad = [k for k, v in got.items()
           if v.dtype.kind == "f" and not np.isfinite(v).all()]
    assert not bad, f"non-finite after the co-gs step: {bad}"
    print(f"co-gs step {step} (view {idx}, {int(m_k['num_intersects'])} "
          f"intersections):", end=" ")
    compare_steps(m_k, m_p, before, got, want, cfg.optim, step)
    terms = {}
    for k in ("sparse_loss", "depth_l1", "planar_loss"):
        a, b = float(m_k[k]), float(m_p[k])
        assert a != 0.0 and math.isclose(a, b, rel_tol=1e-3), (
            f"{k}: {a} vs plain {b}")
        terms[k] = [a, b]

    # K2's rows of this step: the depth channel carries a gradient
    (rows,) = k2_rows
    col_max = rows.abs().amax(0).tolist()
    depth_nonzero = int((rows[:, K2_DEPTH_COLUMN] != 0).sum())
    assert depth_nonzero > 0, "K2's depth column is zero in the co-gs step"
    # the camera group's gradient, from its first moment before and after
    cam_key = ".cam_adam/.mu/['camera_opt']"
    b1 = cfg.optim.b1
    cam_grad = (got[cam_key] - b1 * before[cam_key]) / (1.0 - b1)
    assert np.isfinite(cam_grad).all() and np.abs(cam_grad[idx]).max() > 0, (
        "the camera adjustment got no gradient")
    cam_scale = 1e-4 * max(float(np.abs(want[cam_key]).max()), 1e-30)
    cam_bad = int((~np.isclose(got[cam_key], want[cam_key], rtol=RTOL_GRAD,
                               atol=cam_scale)).sum())
    assert cam_bad == 0, f"camera moments: {cam_bad} outside the tolerance"
    d_k = got[".cam_adjust"] - before[".cam_adjust"]
    d_p = want[".cam_adjust"] - before[".cam_adjust"]
    co = cfg.camera_opt
    cam_lr = float(OptimizerConfig(
        lrs=(("camera_opt", co.lr),),
        extra_exp=(("camera_opt", co.lr_final, co.max_steps),),
    ).schedule_for("camera_opt")(torch.tensor(step)))
    strong = np.abs(want[cam_key]) > 1e-3 * np.abs(want[cam_key]).max()
    cam_upd = np.where(strong, ~np.isclose(d_k, d_p, rtol=RTOL_GRAD, atol=0.0),
                       np.abs(d_k - d_p) > 2.0 * cam_lr + 1e-7)
    assert not cam_upd.any(), "camera adjustment updates differ"
    print(f"co-gs terms (kernel, plain): {terms}; K2 column max |g| "
          f"{[round(x, 6) for x in col_max]}, depth column nonzero in "
          f"{depth_nonzero} of {rows.shape[0]} rows; camera gradient of view "
          f"{idx} {cam_grad[idx].tolist()}")

    # the step timed and traced beside the vanilla method's step from the
    # same state, and each with the depth terms or the camera group alone
    vanilla = VanillaConfig(**{f.name: getattr(model, f.name)
                               for f in dataclasses.fields(VanillaConfig)})
    plain_state = {k: v for k, v in before.items() if not k.startswith(".cam")}
    timed = {}
    for label, variant, camera in (
        ("vanilla", vanilla, False), ("vanilla + camera", vanilla, True),
        ("co-gs terms", model, False), ("co-gs terms + camera", model, True),
    ):
        fn = make_train_step(variant, trainer.raster_cfg, cfg.optim, H, W, sh,
                             camera_opt=cfg.camera_opt if camera else None)
        st = train_state_from_numpy(before if camera else plain_state, DEVICE)
        call = lambda fn=fn, st=st, camera=camera: fn(
            st, *inputs[:2], torch.Generator(device=DEVICE).manual_seed(SEED),
            *inputs[2:], camera_index=index if camera else None)
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        timed[label] = {"ms_median": statistics.median(ms), "ms_min": min(ms),
                        "traced": trace(f"{label} step", call)}
        print(f"{label} step ms: median {timed[label]['ms_median']:.3f}, min "
              f"{timed[label]['ms_min']:.3f} (host clock, synchronized, 5 steps)")
    base = timed["vanilla"]
    added = {label: {"device_events": t["traced"]["device_events"]
                     - base["traced"]["device_events"],
                     "busy_ms": t["traced"]["busy_ms"] - base["traced"]["busy_ms"],
                     "ms_median": t["ms_median"] - base["ms_median"]}
             for label, t in timed.items() if label != "vanilla"}
    print(f"added to the vanilla step: {added}")

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    pts = torch.randn((16, PLANAR_PATCH * PLANAR_PATCH, 3), generator=gen,
                      device=DEVICE)
    cov = pts.transpose(1, 2) @ pts / pts.shape[1]
    eigh = {"device": kernel_device_ms(lambda: torch.linalg.eigh(cov), None, 20),
            "events_ms": event_ms(lambda: torch.linalg.eigh(cov), 20)}
    host_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        torch.linalg.eigh(cov)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    eigh["host_ms_median"] = statistics.median(host_ms)
    print(f"torch.linalg.eigh on (16, 3, 3): {eigh}")
    return {"launches": launches, "terms": terms, "k2_column_max": col_max,
            "k2_depth_nonzero_rows": depth_nonzero, "view": idx,
            "camera_grad": cam_grad[idx].tolist(), "timed": timed,
            "added_by_methods": added, "eigh": eigh}


def method_run(work_dir: Path, data: Path, counters, method: str,
               extra: list):
    """``gstk_torch.scripts.train <method>`` for ``METHOD_ITERS`` steps on
    phase 11's dataset, in process, with the launch counters reset just
    before: K1-K4 launch and the losses stay finite. Returns the trainer,
    the numbers printed and the metrics as ``col(key) -> [(step,
    value)]``."""
    PROFILER.totals.clear()  # the run's own report
    PROFILER.counts.clear()
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    trainer = train_main([
        "--device", DEVICE, method, "--data", str(data),
        "--output-dir", str(work_dir / "methods"),
        "--max-num-iterations", str(METHOD_ITERS), "--steps-per-eval-image",
        "0", "--steps-per-eval-all-images", str(METHOD_ITERS),
        "--steps-per-save", str(METHOD_ITERS),
        "--dataparser.eval-mode", "interval", "--dataparser.eval-interval", "8",
        *extra,
    ])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launches_of(counters)
    for name, n in launches.items():
        assert n >= 1, f"{name} not launched by {method}"
    rows = [json.loads(line) for line in
            (trainer.config.run_dir / "metrics.jsonl").open()]
    col = lambda key: [(r["step"], r[key]) for r in rows if key in r]
    losses = col("loss")
    assert losses and all(math.isfinite(v) for _, v in losses), "loss not finite"
    final_eval = col("eval_psnr")[-1][1]
    assert math.isfinite(final_eval)
    # the first log window holds the setup
    iter_ms = [v * 1e3 for _, v in col("Train Iter (time)")][1:]
    numbers = {"launches": launches, "run_s": run_s,
               "step_ms_median": statistics.median(iter_ms),
               "final_eval_psnr": final_eval, "loss": [losses[0], losses[-1]]}
    print(f"{method}: {METHOD_ITERS} steps in {run_s:.1f} s (setup, steps, "
          f"evals, checkpoint); {numbers}")
    return trainer, numbers, col


def cogs_run(work_dir: Path, data: Path, counters):
    """Phase 14(b): co-gs with sensor depth from step 0 and SO3xR3 camera
    optimisation; the camera adjustments finite and moved. Reports the
    depth-L1 term at the first log past its gate (step 0 is shut) and the
    last. Returns the trainer and the numbers."""
    trainer, numbers, col = method_run(work_dir, data, counters, "co-gs", [
        "--model.depth-loss-start-iteration", "0",
        "--camera-opt.mode", "SO3xR3"])
    adj = trainer.state.cam_adjust
    assert adj is not None and bool(torch.isfinite(adj).all())
    moved = float(adj.abs().max())
    assert moved > 0, "the camera adjustments never moved"
    depth = [(st, v) for st, v in col("depth_l1") if st > 0]
    numbers.update(depth_l1=[depth[0], depth[-1]], cam_adjust_max=moved,
                   camera_opt=[col("camera_opt_translation")[-1],
                               col("camera_opt_rotation")[-1]])
    print(f"co-gs: depth_l1 (step, value) {numbers['depth_l1']}, camera "
          f"adjustments max |x| {moved:.3g}, (translation, rotation) "
          f"{numbers['camera_opt']}")
    return trainer, numbers


def surface_run(work_dir: Path, data: Path, counters) -> dict:
    """Phase 14(c): surface-gs for ``METHOD_ITERS`` steps through the
    coarse-to-fine schedule (``num_downscales`` 2, a bucket every
    ``SURFACE_SCHEDULE`` steps: d = 4, 2, 1), refining from step 100; the
    means of every lane still alive equal the seed cloud's bit for bit,
    no refine splits or duplicates, no lane past the seed comes alive; the
    step time of each bucket (the median of its log windows, the window
    with its cache build left out)."""
    infos = []
    refine = trainer_mod.refine

    def recorded(*args, **kwargs):
        out = refine(*args, **kwargs)
        infos.append(out[3])
        return out

    trainer_mod.refine = recorded
    try:
        trainer, numbers, col = method_run(work_dir, data, counters, "surface-gs", [
            "--model.resolution-schedule", str(SURFACE_SCHEDULE),
            "--model.warmup-length", str(SURFACE_SCHEDULE)])
    finally:
        trainer_mod.refine = refine
    scene = trainer.state.scene
    pts = trainer.datamanager.seed_points()[0]
    n = pts.shape[0]
    alive = scene.alive.detach()
    assert not bool(alive[n:].any()), "a lane past the seed cloud came alive"
    seed = torch.from_numpy(np.asarray(pts, np.float32)).to(DEVICE)
    kept = alive[:n]
    assert torch.equal(scene.means.detach()[:n][kept], seed[kept]), (
        "surface-gs moved an alive mean")
    info = {k: sum(int(i[k]) for i in infos)
            for k in ("num_split", "num_dup", "num_cull")}
    assert infos and info["num_split"] == 0 and info["num_dup"] == 0, (
        f"surface-gs densified: {info}")
    downscales = trainer.config.model.num_downscales
    buckets = {}
    for k in range(downscales + 1):
        lo = k * SURFACE_SCHEDULE
        ms = [v * 1e3 for st, v in col("Train Iter (time)")
              if lo < st < lo + SURFACE_SCHEDULE]
        buckets[f"d={2 ** (downscales - k)}"] = {
            "ms_median": statistics.median(ms), "windows": len(ms)}
    print(f"surface-gs: {int(kept.sum())} of {n} seed lanes alive, their means "
          f"bit-equal to the seed's; {len(infos)} refines: {info}; step ms by "
          f"bucket {buckets}")
    numbers.update(alive=[n, int(kept.sum())], refines=len(infos), refine=info,
                   step_ms_by_bucket=buckets)
    return numbers


def data_viewer_phase(work_dir: Path, counters) -> dict:
    """Phase 15: the raytraced dataset on the card, its mono-depth variant
    and mono co-gs through gs-train, gs-viewer on that run, and training
    with a polled viewer; each path driven with the launch counters reset
    just before and read just after."""
    phase("15 data and viewer: raytraced data, mono co-gs, gs-viewer, "
          "training with a viewer")
    t0 = time.perf_counter()
    data, raytraced = raytraced_check(work_dir)
    mono, run_dir = mono_run(work_dir, data, counters)
    viewer, orbit = viewer_check(run_dir, work_dir / "viewer", counters)
    polled = polled_training(work_dir, data, counters, orbit)
    launches = {"mono_co_gs_run": mono.pop("launches"),
                "viewer_requests": viewer.pop("launches"),
                "train_without_viewer": polled["without"].pop("launches"),
                "train_with_viewer": polled["with"].pop("launches")}
    PROFILER.totals.clear()
    PROFILER.counts.clear()
    loaded = [m for m in ("PIL", "cv2", "yaml") if m in sys.modules]
    assert not loaded, f"phase 15 imported {loaded}"
    wall_s = time.perf_counter() - t0
    print(f"phase 15 wall time {wall_s:.1f} s")
    return {"raytraced": raytraced, "mono_co_gs": mono, "viewer": viewer,
            "polled_training": polled, "launches": launches, "wall_s": wall_s}


def synchronized_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def raytraced_check(work_dir: Path):
    """15(a): ``RT_VIEWS`` views at 800x800 with ss 3 written on the card,
    and ``RT_SS1_VIEWS`` at ss 1; seconds a view (the generator's wall
    time, files included, and the shading alone, synchronized) and the
    device peak; one view at ss 1 shaded on the card against the CPU: RGBA
    equal in >= 99.9% of pixels, alpha equal, depth equal in >= 99.9% and
    within 1 mm elsewhere."""
    data = work_dir / "raytraced"
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by the earlier phases
    ss3_s = synchronized_s(lambda: generate_raytraced_dataset(
        data, n_views=RT_VIEWS, img_wh=(W, H), supersample=RT_SS,
        device=DEVICE)) / RT_VIEWS
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
    ss1_s = synchronized_s(lambda: generate_raytraced_dataset(
        work_dir / "raytraced_ss1", n_views=RT_SS1_VIEWS, img_wh=(W, H),
        device=DEVICE)) / RT_SS1_VIEWS
    meta = json.loads((data / "transforms.json").read_text())
    assert len(meta["frames"]) == RT_VIEWS
    n_seed = len(read_ply_points(data / "sparse.ply")[0])
    assert 0 < n_seed <= min(RT_VIEWS * 4000, 160_000), n_seed
    objs = build_scene()
    fx, c2w = meta["fl_x"], view_pose(0, RT_VIEWS)  # the low ring: sky too
    shade_s = {}
    for ss in (1, RT_SS):
        dirs = camera_dirs(W, H, fx, W / 2.0, H / 2.0, ss)
        shade_s[ss] = statistics.median(
            synchronized_s(lambda: render_view(objs, c2w, dirs, DEVICE))
            for _ in range(3))
    dirs = camera_dirs(W, H, fx, W / 2.0, H / 2.0, 1)
    views = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        rgb, t, hit, _ = render_view(objs, c2w, dirs, dev)
        views[dev] = view_images(rgb.cpu().numpy(), t.cpu().numpy(),
                                 hit.cpu().numpy(), H, W)
        if dev == "cpu":
            cpu_s = time.perf_counter() - t0
    (img, depth), (img_c, depth_c) = views[DEVICE], views["cpu"]
    assert np.array_equal(img[..., 3], img_c[..., 3]), "alpha differs"
    rgba_equal = float((img == img_c).all(-1).mean())
    depth_equal = float((depth == depth_c).mean())
    depth_diff = int(np.abs(depth.astype(np.int64) - depth_c).max())
    hit_share = float((img[..., 3] > 0).mean())
    print(f"raytraced: {RT_VIEWS} views at {W}x{H} ss {RT_SS}: {ss3_s:.3f} s a "
          f"view (generator wall, PNGs included), device peak {peak_mib:.1f} "
          f"MiB over what earlier phases hold; ss 1: {ss1_s:.3f} s a view; shading alone (synchronized, "
          f"median of 3): ss 1 {shade_s[1]:.4f} s, ss {RT_SS} "
          f"{shade_s[RT_SS]:.4f} s; seed cloud {n_seed} points")
    print(f"raytraced view 0 at ss 1, card vs CPU ({cpu_s:.1f} s on the CPU): "
          f"RGBA equal in {rgba_equal:.6f} of pixels, depth equal in "
          f"{depth_equal:.6f}, max depth diff {depth_diff} mm, alpha equal; "
          f"{hit_share:.3f} of pixels hit")
    assert hit_share > 0
    assert rgba_equal >= RT_EQUAL and depth_equal >= RT_EQUAL and depth_diff <= 1
    return data, {"views": RT_VIEWS, "ss": RT_SS, "s_per_view_ss3": ss3_s,
                  "s_per_view_ss1": ss1_s, "shade_s_ss1": shade_s[1],
                  "shade_s_ss3": shade_s[RT_SS], "peak_mib": peak_mib,
                  "seed_points": n_seed, "cpu_view_s": cpu_s,
                  "rgba_equal": rgba_equal, "depth_equal": depth_equal,
                  "depth_max_diff_mm": depth_diff}


def mono_run(work_dir: Path, data: Path, counters):
    """15(b): the mono-depth variant (``make_mono_depth``, which refuses
    above a 2% median scale error), then co-gs on it through gs-train for
    ``METHOD_ITERS`` steps with every est-depth term from step 0; K1-K4
    launch, the losses and the terms stay finite. Returns the numbers and
    the run directory."""
    mono = work_dir / "raytraced_mono"
    t0 = time.perf_counter()
    report = make_mono_depth.main(["--data", str(data), "--out", str(mono)])
    tool_s = time.perf_counter() - t0
    assert report["median_rel_scale_error"] <= MONO_MAX_ERR, report
    trainer, numbers, col = method_run(work_dir, mono, counters, "co-gs", [
        "--model.use-est-depth", "True", "--model.use-pearson-depth", "True",
        "--model.use-scaled-est-depth", "True",
        "--model.use-depth-regularization", "True",
        "--model.depth-loss-start-iteration", "0"])
    terms = {}
    for key in ("depth_local_pearson", "log_depth", "depth_reg_loss"):
        logged = [(st, v) for st, v in col(key) if st > 0]  # step 0 is shut
        assert logged and all(math.isfinite(v) for _, v in logged), key
        terms[key] = [logged[0], logged[-1]]
    run_dir = trainer.config.run_dir
    numbers.update(report=report, tool_s=tool_s, terms=terms,
                   final_eval_ssim=col("eval_ssim")[-1][1],
                   capacity=trainer.state.scene.capacity)
    print(f"make_mono_depth: {report} in {tool_s:.1f} s; mono co-gs depth "
          f"terms (step, value) first and last log past step 0: {terms}; "
          f"final eval PSNR {numbers['final_eval_psnr']:.3f}, SSIM "
          f"{numbers['final_eval_ssim']:.4f}; capacity {numbers['capacity']}")
    return numbers, run_dir


def _png(body: bytes, path: Path) -> np.ndarray:
    path.write_bytes(body)
    return read_png(path)


def _http(base: str, path: str, data=None) -> tuple:
    """(body, host-clock ms) of one request; ``data`` is POSTed as JSON."""
    req = urllib.request.Request(
        base + path, data=None if data is None else json.dumps(data).encode())
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        body = resp.read()
    return body, (time.perf_counter() - t0) * 1e3


def _orbit_path(orbit: dict, az: float) -> str:
    """The ``/render`` request of the orbit pose at azimuth ``az``."""
    cx, cy, cz = orbit["center"]  # repr: the server parses the same floats
    return (f"/render?az={az!r}&el={VIEWER_EL!r}&r={orbit['r']!r}"
            f"&cx={cx!r}&cy={cy!r}&cz={cz!r}")


def viewer_requests(base: str, orbit: dict, out: Path) -> dict:
    """The request sequence of 15(c): ``/``, ``VIEWER_REQUESTS`` rgb frames
    over an orbit, 2 depth and 2 crop-box frames, a keyframe pair with its
    trajectory and one trajectory frame. Every frame is decoded and
    checked: 480x640x3 uint8, not blank, depth frames grey."""
    assert b"gstk_torch viewer" in _http(base, "/")[0]
    paths = [_orbit_path(orbit, 2 * math.pi * i / VIEWER_REQUESTS)
             for i in range(VIEWER_REQUESTS)]
    frames, ms = {}, []

    def frame(name, path):
        body, t = _http(base, path)
        img = _png(body, out / f"{name}.png")
        assert img.shape == (VIEWER_H, VIEWER_W, 3) and img.dtype == np.uint8, (
            name, img.shape)
        assert len(np.unique(img)) > 16, f"{name}: a blank frame"
        frames[name] = (body, img)
        return t

    frame("warm-up", paths[0])  # the process's first render
    for i, path in enumerate(paths):
        ms.append(frame(f"rgb{i}", path))
    _http(base, "/settings", {"output": "depth"})
    for i in range(2):
        frame(f"depth{i}", paths[3 * i])
        img = frames[f"depth{i}"][1]
        assert (img[..., 0] == img[..., 1]).all() and (img[..., 1] == img[..., 2]).all()
    half = VIEWER_CROP * orbit["r"]
    _http(base, "/settings", {"output": "rgb", "crop_enabled": True,
                              "crop_min": [c - half for c in orbit["center"]],
                              "crop_max": [c + half for c in orbit["center"]]})
    for i in range(2):
        frame(f"crop{i}", paths[3 * i])
    _http(base, "/settings", {"crop_enabled": False})
    for az in (0.3, 1.3):
        _http(base, _orbit_path(orbit, az).replace("/render", "/keyframe/add"))
    path = json.loads(_http(base, "/trajectory?steps=8")[0])
    assert len(path["camera_path"]) == 9
    frame("traj3", "/render_traj?i=3")
    return {"frames": frames, "rgb_ms": ms}


def viewer_check(run_dir: Path, out: Path, counters) -> dict:
    """15(c): gs-viewer (``python -m gstk_torch.scripts.viewer``) on the
    mono co-gs run, a subprocess on a free port, answers
    :func:`viewer_requests` (it must print its port and answer ``/`` within
    ``VIEWER_DEADLINE_S``, and is killed afterwards); the same sequence
    through an in-process ``TrainingViewer`` served alike, with the
    counters reset just before (K1 and K3 once a frame), gives the same
    frames; frame 0 against the plain twins' render of the same pose
    (uint8 within 1 level, 0.1% of pixels outside); request and encode
    times; one traced in-process render."""
    out.mkdir(parents=True, exist_ok=True)
    cfg = run_dir / "config.yml"
    config = load_config(cfg)
    renderer = Renderer(run_dir / "ckpts", model_config=config.model, device=DEVICE)
    # the orbit: around the median of the alive means, at the train
    # cameras' median distance from it
    scene = renderer.scene
    center = scene.means.detach()[scene.alive].median(dim=0).values.cpu().numpy()
    poses = parse_transforms(config.dataparser, "train").poses
    radius = float(np.median(np.linalg.norm(poses[:, :3, 3] - center, axis=-1)))
    orbit = {"center": [float(c) for c in center], "r": radius}
    proc = subprocess.Popen(
        [sys.executable, "-m", "gstk_torch.scripts.viewer", "--load-config",
         str(cfg), "--port", "0", "--device", DEVICE], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + VIEWER_DEADLINE_S
        port = None
        while time.monotonic() < deadline and proc.poll() is None:
            text = "".join(lines)
            found = re.search(r"http://localhost:(\d+)", text)
            if found and "Ctrl-C to exit" in text:  # the scene is in
                port = int(found.group(1))
                break
            time.sleep(0.2)
        assert port is not None, f"gs-viewer did not start: {''.join(lines)[-3000:]}"
        start_s = VIEWER_DEADLINE_S - (deadline - time.monotonic())
        served = viewer_requests(f"http://127.0.0.1:{port}", orbit, out)
    finally:
        proc.kill()
        proc.wait(timeout=30)
    reader.join(timeout=10)
    ms = served["rgb_ms"]
    print(f"gs-viewer: up in {start_s:.1f} s, {len(served['frames'])} frames "
          f"at {VIEWER_W}x{VIEWER_H}; rgb /render host-clock ms median "
          f"{statistics.median(ms):.3f}, min {min(ms):.3f}")

    kernel = TrainingViewer(config.model, renderer.raster_config,
                            host="127.0.0.1", port=0, device=DEVICE).start()
    plain = TrainingViewer(
        config.model, dataclasses.replace(renderer.raster_config, backend="plain"),
        host="127.0.0.1", port=0, device=DEVICE)
    try:
        # the snapshot the trainer takes at each log step: a clone
        clone_ms = statistics.median(
            synchronized_s(lambda: kernel.update_scene(renderer.scene)) * 1e3
            for _ in range(5))
        kernel.update_scene(renderer.scene, {"step": renderer.step})
        plain.update_scene(renderer.scene)
        torch.cuda.synchronize()
        for f in counters:
            f.launches = 0
        mine = viewer_requests(f"http://127.0.0.1:{kernel.server.port}", orbit,
                               out)
        torch.cuda.synchronize()
        launches = launches_of(counters)
        n_frames = len(mine["frames"])
        assert launches["composite_tiles_fwd"] == n_frames, launches
        assert launches["segment_broadcast"] == n_frames, launches
        for name, (body, img) in served["frames"].items():
            assert np.array_equal(mine["frames"][name][1], img), (
                f"gs-viewer's frame {name} differs from the in-process one")
        c2w = orbit_pose(0.0, VIEWER_EL, orbit["r"], orbit["center"])
        want = plain.render(c2w, VIEWER_H, VIEWER_W, DEFAULT_SETTINGS)
        got = served["frames"]["rgb0"][1]
        diff = np.abs(got.astype(np.int64) - want).max(-1)
        outside = float((diff > 1).mean())
        assert outside <= 1e-3, f"frame vs plain twins: {outside} outside"
        enc = {}
        for level in (FRAME_PNG_LEVEL, -1):
            t = []
            for _ in range(10):
                t0 = time.perf_counter()
                encode_png(got, level)
                t.append((time.perf_counter() - t0) * 1e3)
            enc[level] = statistics.median(t)
        traced = trace(f"in-process /render {VIEWER_W}x{VIEWER_H} (render + "
                       "encode)", lambda: encode_png(kernel.render(
                           c2w, VIEWER_H, VIEWER_W, DEFAULT_SETTINGS),
                           FRAME_PNG_LEVEL))
    finally:
        kernel.stop()
        plain.stop()
    print(f"viewer: in-process launches {launches} over {n_frames} frames, "
          f"equal to gs-viewer's; frame 0 vs plain twins: {outside:.6f} of "
          f"pixels over 1 level, max {int(diff.max())}; encode_png "
          f"{VIEWER_W}x{VIEWER_H} (host, median of 10): level "
          f"{FRAME_PNG_LEVEL} {enc[FRAME_PNG_LEVEL]:.3f} ms, default "
          f"{enc[-1]:.3f} ms; update_scene (a clone of {renderer.scene.capacity} "
          f"lanes, synchronized, median of 5) {clone_ms:.3f} ms")
    return {"launches": launches, "frames": n_frames, "start_s": start_s,
            "request_ms_median": statistics.median(ms),
            "request_ms_min": min(ms), "encode_png_ms": enc[FRAME_PNG_LEVEL],
            "encode_png_default_ms": enc[-1], "plain_outside": outside,
            "capacity": renderer.scene.capacity, "update_scene_ms": clone_ms,
            "orbit": orbit,
            "trace": traced}, orbit


def polled_training(work_dir: Path, data: Path, counters, orbit: dict) -> dict:
    """15(d): ``VIEWER_ITERS`` vanilla steps on the raytraced data at
    800x800 without a viewer, then with ``--vis viewer`` while a client
    thread requests ``/render`` every ``POLL_S``; the counters reset just
    before each run. Every frame served after the first snapshot is not
    blank, and the counters of the viewer's run equal the other run's plus
    one K1 and one K3 a frame rendered from a snapshot."""
    runs = {}
    for name in ("without", "with"):
        servers, bodies, errors = [], [], []
        done = threading.Event()
        start = http_viewer.ViewerServer.start

        def start_and_record(self):
            servers.append(self)
            return start(self)

        def poll():
            while not servers and not done.is_set():
                time.sleep(0.01)
            if servers:
                base = f"http://127.0.0.1:{servers[0].port}"
                try:
                    while not done.is_set():
                        bodies.append(_http(base, _orbit_path(orbit, 0.4))[0])
                        time.sleep(POLL_S)
                except Exception as exc:  # reported below
                    errors.append(repr(exc))

        http_viewer.ViewerServer.start = start_and_record
        poller = threading.Thread(target=poll)
        poller.start()
        for f in counters:
            f.launches = 0
        try:
            trainer = train_main([
                "--device", DEVICE, "gaussian-splatting", "--data", str(data),
                "--output-dir", str(work_dir / "polled"),
                "--experiment-name", f"{name}_viewer",
                "--max-num-iterations", str(VIEWER_ITERS),
                "--model.num-downscales", "0", "--steps-per-eval-image", "0",
                "--steps-per-eval-all-images", "0", "--steps-per-save", "0",
                "--dataparser.eval-mode", "interval",
                "--dataparser.eval-interval", "8",
                *(["--vis", "viewer", "--viewer-port", "0"] if name == "with"
                  else [])])
        finally:
            done.set()
            poller.join(timeout=120)
            http_viewer.ViewerServer.start = start
            for server in servers:
                server.stop()
        torch.cuda.synchronize()
        assert not poller.is_alive() and not errors, errors
        launches = launches_of(counters)
        rows = [json.loads(line) for line in
                (trainer.config.run_dir / "metrics.jsonl").open()]
        iter_ms = [r["Train Iter (time)"] * 1e3 for r in rows
                   if "Train Iter (time)" in r][1:]
        runs[name] = {"launches": launches, "requests": len(bodies),
                      "step_ms_median": statistics.median(iter_ms),
                      "step_ms_min": min(iter_ms)}
        if name == "with":
            imgs = [_png(b, work_dir / "polled.png") for b in bodies]
            lit = [bool(img.any()) for img in imgs]  # black: no snapshot yet
            first = lit.index(True)
            assert all(len(np.unique(img)) > 16 for img in imgs[first:]), (
                "a blank frame after the first snapshot")
            runs[name].update(frames_from_snapshot=sum(lit), first_lit=first)
        del trainer
    lit = runs["with"]["frames_from_snapshot"]
    base_l, with_l = runs["without"]["launches"], runs["with"]["launches"]
    for k in ("composite_tiles_fwd", "segment_broadcast"):
        assert with_l[k] == base_l[k] + lit, (k, with_l[k], base_l[k], lit)
    for k in ("composite_tiles_bwd", "segment_sum_sorted"):
        assert with_l[k] == base_l[k], (k, with_l[k], base_l[k])
    print(f"polled training, {VIEWER_ITERS} steps at {W}x{H}: ITER_TRAIN_TIME "
          f"median {runs['with']['step_ms_median']:.3f} ms with the viewer "
          f"polled every {POLL_S * 1e3:.0f} ms ({runs['with']['requests']} "
          f"frames, {lit} from a snapshot, none blank after the first), "
          f"{runs['without']['step_ms_median']:.3f} ms without; launches "
          f"{with_l} = {base_l} + {lit} frames")
    return runs


def launches_of(counters) -> dict:
    return {f.__name__: f.launches for f in counters}


def check_eval(name, got, want) -> None:
    """gs-eval's mean PSNR within rtol EVAL_RTOL and SSIM within atol
    EVAL_ATOL of ``want``'s (``{"psnr", "ssim"}``, or another gs-eval JSON,
    whose per-view lists are then held alike)."""
    mean = lambda r: r["results"] if "results" in r else r
    pairs = [(mean(got)["psnr"], mean(want)["psnr"], EVAL_RTOL, 0.0),
             (mean(got)["ssim"], mean(want)["ssim"], 0.0, EVAL_ATOL)]
    if "per_image" in want:
        for k, rtol, atol in (("psnr", EVAL_RTOL, 0.0), ("ssim", 0.0, EVAL_ATOL)):
            assert len(got["per_image"][k]) == len(want["per_image"][k])
            pairs += [(a, b, rtol, atol) for a, b in
                      zip(got["per_image"][k], want["per_image"][k])]
    for a, b, rtol, atol in pairs:
        assert math.isfinite(a) and abs(a - b) <= atol + rtol * abs(b), (
            f"{name}: {a} against {b}")


@contextlib.contextmanager
def tf32_convolutions():
    """cuDNN's default TF32 convolutions, with the package's f32 guard
    bypassed: what SSIM computed before the guard."""
    saved = torch.backends.cudnn.allow_tf32, losses.f32_convolutions
    torch.backends.cudnn.allow_tf32 = True
    losses.f32_convolutions = contextlib.nullcontext
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, losses.f32_convolutions = saved


def eval_check(run_dir: Path, out: Path, trained: dict, counters) -> dict:
    """gs-eval in process (device loop and host loop), in a fresh
    ``python -m`` process under PyTorch's default TF32 flags, and with
    LPIPS weights; the device loop timed and one view traced."""
    cfg = str(run_dir / "config.yml")
    argv = lambda name, *extra: ["--load-config", cfg, "--output-path",
                                 str(out / name), *extra]
    want = {"psnr": trained["final_eval_psnr"], "ssim": trained["final_eval_ssim"]}
    for f in counters:
        f.launches = 0
    res = eval_cli.main(argv("eval.json", "--skip-lpips"))
    torch.cuda.synchronize()
    launches = launches_of(counters)
    n = res["results"]["num_images"]
    print(f"gs-eval: {n} views, PSNR {res['results']['psnr']:.6f} SSIM "
          f"{res['results']['ssim']:.6f} (the trainer's final eval: PSNR "
          f"{want['psnr']:.6f} SSIM {want['ssim']:.6f}); launches {launches}")
    assert n == SYN_VIEWS // 8 and res["results"]["lpips"] is None
    assert all(v == n for v in launches.values()), "K1 / K3 not once a view"
    check_eval("gs-eval vs the trainer's eval", res, want)
    host = eval_cli.main(argv("eval_host.json", "--skip-lpips", "--force-host-loop"))
    check_eval("--force-host-loop", host, res)
    proc = subprocess.run(
        [sys.executable, "-m", "gstk_torch.scripts.eval",
         *argv("eval_sub.json", "--skip-lpips")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    sub = json.loads((out / "eval_sub.json").read_text())
    check_eval("gs-eval in a fresh process", sub, res)
    assert {k: v for k, v in sub.items() if k not in ("results", "per_image")} == {
        k: v for k, v in res.items() if k not in ("results", "per_image")}
    print(f"gs-eval --force-host-loop and in a fresh process (default TF32 "
          f"flags): PSNR {host['results']['psnr']:.6f} / "
          f"{sub['results']['psnr']:.6f}, SSIM {host['results']['ssim']:.6f} / "
          f"{sub['results']['ssim']:.6f}")

    config = load_config(run_dir / "config.yml")
    renderer = Renderer(run_dir / "ckpts", model_config=config.model,
                        background=EVAL_BACKGROUND, device=DEVICE)
    frames = FullImageDatamanager(config.dataparser, seed=config.seed,
                                  splits=("eval",)).eval_frames
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_cli.batched_eval(renderer, frames)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / len(frames))
    print(f"gs-eval device loop: {[round(x, 3) for x in ms]} ms a view "
          f"(synchronized, {len(frames)} views)")
    traced = trace("gs-eval view", lambda: eval_cli.batched_eval(renderer, frames[:1]),
                   top=10)

    frame = frames[0]
    h, w = frame.image.shape[:2]
    with torch.no_grad():
        pred = renderer.render(frame.c2w, frame.fx, frame.fy, frame.cx, frame.cy,
                               h, w)["rgb"]
    gt = torch.from_numpy(composite_gt_with_background(
        frame.image, np.asarray(EVAL_BACKGROUND, np.float32))).to(DEVICE)
    ssim_f32 = float(losses.ssim(gt, pred))
    with tf32_convolutions():
        ssim_tf32 = float(losses.ssim(gt, pred))
    print(f"SSIM of eval view 0: {ssim_f32:.8f} in f32, {ssim_tf32:.8f} with "
          f"cuDNN's TF32 (the package's guard bypassed), diff "
          f"{ssim_tf32 - ssim_f32:.3g}")

    params = random_lpips_params(SEED, device="cpu")
    weights = out / "lpips.npz"
    np.savez(weights, **{k: v.numpy() for k, v in params.items()})
    lp = eval_cli.main(argv("eval_lpips.json", "--lpips-weights", str(weights)))
    value = lp["results"]["lpips"]
    assert value is not None and math.isfinite(value) and value > 0, value
    check_eval("gs-eval with LPIPS", lp, res)
    card_params = {k: v.to(DEVICE) for k, v in params.items()}
    ms_lpips = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_cli.batched_eval(renderer, frames, card_params)
        torch.cuda.synchronize()
        ms_lpips.append((time.perf_counter() - t0) * 1e3 / len(frames))
    y0, x0 = (h - LPIPS_CROP) // 2, (w - LPIPS_CROP) // 2
    crop = lambda x: x[y0:y0 + LPIPS_CROP, x0:x0 + LPIPS_CROP].contiguous()
    lp_card = float(lpips(card_params, crop(gt), crop(pred)))
    lp_cpu = float(lpips(params, crop(gt).cpu(), crop(pred).cpu()))
    err = abs(lp_card - lp_cpu) / abs(lp_cpu)
    print(f"LPIPS (random weights, npz): gs-eval {value:.6g} over {n} views, "
          f"{[round(x, 3) for x in ms_lpips]} ms a view with LPIPS; on a "
          f"{LPIPS_CROP}^2 crop of view 0 card {lp_card:.8g}, CPU {lp_cpu:.8g}, "
          f"rel err {err:.3g}")
    assert err <= 1e-4, "LPIPS on the card differs from the CPU"
    return {"eval": {"views": n, "launches": launches,
                     "launches_per_view": {k: v / n for k, v in launches.items()},
                     "psnr": res["results"]["psnr"], "ssim": res["results"]["ssim"],
                     "trainer_psnr": want["psnr"], "trainer_ssim": want["ssim"],
                     "subprocess_psnr": sub["results"]["psnr"],
                     "subprocess_ssim": sub["results"]["ssim"],
                     "ms_per_view": statistics.median(ms), "traced_view": traced,
                     "ssim_f32": ssim_f32, "ssim_tf32": ssim_tf32,
                     "lpips": value, "lpips_ms_per_view": min(ms_lpips),
                     "lpips_crop_rel_err": err}}


def record_bands(fn) -> list:
    """Run ``fn`` with ``bin_gaussians`` recorded: per band, its tile count,
    true intersection count and the last tile range's end."""
    rasterize_mod = importlib.import_module("gstk_torch.ops.rasterize")
    inner, seen = rasterize_mod.bin_gaussians, []

    def recorded(*args, **kw):
        isect = inner(*args, **kw)
        bins = isect.tile_bins
        seen.append({"tiles": int(bins.shape[0]),
                     "num_intersects": int(isect.num_intersects),
                     "capacity": int(isect.gaussian_ids.shape[0]),
                     "last_end": int(bins[:, 1].max()),
                     "ordered": bool((bins[:, 0] <= bins[:, 1]).all()
                                     and (bins[1:, 0] >= bins[:-1, 1]).all())})
        return isect

    rasterize_mod.bin_gaussians = recorded
    try:
        fn()
    finally:
        rasterize_mod.bin_gaussians = inner
    return seen


def render_check(run_dir: Path, out: Path, counters) -> dict:
    """gs-render pose (every file read back against the Renderer's output,
    quantized alike) and trajectory (8 poses at 1920x1080, four bands: K1
    and K3 four times a frame, one frame against the plain twins)."""
    cfg = str(run_dir / "config.yml")
    config = load_config(run_dir / "config.yml")
    dm = FullImageDatamanager(config.dataparser, seed=config.seed)
    train = dm.train_frames
    pose_dir = out / "pose"
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    render_cli.main(["pose", "--load-config", cfg, "--output-dir", str(pose_dir)])
    torch.cuda.synchronize()
    pose_s = time.perf_counter() - t0
    launches = launches_of(counters)
    assert all(v == len(train) for v in launches.values()), launches
    for sub in ("rgb", "depth", "gt/rgb", "gt/depth"):
        assert len(list((pose_dir / sub).glob("*.png"))) == len(train), sub
    poses = json.loads((pose_dir / "poses.json").read_text())
    assert len(poses) == len(train)
    renderer = Renderer(run_dir / "ckpts", model_config=config.model, device=DEVICE)
    for i, frame in enumerate(train):
        o = renderer.get_output_from_pose(frame.c2w, frame.fx, frame.fy, frame.cx,
                                          frame.cy, H, W)
        rgb = (np.clip(o["rgb"], 0, 1) * 255).astype(np.uint8)
        mm = np.minimum((1000.0 * o["depth"]).astype(np.uint32), 65535)
        assert np.array_equal(read_png(pose_dir / "rgb" / f"frame_{i:05d}.png"), rgb), i
        got = read_png(pose_dir / "depth" / f"depth_{i:05d}.png")
        assert got.dtype == np.uint16 and np.array_equal(got, mm), i
    write_ms = {}
    for name, fn, arr in (("rgb", render_cli._save_rgb, o["rgb"]),
                          ("depth", render_cli._save_depth_mm, o["depth"])):
        t = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(out / f"w_{name}.png", arr)
            t.append((time.perf_counter() - t0) * 1e3)
        write_ms[name] = statistics.median(t)
    print(f"gs-render pose: {len(train)} views in {pose_s:.2f} s, launches "
          f"{launches}; every rgb and depth PNG equals the Renderer's output "
          f"quantized alike; PNG write {W}x{H} (host): {write_ms} ms")

    fov = math.degrees(2.0 * math.atan(0.5 * H / train[0].fy))
    path = {"camera_path": [
        {"camera_to_world": np.vstack([f.c2w, [0, 0, 0, 1]]).ravel().tolist(),
         "fov": fov} for f in train[:TRAJ_POSES]]}
    (out / "path.json").write_text(json.dumps(path))
    bands = renderer._raster_for(TRAJ_H, TRAJ_W).bands
    assert bands == TRAJ_BANDS, f"{bands} bands at {TRAJ_W}x{TRAJ_H}"
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    render_cli.main(["trajectory", "--trajectory-path", str(out / "path.json"),
                     "--load-config", cfg, "--num-frames-target", str(TRAJ_POSES)])
    torch.cuda.synchronize()
    traj_s = time.perf_counter() - t0
    traj_launches = launches_of(counters)
    assert all(v == TRAJ_BANDS * TRAJ_POSES for v in traj_launches.values()), (
        traj_launches)
    assert len(list((run_dir / "render" / "rgb").glob("*.png"))) == TRAJ_POSES

    fy = 0.5 * TRAJ_H / math.tan(math.radians(fov) / 2)
    args = lambda f: (np.vstack([f.c2w, [0, 0, 0, 1]]), fy, fy, TRAJ_W / 2,
                      TRAJ_H / 2, TRAJ_H, TRAJ_W)
    renderer.get_output_from_pose(*args(train[0]))  # warm-up
    frame_ms = []
    for f in train[:TRAJ_POSES]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.get_output_from_pose(*args(f))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    per_band = record_bands(lambda: renderer.get_output_from_pose(*args(train[0])))
    rows = -(-((TRAJ_H + 15) // 16) // TRAJ_BANDS)
    tiles_x = (TRAJ_W + 15) // 16
    assert [b["tiles"] for b in per_band] == [
        tiles_x * min(rows, (TRAJ_H + 15) // 16 - b * rows) for b in range(TRAJ_BANDS)]
    for b in per_band:
        assert b["ordered"] and 0 < b["num_intersects"] <= b["capacity"], b
        assert b["last_end"] == b["num_intersects"], b
    got = renderer.get_output_from_pose(*args(train[0]))
    plain = Renderer(run_dir / "ckpts", model_config=config.model, device=DEVICE,
                     raster_config=RasterizeConfig(
                         isect_capacity=renderer.raster_config.isect_capacity,
                         bands=0, backend="plain", forward_only=True))
    want = plain.get_output_from_pose(*args(train[0]))
    errs = {}
    for k in ("rgb", "depth", "accumulation"):
        assert_close(f"trajectory frame {k}", torch.from_numpy(got[k]),
                     torch.from_numpy(want[k]), **PARITY, max_outside=1e-3)
        errs[k] = float(np.abs(got[k] - want[k]).max())
    traced = trace("trajectory frame (1920x1080, 4 bands)",
                   lambda: renderer.get_output_from_pose(*args(train[0])), top=8)
    print(f"gs-render trajectory: {TRAJ_POSES} frames at {TRAJ_W}x{TRAJ_H} in "
          f"{traj_s:.2f} s, launches {traj_launches} ({TRAJ_BANDS} bands); "
          f"{[round(x, 3) for x in frame_ms]} ms a frame (Renderer, "
          f"synchronized); intersections per band of frame 0 "
          f"{[b['num_intersects'] for b in per_band]} of capacity "
          f"{per_band[0]['capacity']}; frame 0 vs plain twins max abs err {errs}")
    return {"render": {
        "pose_views": len(train), "pose_launches": launches, "pose_s": pose_s,
        "png_write_ms": write_ms, "trajectory_frames": TRAJ_POSES,
        "trajectory_launches": traj_launches,
        "trajectory_launches_per_frame": {k: v / TRAJ_POSES
                                          for k, v in traj_launches.items()},
        "bands": TRAJ_BANDS, "frame_ms_median": statistics.median(frame_ms),
        "frame_ms_min": min(frame_ms), "band_intersects": per_band,
        "frame_vs_plain_max_err": errs, "traced_frame": traced}}


def export_check(run_dir: Path, out: Path) -> dict:
    """gs-export's four commands; the splat PLY byte for byte the CPU's,
    offline-tsdf at its defaults with both meshers, masking and cleanup;
    then the fused volume on the card against the CPU on the same frames,
    and the integration, Poisson and marching-tetrahedra times."""
    cfg = str(run_dir / "config.yml")
    exp = out / "export"
    seconds = {}

    def run(name, *argv):
        t0 = time.perf_counter()
        export_cli.main([*argv, "--load-config", cfg, "--output-dir", str(exp / name)])
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0

    run("card", "gaussian-splat")
    run("cpu", "gaussian-splat", "--device", "cpu")
    ply = (exp / "card" / "gaussians.ply").read_bytes()
    assert ply == (exp / "cpu" / "gaussians.ply").read_bytes(), "splat PLYs differ"
    run("poses", "camera-poses")
    n_poses = [len(json.loads((exp / "poses" / f"{s}_poses.json").read_text()))
               for s in ("train", "eval")]
    assert n_poses == [SYN_VIEWS - SYN_VIEWS // 8, SYN_VIEWS // 8], n_poses
    run("cloud", "point-cloud")
    n_points = len(read_ply(exp / "cloud" / "point_cloud.ply")["vertex"])
    assert n_points > 0
    run("tetra", "offline-tsdf")
    run("poisson", "offline-tsdf", "--meshing", "poisson", "--clean",
        "--mask-method", "threshold")
    meshes = {}
    for name in ("tetra", "poisson"):
        mesh = read_ply(exp / name / "tsdf_mesh.ply")
        meshes[name] = [len(mesh["vertex"]), len(mesh["face"])]
        assert min(meshes[name]) > 0, f"empty {name} mesh"
    print(f"gs-export: splat PLY {len(ply)} B, equal to --device cpu's; poses "
          f"{n_poses}; {n_points} cloud points; meshes (vertices, faces) "
          f"{meshes}; seconds {{{', '.join(f'{k}: {v:.2f}' for k, v in seconds.items())}}}")

    config = load_config(run_dir / "config.yml")
    frames = FullImageDatamanager(config.dataparser, seed=config.seed).train_frames
    renderer = Renderer(run_dir / "ckpts", model_config=config.model, device=DEVICE)
    depths, colors, intr, w2cs = export_cli.fusion_inputs(renderer, frames)
    inputs = (np.stack(depths), np.stack(colors), np.asarray(intr, np.float32),
              np.stack(w2cs))
    box = ((-TSDF_SIZE / 2,) * 3, (TSDF_SIZE,) * 3, TSDF_VOXEL)
    integrate_frames(make_volume(*box, device=DEVICE),
                     *(x[:1] for x in inputs), TSDF_TRUNC)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = integrate_frames(make_volume(*box, device=DEVICE), *inputs, TSDF_TRUNC)
    torch.cuda.synchronize()
    integrate_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    t0 = time.perf_counter()
    ref = integrate_frames(make_volume(*box, device="cpu"), *inputs, TSDF_TRUNC)
    cpu_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    outside = torch.zeros(ref.tsdf.shape, dtype=torch.bool)
    err = {}
    for k in ("tsdf", "colors"):
        diff = (getattr(vol, k).cpu() - getattr(ref, k)).abs()
        bad = diff > TSDF_ATOL
        outside |= bad if bad.ndim == 3 else bad.any(-1)
        err[k] = float(diff.max())
    share = float(outside.float().mean())
    observed = int((ref.weights > 0).sum())
    print(f"TSDF {tuple(ref.tsdf.shape)} from {len(frames)} frames: integrate "
          f"{integrate_ms:.3f} ms a frame on the card (synchronized), "
          f"{cpu_ms:.1f} on the CPU; {observed} voxels observed; card vs CPU: "
          f"{int(outside.sum())} voxels ({share:.2e}) outside atol {TSDF_ATOL}, "
          f"max abs err {err}")
    assert share <= TSDF_OUTSIDE, "the card's TSDF volume differs from the CPU's"
    assert torch.equal(vol.weights.cpu()[~outside], ref.weights[~outside]), (
        "weights differ outside the flipped voxels")
    assert observed > 0 and float(ref.weights.max()) > 1
    tsdf, weights = vol.tsdf.cpu().numpy(), vol.weights.cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poisson_indicator(tsdf, np.minimum(weights, 1.0), iters=POISSON_ITERS,
                      device=DEVICE)
    poisson_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    verts, faces, _ = marching_tetrahedra(tsdf, weights, vol.colors.cpu().numpy(),
                                          origin=vol.origin.cpu().numpy(),
                                          voxel_size=TSDF_VOXEL)
    mt_s = time.perf_counter() - t0
    print(f"poisson_indicator {POISSON_ITERS} iterations {poisson_ms:.1f} ms "
          f"(card, with the host copies); marching_tetrahedra {mt_s:.2f} s "
          f"(host), {len(verts)} vertices, {len(faces)} faces")
    return {"export": {"seconds": seconds, "splat_ply_bytes": len(ply),
                       "cloud_points": n_points, "meshes": meshes,
                       "tsdf_dims": list(ref.tsdf.shape), "frames": len(frames),
                       "integrate_ms_per_frame": integrate_ms,
                       "integrate_cpu_ms_per_frame": cpu_ms,
                       "voxels_observed": observed,
                       "voxels_outside": int(outside.sum()),
                       "card_vs_cpu_max_err": err, "poisson_ms": poisson_ms,
                       "marching_tetrahedra_s": mt_s}}


def kept_warp_entries(fwd_args) -> dict:
    """By warp size (32 and 64 consecutive pixels of a tile, 2 and 4 rows):
    the (tile, warp, entry) triples in which at least one of the warp's
    pixels keeps the entry, from the plain walk's keep mask. K2's warps hold
    64 pixels, so the 64 count is the warp reductions it runs."""
    xys, conics, opacities, _, gids, bins, tiles = fwd_args
    total = {32: 0, 64: 0}
    for c in _walk(xys, conics, opacities, gids, bins, tiles, 16, 32):
        t, p, k = c.keep.shape
        for px in total:
            total[px] += int(c.keep.view(t, p // px, px, k).any(2).sum())
    return total


def step_cotangents(acc, final_t, tiles, gt, scene, model_cfg):
    """The cotangents of the train step's loss at K1's outputs: the rest of
    ``render_scene`` (black background, ``min(rgb, 1)``) and ``rgb_loss``
    on top of ``acc`` and ``final_t``, differentiated by autograd."""
    acc = acc.detach().requires_grad_()
    final_t = final_t.detach().requires_grad_()
    img = _tiles_to_image(acc, tiles, 16, H, W)[..., :3]
    rgb = torch.minimum(img, torch.ones_like(img))
    loss = sum(rgb_loss(rgb, gt, scene, model_cfg).values())
    # final_t reaches this loss only through the black background: its
    # cotangent is zero (phase 9 also checks a random one)
    g_acc, _ = torch.autograd.grad(loss, [acc, final_t], allow_unused=True)
    return g_acc, torch.zeros_like(final_t)


def compare_steps(metrics, metrics_p, before, got, want, optim_cfg, step=0):
    """The kernel step against the plain step from the same state at
    ``step``, with the CPU step test's tolerances: loss rtol 1e-4; first
    moments and sqrt of second moments at the gradient tolerance;
    parameter updates at rtol 5e-3 where |mu| > 1e-3 max|mu| and within 2
    lr (the step's) elsewhere; at most 0.5% of a group outside."""
    for k in ("loss", "main_loss", "psnr"):
        a, b = float(metrics[k]), float(metrics_p[k])
        assert math.isclose(a, b, rel_tol=1e-4), f"{k}: {a} vs plain {b}"
    worst = {}

    def outside(name, x, y, rtol, atol):
        bad = ~np.isclose(x, y, rtol=rtol, atol=atol)
        worst[name] = int(bad.sum())
        assert bad.mean() <= MAX_OUTSIDE, (
            f"train step {name}: {int(bad.sum())} of {bad.size} outside"
        )

    for g in ("means", "scales", "quats", "features_dc", "features_rest",
              "opacities"):
        mu_key, nu_key = f".adam/.mu/['{g}']", f".adam/.nu/['{g}']"
        mu_p = want[mu_key]
        scale = 1e-4 * max(float(np.abs(mu_p).max()), 1e-30)
        outside(f"mu {g}", got[mu_key], mu_p, RTOL_GRAD, scale)
        sq_p = np.sqrt(want[nu_key])
        outside(f"sqrt nu {g}", np.sqrt(got[nu_key]), sq_p, RTOL_GRAD,
                1e-4 * max(float(sq_p.max()), 1e-30))
        d_k = got[f".scene/.{g}"] - before[f".scene/.{g}"]
        d_p = want[f".scene/.{g}"] - before[f".scene/.{g}"]
        strong = np.abs(mu_p) > 1e-3 * np.abs(mu_p).max()
        lr = float(optim_cfg.schedule_for(g)(torch.tensor(step)))
        bad = np.where(strong, ~np.isclose(d_k, d_p, rtol=RTOL_GRAD, atol=0.0),
                       np.abs(d_k - d_p) > 2.0 * lr + 1e-7)
        worst[f"update {g}"] = int(bad.sum())
        assert bad.mean() <= MAX_OUTSIDE, f"train step update {g}"
    norm_p = want[".refine/.xys_grad_norm"]
    outside("xys_grad_norm", got[".refine/.xys_grad_norm"], norm_p, RTOL_GRAD,
            1e-4 * float(norm_p.max()))
    for k in ("vis_counts", "max_2dsize"):
        outside(k, got[f".refine/.{k}"], want[f".refine/.{k}"], 1e-6, 0.0)
    print(f"kernel step vs plain step: loss {float(metrics['loss']):.6f} vs "
          f"{float(metrics_p['loss']):.6f}; entries outside tolerance {worst}")


def _copy_renumbered(src: Path, dst: Path, prefix: str) -> list:
    """Copy ``src``'s ``<prefix>_NNNNN.png`` to ``dst`` as ``<prefix>_{N+1}``:
    gs-process-data numbers frames from 1."""
    dst.mkdir(parents=True, exist_ok=True)
    names = []
    for p in sorted(src.glob(f"{prefix}_*.png")):
        name = f"{prefix}_{int(p.stem.split('_')[1]) + 1:05d}.png"
        shutil.copy(p, dst / name)
        names.append(name)
    return names


def _quat(r: np.ndarray) -> np.ndarray:
    """wxyz quaternion of a rotation matrix (Shepperd's branches)."""
    tr = np.trace(r)
    if tr > 0:
        s = 2 * np.sqrt(1 + tr)
        return np.array([s / 4, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                         (r[1, 0] - r[0, 1]) / s])
    a = int(np.argmax(np.diag(r)))
    b, c = (a + 1) % 3, (a + 2) % 3
    s = 2 * np.sqrt(1 + r[a, a] - r[b, b] - r[c, c])
    q = np.zeros(4)
    q[0] = (r[c, b] - r[b, c]) / s
    q[1 + a] = s / 4
    q[1 + b] = (r[b, a] + r[a, b]) / s
    q[1 + c] = (r[c, a] + r[a, c]) / s
    return q


def write_colmap_text(data: Path, model: Path, names: list) -> int:
    """A COLMAP text model of the raytraced views: one PINHOLE camera, each
    view's known pose (OpenGL c2w -> COLMAP w2c), the seed cloud as the
    points, and as each view's observations up to ``PD_OBS`` seed points
    that it sees unoccluded (their depth within 2% of the view's GT depth
    at that pixel). Returns the point count."""
    meta = json.loads((data / "transforms.json").read_text())
    fx, fy, cx, cy = meta["fl_x"], meta["fl_y"], meta["cx"], meta["cy"]
    w, h = meta["w"], meta["h"]
    pts, rgb = read_ply_points(data / "sparse.ply")
    pts = pts.astype(np.float64)
    rng = np.random.default_rng(SEED)
    tracks = [[] for _ in range(len(pts))]
    lines = []
    flip = np.diag([1.0, -1.0, -1.0])
    for i, (fr, name) in enumerate(zip(meta["frames"], names)):
        c2w = np.asarray(fr["transform_matrix"], np.float64)
        r_w2c = c2w[:3, :3].T
        t_w2c = -r_w2c @ c2w[:3, 3]
        r_cv, t_cv = flip @ r_w2c, flip @ t_w2c
        pc = pts @ r_cv.T + t_cv
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = fx * pc[:, 0] / z + cx
            v = fy * pc[:, 1] / z + cy
        vis = (z > 0.05) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        gt_z = read_png(data / fr["depth_path"]).astype(np.float64) * 1e-3
        ui = np.clip(np.nan_to_num(u).astype(int), 0, w - 1)
        vi = np.clip(np.nan_to_num(v).astype(int), 0, h - 1)
        zi = gt_z[vi, ui]
        vis &= (zi > 0) & (np.abs(z - zi) < 0.02 * np.maximum(z, 1e-6))
        idx = np.flatnonzero(vis)
        idx = np.sort(rng.choice(idx, min(PD_OBS, idx.size), replace=False))
        q = _quat(r_cv)
        lines.append(f"{i + 1} {' '.join(repr(float(x)) for x in q)} "
                     f"{' '.join(repr(float(x)) for x in t_cv)} 1 {name}")
        lines.append(" ".join(f"{float(u[j])!r} {float(v[j])!r} {j + 1}"
                              for j in idx))
        for k, j in enumerate(idx):
            tracks[j].append(f"{i + 1} {k}")
    model.mkdir(parents=True, exist_ok=True)
    (model / "cameras.txt").write_text(f"1 PINHOLE {w} {h} {fx!r} {fy!r} "
                                       f"{cx!r} {cy!r}\n")
    (model / "images.txt").write_text("\n".join(lines) + "\n")
    with open(model / "points3D.txt", "w") as f:
        for j, (p, c) in enumerate(zip(pts, rgb.astype(int))):
            xyz = " ".join(repr(float(x)) for x in p)
            f.write(f"{j + 1} {xyz} {c[0]} {c[1]} {c[2]} 0.5 "
                    f"{' '.join(tracks[j])}\n")
    return len(pts)


def process_data_phase(work_dir: Path, counters) -> dict:
    """Phase 16: gs-process-data on phase 15's raytraced views and mono
    estimates, gs-train on its output, the depth estimators and the
    equirect extraction; the counters reset just before the training run
    and read just after."""
    phase("16 data processing: gs-process-data, gs-train on its output, "
          "depth estimation, equirect views")
    t0 = time.perf_counter()
    data = work_dir / "raytraced"
    raw = work_dir / "pd_raw"
    names = _copy_renumbered(data / "images", raw, "frame")
    mono = work_dir / "pd_mono"
    _copy_renumbered(work_dir / "raytraced_mono" / "depths_mono", mono, "depth")
    out = work_dir / "processed"
    n_pts = write_colmap_text(data, out / "colmap" / "sparse" / "0", names)
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gstk_torch.scripts.process_data", "images",
         "--data", str(raw), "--output-dir", str(out), "--skip-colmap",
         "--num-downscales", "3", "--mono-depth-data", str(mono)],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    cli_s = time.perf_counter() - t1
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    print(proc.stdout.strip().splitlines()[-1])
    meta = json.loads((out / "transforms.json").read_text())
    assert len(meta["frames"]) == RT_VIEWS
    assert all("scale" in f and "shift" in f for f in meta["frames"])
    assert len(read_ply_points(out / "colmap" / "point_cloud.ply")[0]) == n_pts
    worst = 0.0
    for name in names:
        img = read_png(out / "images" / name).astype(np.float64)
        for d in (2, 4, 8):
            small = read_png(out / f"images_{d}" / name)
            hh, ww = img.shape[0] // d, img.shape[1] // d
            mean = img[:hh * d, :ww * d].reshape(hh, d, ww, d, -1).mean((1, 3))
            assert small.shape == mean.shape, (name, d)
            worst = max(worst, float(np.abs(small - mean).max()))
    assert worst <= 0.5, f"a pyramid level is off the box mean by {worst}"
    # the pipeline's per-frame mono scale against a dense fit of each
    # estimate to the view's true depth: est = m z + c, scale = m / 255,
    # over the pixels where neither PNG saturates (far ground: 65535)
    rel = []
    for fr in meta["frames"]:
        i = int(Path(fr["file_path"]).stem.split("_")[1]) - 1
        z = read_png(data / "depths" / f"depth_{i:05d}.png").astype(np.float64)
        est = read_png(work_dir / "raytraced_mono" / "depths_mono"
                       / f"depth_{i:05d}.png").astype(np.float64)
        ok = (z > 0) & (z < 65535) & (est < 65535)
        m, _ = np.polyfit(z[ok] * 1e-3, est[ok], 1)
        rel.append(abs(fr["scale"] - m / 255.0) / (m / 255.0))
    recovery = {"median": float(np.median(rel)), "max": float(np.max(rel))}
    print(f"gs-process-data ({cli_s:.1f} s, a fresh process): {RT_VIEWS} views, "
          f"{n_pts} seed points, pyramids within {worst} of the box mean; mono "
          f"scale against the dense fit to the true depth: median rel error "
          f"{recovery['median']:.4%}, max {recovery['max']:.4%}")
    assert recovery["median"] <= MONO_MAX_ERR, recovery

    PROFILER.totals.clear()
    PROFILER.counts.clear()
    for f in counters:
        f.launches = 0
    t1 = time.perf_counter()
    trainer = train_main([
        "--device", DEVICE, "gaussian-splatting", "--data", str(out),
        "--output-dir", str(work_dir / "pd_runs"),
        "--max-num-iterations", str(PD_ITERS), "--steps-per-eval-image", "0",
        "--steps-per-eval-all-images", str(PD_ITERS),
        "--steps-per-save", str(PD_ITERS), "--model.num-downscales", "0",
        "--dataparser.eval-mode", "interval", "--dataparser.eval-interval", "8",
    ])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = launches_of(counters)
    for name, n in launches.items():
        assert n >= 1, f"{name} not launched by gs-train on gs-process-data's output"
    rows = [json.loads(line) for line in
            (trainer.config.run_dir / "metrics.jsonl").open()]
    col = lambda key: [(r["step"], r[key]) for r in rows if key in r]
    assert all(math.isfinite(v) for _, v in col("loss")), "loss not finite"
    iter_ms = [v * 1e3 for _, v in col("Train Iter (time)")][1:]
    final_eval = col("eval_psnr")[-1][1]
    print(f"gs-train on the processed set: {PD_ITERS} steps in {run_s:.1f} s, "
          f"ITER_TRAIN_TIME median {statistics.median(iter_ms):.3f} ms, final "
          f"eval PSNR {final_eval:.3f}, launches {launches}")
    PROFILER.totals.clear()
    PROFILER.counts.clear()

    # the depth estimators: a registered torch model on the card, and the
    # placeholder through the CLI (never "auto": it would try the network)
    def card_depth(images):
        outs = []
        kernel = torch.full((1, 1, 9, 9), 1.0 / 81, device=DEVICE)
        for img in images:
            t = torch.from_numpy(img).to(DEVICE).float().mean(-1)[None, None]
            outs.append((1.0 + torch.nn.functional.conv2d(
                t, kernel, padding=4))[0, 0].cpu().numpy())
        return outs

    register_depth_model("card_blur", card_depth)
    est_s = synchronized_s(lambda: estimate_depths(
        out / "images", work_dir / "pd_est", method="card_blur"))
    est = sorted((work_dir / "pd_est").glob("depth_*.png"))
    assert len(est) == RT_VIEWS and read_png(est[0]).dtype == np.uint16
    toy = work_dir / "processed_toy"
    shutil.copytree(out / "colmap" / "sparse", toy / "colmap" / "sparse")
    t1 = time.perf_counter()
    process_data_main(["images", "--data", str(raw), "--output-dir", str(toy),
                       "--skip-colmap", "--num-downscales", "0",
                       "--using-est-depth", "--depth-method", "gradient",
                       "--allow-toy-depth"])
    toy_s = time.perf_counter() - t1
    toy_meta = json.loads((toy / "transforms.json").read_text())
    assert all("scale" in f for f in toy_meta["frames"])
    print(f"estimate_depths with a torch model on the card: {RT_VIEWS} views "
          f"in {est_s:.2f} s; gs-process-data --using-est-depth "
          f"--depth-method gradient --allow-toy-depth in process: {toy_s:.1f} s")

    # (b) 8 pinhole views out of a 2048x4096 equirect capture
    pano = work_dir / "pano"
    pano.mkdir()
    yy, xx = np.mgrid[0:EQ_H, 0:EQ_W]
    rng = np.random.default_rng(SEED)
    img = np.stack([128 + 100 * np.sin(xx / 37.0 + c) * np.cos(yy / 23.0 - c)
                    for c in range(3)], -1) + rng.normal(0, 8, (EQ_H, EQ_W, 3))
    write_png(pano / "pano.png", np.clip(img, 0, 255).astype(np.uint8))
    t1 = time.perf_counter()
    views = generate_planar_projections_from_equirectangular(
        pano, work_dir / "pano_views", samples_per_image=EQ_VIEWS)
    eq_s = (time.perf_counter() - t1) / EQ_VIEWS
    assert len(views) == EQ_VIEWS and read_png(views[0]).shape == (720, 960, 3)
    print(f"equirect {EQ_W}x{EQ_H} -> {EQ_VIEWS} views at 960x720: {eq_s:.3f} s "
          f"a view (host numpy, PNG written)")
    loaded = [m for m in ("PIL", "cv2", "yaml", "transformers")
              if m in sys.modules]
    assert not loaded, f"phase 16 imported {loaded}"
    wall_s = time.perf_counter() - t0
    print(f"phase 16 wall time {wall_s:.1f} s")
    return {"launches": {"gs_train_on_processed": launches},
            "cli_s": cli_s, "seed_points": n_pts, "pyramid_max_off": worst,
            "mono_scale_rel_error": recovery, "train_run_s": run_s,
            "step_ms_median": statistics.median(iter_ms),
            "final_eval_psnr": final_eval, "estimate_depths_s": est_s,
            "toy_depth_cli_s": toy_s, "equirect_s_per_view": eq_s,
            "wall_s": wall_s}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat_copy(state) -> dict:
    return {k: v.copy() for k, v in train_state_to_numpy(state).items()}


def _mismatches(got: dict, want: dict) -> dict:
    """Keys whose arrays differ, with the largest difference."""
    return {k: float(np.abs(got[k].astype(np.float64) - v).max())
            for k, v in want.items() if not np.array_equal(got[k], v)}


def parallel_phase(work_dir: Path, counters, trained: dict) -> dict:
    """Phase 17: (a) gs-train from a one-rank NCCL group, a data-parallel
    step over it against the plain step; (b) two gloo ranks on the card:
    the DP step, the tile-sharded render, the Gaussian-sharded render, step
    and refine, each against its one-process counterpart."""
    phase("17 parallelism: NCCL at world size 1, two gloo ranks on the card")
    t0 = time.perf_counter()
    data = work_dir / "synthetic"
    for f in counters:
        f.launches = 0
    PROFILER.totals.clear()
    PROFILER.counts.clear()
    trainer = train_main([
        "--device", DEVICE, "gaussian-splatting", "--data", str(data),
        "--output-dir", str(work_dir / "par_runs"),
        "--max-num-iterations", str(PAR_ITERS), "--steps-per-eval-image", "0",
        "--steps-per-eval-all-images", "0", "--steps-per-save", str(PAR_ITERS),
        "--model.num-downscales", "0",
        "--dataparser.eval-mode", "interval", "--dataparser.eval-interval", "8",
        "--coordinator-address", f"127.0.0.1:{_free_port()}",
        "--num-processes", "1", "--process-id", "0",
    ])
    torch.cuda.synchronize()
    nccl_launches = launches_of(counters)
    assert dist.is_initialized() and dist.get_backend() == (
        "nccl" if DEVICE == "cuda" else "gloo")
    assert trainer.world == 1 and all(n >= 1 for n in nccl_launches.values())
    rows = [json.loads(line) for line in
            (trainer.config.run_dir / "metrics.jsonl").open()]
    iter_ms = [r["Train Iter (time)"] * 1e3 for r in rows
               if "Train Iter (time)" in r][1:]
    PROFILER.totals.clear()
    PROFILER.counts.clear()
    # one DP step over the one-rank group from phase 11's trained state
    ckpt = latest_checkpoint(work_dir / "runs" / "synthetic"
                             / "gaussian-splatting" / "ckpts")
    with np.load(ckpt) as z:
        flat = {k: z[k] for k in z.files}
    meta = peek_meta(ckpt)
    raster = RasterizeConfig(isect_capacity=int(meta["isect_capacity"]),
                             bands=int(meta.get("bands", 1)))
    model_cfg = trainer.config.model
    frame = trainer.datamanager.train_frames[0]
    camera = Camera.create(frame.fx, frame.fy, frame.cx, frame.cy, frame.c2w,
                           device=DEVICE)
    gt = torch.from_numpy(frame.image).to(DEVICE)
    results = {}
    for name, kw in (("plain", {}),
                     ("dp", {"axis_name": DATA_AXIS, "mesh": get_mesh()})):
        step = make_train_step(model_cfg, raster, OptimizerConfig(), H, W,
                               sh_degree=SH_DEGREE, **kw)
        state = train_state_from_numpy(flat, DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        state, m = step(state, camera, gt, gen)
        torch.cuda.synchronize()
        results[name] = (_flat_copy(state), {k: float(v) for k, v in m.items()})
    bad = _mismatches(results["dp"][0], results["plain"][0])
    assert not bad and results["dp"][1] == results["plain"][1], bad
    dist.destroy_process_group()
    print(f"17(a) gs-train over a one-rank NCCL group ({PAR_ITERS} steps): "
          f"ITER_TRAIN_TIME median {statistics.median(iter_ms):.3f} ms (phase "
          f"11: {trained['step_ms']['median']:.3f}); launches {nccl_launches}; "
          f"a DP step from phase 11's state equals the plain step bit for bit")

    # (b) two gloo ranks on the card, against one process here
    io = work_dir / "ranks"
    io.mkdir()
    np.savez(io / "in.npz", ckpt=str(ckpt), c2w=frame.c2w, data=str(data),
             intrinsics=np.array([frame.fx, frame.fy, frame.cx, frame.cy]))
    t1 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--rank", str(r), "2",
         str(io)], cwd=REPO, stdout=open(io / f"rank_{r}.log", "w"),
        stderr=subprocess.STDOUT) for r in range(2)]
    deadline = time.monotonic() + RANK_DEADLINE_S
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    ranks_s = time.perf_counter() - t1
    for r, p in enumerate(procs):
        log = (io / f"rank_{r}.log").read_text()
        assert p.returncode == 0, f"rank {r} rc {p.returncode}:\n{log[-4000:]}"
    outs = [dict(np.load(io / f"out_{r}.npz")) for r in range(2)]
    reports = [json.loads(str(o["report"])) for o in outs]
    for k in outs[0]:
        if k.startswith("dp.") or k.startswith("gauss"):
            assert np.array_equal(outs[0][k], outs[1][k]), f"ranks differ: {k}"
    # the DP step against one Adam step on the mean of the two one-camera
    # gradients here (each read back from its first moment, (1 - b1) g)
    optim_cfg = OptimizerConfig()
    state_fn = make_train_step(
        VanillaConfig(sh_degree=SH_DEGREE, background_color="black"),
        RasterizeConfig(isect_capacity=TRAIN_ISECT), optim_cfg, H, W,
        sh_degree=SH_DEGREE)
    gt8 = torch.rand((H, W, 3), device=DEVICE,
                     generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    singles, single_metrics = [], []
    for r in range(2):
        cam = Camera.create(FOCAL, FOCAL, W / 2, H / 2, pose(r), device=DEVICE)
        state, m = state_fn(init_train_state(bench_scene(DEVICE)), cam, gt8)
        singles.append(_flat_copy(state))
        single_metrics.append({k: float(v) for k, v in m.items()})
    ref = init_train_state(bench_scene(DEVICE))
    before = _flat_copy(ref)
    mu = lambda s, g: s[f".adam/.mu/['{g}']"]
    mean_grads = {g: torch.from_numpy(0.5 * (mu(singles[0], g) + mu(singles[1], g))
                                      / (1.0 - optim_cfg.b1)).to(DEVICE)
                  for g in ref.scene.params()}
    ref.adam = adam_step(ref.scene.params(), mean_grads, ref.adam, ref.step,
                         optim_cfg, update_mask=ref.scene.alive)
    want = _flat_copy(ref)
    want[".refine/.xys_grad_norm"] = (singles[0][".refine/.xys_grad_norm"]
                                      + singles[1][".refine/.xys_grad_norm"])
    want[".refine/.vis_counts"] = (singles[0][".refine/.vis_counts"]
                                   + singles[1][".refine/.vis_counts"])
    want[".refine/.max_2dsize"] = np.maximum(
        singles[0][".refine/.max_2dsize"], singles[1][".refine/.max_2dsize"])
    dp = {k[3:]: v for k, v in outs[0].items() if k.startswith("dp.")}
    np.testing.assert_array_equal(dp[".refine/.vis_counts"],
                                  want[".refine/.vis_counts"])
    mean_metrics = {k: 0.5 * (single_metrics[0][k] + single_metrics[1][k])
                    for k in ("loss", "main_loss", "psnr")}
    compare_steps(reports[0]["dp_step_metrics"], mean_metrics, before, dp,
                  want, optim_cfg)
    named = reports[0]["gauss_step_mismatches"]
    for r, rep in enumerate(reports):
        got = rep["launches"]
        for path in ("dp_step", "gauss_step", "gauss_train"):
            assert all(n >= 1 for n in got[path].values()), (r, path, got[path])
        for path in ("tile_render", "gauss_render"):
            assert got[path]["composite_tiles_fwd"] >= 1, (r, path)
            assert got[path]["segment_broadcast"] >= 1, (r, path)
        print(f"rank {r} ({rep['backend']}): DP step {rep['dp_step_ms_median']:.3f} "
              f"ms (collectives {rep['dp_collectives_ms']}); 1080p tile-sharded "
              f"{rep['tile_render_ms']:.3f} ms against one rank's "
              f"{rep['single_render_ms']:.3f} ({rep['tile_intersections']} "
              f"intersections, max abs err {rep['tile_max_abs_err']}); "
              f"Gaussian-sharded step {rep['gauss_step_ms']:.3f} ms, peak "
              f"{rep['gauss_step_peak_mib']:.1f} MiB against the replicated "
              f"{rep['replicated_step_ms']:.3f} ms, "
              f"{rep['replicated_step_peak_mib']:.1f} MiB (gathers "
              f"{rep['gauss_collectives_ms']}); refine gather "
              f"{rep['gauss_refine_gather_ms']:.3f} ms, peak "
              f"{rep['gauss_refine_gather_peak_mib']:.1f} MiB; sharded refine "
              f"{rep['gauss_refine_sharded_ms']:.3f} ms, peak "
              f"{rep['gauss_refine_sharded_peak_mib']:.1f} MiB; launches {got}")
        print(f"rank {r} at 2^21 lanes ({rep['big_state_mib']:.1f} MiB a "
              f"rank): " + "; ".join(
                  f"{what} {rep[f'big_{what}_ms']:.3f} ms, peak "
                  f"{rep[f'big_{what}_peak_mib']:.1f} MiB"
                  for what in ("refine_gather", "refine_sharded", "grow_gather",
                               "grow_sharded", "ckpt_gathered",
                               "ckpt_sharded"))
              + f"; refine info {rep['big_refine_info']}")
        # the sharded refine against the gather it replaces, phase 11's state
        assert (rep["gauss_refine_sharded_peak_mib"]
                < 0.5 * rep["gauss_refine_gather_peak_mib"]), rep
    # the sharded gs-train run's rank-0 checkpoint in gs-eval
    run = reports[0]["gauss_train"]
    res = eval_cli.main(["--load-config", str(Path(run["run_dir"]) / "config.yml"),
                         "--output-path", str(io / "gauss_eval.json"),
                         "--skip-lpips"])
    assert np.isfinite(res["results"]["psnr"]), res["results"]
    run["gs_eval_psnr"] = res["results"]["psnr"]
    print(f"17(b) gs-train --param-sharding auto on the two ranks: {run}")
    wall_s = time.perf_counter() - t0
    print(f"17(b) two gloo ranks on the card in {ranks_s:.1f} s: the DP step "
          f"equals one Adam step on the mean of the one-camera gradients "
          f"(moments, parameters, statistics); tile-sharded 1080p "
          f"= the single render; the Gaussian-sharded render, step and refine "
          f"= the replicated ones (ops off by rounding: {named or 'none'}), "
          f"and at 2^21 lanes the sharded refine and growth; "
          f"phase 17 wall time {wall_s:.1f} s")
    return {"launches": {"nccl_world1_run": nccl_launches,
                         "ranks": [rep["launches"] for rep in reports]},
            "nccl_world1_step_ms_median": statistics.median(iter_ms),
            "phase11_step_ms_median": trained["step_ms"]["median"],
            "ranks": reports, "ranks_s": ranks_s, "wall_s": wall_s}


def rank_main(rank: int, world: int, io: Path) -> int:
    """One gloo rank of phase 17(b) on the card (``chip_smoke.py --rank r n
    dir``): NCCL takes one rank a card, so the two ranks meet over gloo."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{io / 'store'}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=120))
    counters = (composite_tiles_fwd, composite_tiles_bwd, segment_broadcast,
                segment_sum_sorted)
    with np.load(io / "in.npz") as z:
        ckpt, c2w, (fx, fy, cx, cy) = Path(str(z["ckpt"])), z["c2w"], z["intrinsics"]
    out, report, launches = {}, {}, {}

    def counted(name, fn):
        torch.cuda.synchronize()
        dist.barrier()
        for f in counters:
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        report[name + "_ms"] = (time.perf_counter() - t0) * 1e3
        report[name + "_peak_mib"] = (torch.cuda.max_memory_allocated() - held) / 2**20
        launches[name] = launches_of(counters)
        return result

    # the DP step at bench.py's train point, this rank's camera pose(rank)
    mesh = get_mesh()
    data = mesh[DATA_AXIS]
    model_cfg = VanillaConfig(sh_degree=SH_DEGREE, background_color="black")
    train_raster = RasterizeConfig(isect_capacity=TRAIN_ISECT)
    step = make_train_step(model_cfg, train_raster, OptimizerConfig(), H, W,
                           sh_degree=SH_DEGREE, axis_name=DATA_AXIS, mesh=mesh)
    gt8 = torch.rand((H, W, 3), device=DEVICE,
                     generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    cam = Camera.create(FOCAL, FOCAL, W / 2, H / 2, pose(rank), device=DEVICE)
    state = init_train_state(bench_scene(DEVICE))
    state, m = counted("dp_step", lambda: step(state, cam, gt8))
    report["dp_step_metrics"] = {k: float(m[k])
                                 for k in ("loss", "main_loss", "psnr")}
    out.update({"dp." + k: v for k, v in _flat_copy(state).items()})
    steps_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, cam, gt8)
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
    report["dp_step_ms_median"] = statistics.median(steps_ms)
    # the step's three collectives alone, at its sizes
    n_grad = sum(v.numel() for v in state.scene.params().values())
    bufs = (("f32 sum", torch.zeros(n_grad + CAPACITY + 8, device=DEVICE),
             data.sum_),
            ("i32 sum", torch.zeros(CAPACITY, dtype=torch.int32, device=DEVICE),
             data.sum_),
            ("i32 max", torch.zeros(CAPACITY + 1, dtype=torch.int32,
                                    device=DEVICE), data.max_))
    coll = {}
    for name, buf, fn in bufs:
        fn(buf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn(buf)
        torch.cuda.synchronize()
        coll[name] = (time.perf_counter() - t0) * 1e3 / 5
    report["dp_collectives_ms"] = coll
    report["dp_collectives_ms_per_step"] = sum(coll.values())
    del state

    # the tile-sharded render of a 1920x1080 frame of phase 11's scene
    with np.load(ckpt) as z:
        flat = {k: z[k] for k in z.files}
    meta = peek_meta(ckpt)
    full = train_state_from_numpy(flat, DEVICE)
    scene = full.scene
    # a train view's pose at the trajectory's size, its vertical field kept
    scale = TRAJ_H / H
    tcam = Camera.create(fx * scale, fy * scale, TRAJ_W / 2, TRAJ_H / 2, c2w,
                         device=DEVICE)
    tile_raster = RasterizeConfig(isect_capacity=TILE_ISECT)
    with torch.no_grad():
        inputs = splat_inputs(scene, tcam, TRAJ_H, TRAJ_W,
                              sh_degree=SH_DEGREE, config=VanillaConfig())
        bg = torch.tensor(EVAL_BACKGROUND, device=DEVICE)
        bg4 = torch.cat([bg, bg.new_zeros(1)])  # RGB and depth
        img, alpha = counted("tile_render", lambda: rasterize_tile_sharded(
            **inputs, img_height=TRAJ_H, img_width=TRAJ_W,
            mesh=make_tile_mesh(), background=bg4, config=tile_raster))
        ref, ref_alpha, info = rasterize(
            **inputs, img_height=TRAJ_H, img_width=TRAJ_W, background=bg4,
            config=tile_raster, return_info=True)
    assert int(info["num_intersects"]) <= TILE_ISECT, "1080p frame truncated"
    assert_close("tile-sharded rgb", img, ref, **PARITY, max_outside=0.001)
    assert_close("tile-sharded alpha", alpha, ref_alpha, **PARITY,
                 max_outside=0.001)
    report["tile_max_abs_err"] = float((img - ref).abs().max())
    report["tile_intersections"] = int(info["num_intersects"])
    report["single_render_ms"] = synchronized_s(lambda: rasterize(
        **inputs, img_height=TRAJ_H, img_width=TRAJ_W, background=bg4,
        config=tile_raster)) * 1e3
    del inputs, img, ref

    # the Gaussian-sharded render, step and refine from phase 11's state
    gmesh = make_gauss_mesh()
    frame_cam = Camera.create(fx, fy, cx, cy, c2w, device=DEVICE)
    raster = RasterizeConfig(isect_capacity=int(meta["isect_capacity"]))
    cfg = VanillaConfig(sh_degree=SH_DEGREE)
    kw = dict(sh_degree=SH_DEGREE, background=bg, config=cfg,
              raster_config=raster)
    sharded_state = shard_train_state(full, gmesh)
    with torch.no_grad():
        ref = render_scene(scene, frame_cam, H, W, **kw)
        got = counted("gauss_render", lambda: render_scene_gauss_sharded(
            sharded_state.scene, frame_cam, H, W, mesh=gmesh, **kw))
    for k in ("rgb", "depth", "alpha"):
        assert torch.equal(got[k], ref[k]), f"Gaussian-sharded {k} differs"
    del got, ref
    step_r = make_train_step(cfg, raster, OptimizerConfig(), H, W,
                             sh_degree=SH_DEGREE)
    step_s = make_train_step(cfg, raster, OptimizerConfig(), H, W,
                             sh_degree=SH_DEGREE, mesh=gmesh)
    gen = lambda: torch.Generator(device=DEVICE).manual_seed(SEED)
    want, m_want = counted("replicated_step",
                           lambda: step_r(full, frame_cam, gt8, gen()))
    got, m_got = counted("gauss_step",
                         lambda: step_s(sharded_state, frame_cam, gt8, gen()))
    want_flat = _flat_copy(want)
    got_full = gather_train_state(got, gmesh)
    bad = _mismatches(_flat_copy(got_full), want_flat)
    report["gauss_step_mismatches"] = bad
    for k in bad:  # an op that rounds otherwise at the shard's row count
        assert_close(f"Gaussian-sharded {k}",
                     torch.from_numpy(_flat_copy(got_full)[k]),
                     torch.from_numpy(want_flat[k]), RTOL_GRAD,
                     1e-4 * float(np.abs(want_flat[k]).max()), MAX_OUTSIDE)
    assert {k: float(v) for k, v in m_got.items()} == \
        {k: float(v) for k, v in m_want.items()}
    axis = gmesh["gauss"]
    n_local = got.scene.capacity
    coll = {}
    for name, buf in (("f32 gather", torch.zeros((n_local, 11), device=DEVICE)),
                      ("i32 gather", torch.zeros((n_local, 2), dtype=torch.int32,
                                                 device=DEVICE))):
        axis.all_gather(buf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            axis.all_gather(buf)
        torch.cuda.synchronize()
        coll[name] = (time.perf_counter() - t0) * 1e3 / 5
    report["gauss_collectives_ms"] = coll
    report["gauss_state_mib"] = sum(
        v.numel() * v.element_size() for v in list(got.scene.params().values())
        + list(got.adam.mu.values()) + list(got.adam.nu.values())) / 2**20
    # one refine: gathered, refined with the same noise, sharded again
    # (the reference), then the sharded refine of the same shards
    gathered = counted("gauss_refine_gather", lambda: gather_train_state(got, gmesh))
    _, _, gathered.refine, _ = refine(
        gathered.scene, gathered.adam, gathered.refine, REFINE_STEP, cfg, 21,
        W, generator=gen())
    refined = gather_train_state(shard_train_state(gathered, gmesh), gmesh)
    del gathered
    g_want = gen()
    _, _, want.refine, _ = refine(want.scene, want.adam, want.refine,
                                  REFINE_STEP, cfg, 21, W, generator=g_want)
    bad = _mismatches(_flat_copy(refined), _flat_copy(want))
    assert not bad, f"the gathered refine differs: {bad}"
    g_got = gen()
    _, _, got.refine, info = counted("gauss_refine_sharded", lambda: refine(
        got.scene, got.adam, got.refine, REFINE_STEP, cfg, 21, W,
        generator=g_got, mesh=gmesh))
    bad = _mismatches(_flat_copy(gather_train_state(got, gmesh)),
                      _flat_copy(refined))
    assert not bad, f"the sharded refine differs: {bad}"
    assert torch.equal(g_got.get_state(), g_want.get_state())
    report["gauss_refine_info"] = {k: int(v) for k, v in info.items()}
    out.update({"gauss." + k: v for k, v in _flat_copy(refined).items()
                if k.startswith(".scene")})
    del want, got, refined, sharded_state, full, scene
    sharded_at_scale(gmesh, counted, report)
    gauss_train_run(io, rank, counted, report)
    report["launches"] = launches
    report["backend"] = dist.get_backend(data.group)  # gloo, on CUDA tensors
    out["report"] = json.dumps(report)
    dist.barrier()
    np.savez(io / f"out_{rank}.npz", **out)
    dist.destroy_process_group()
    return 0


def seeded_state(capacity: int, seed: int):
    """A train state of ``capacity`` lanes at SH degree ``SH_DEGREE`` made
    on the card from ``seed``, due a densifying refine at ``REFINE_STEP``:
    0.85 of the lanes alive, scales around exp(-4.6) (the split size), one
    lane in ten past the gradient threshold, random moments."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    normal = lambda *shape: torch.randn((capacity,) + shape, generator=g,
                                        device=DEVICE)
    uniform = lambda: torch.rand((capacity,), generator=g, device=DEVICE)
    rest = (SH_DEGREE + 1) ** 2 - 1
    scene = GaussianScene(
        means=2.0 * normal(3), scales=0.5 * normal(3) - 4.6, quats=normal(4),
        features_dc=normal(3), features_rest=0.1 * normal(rest, 3),
        opacities=2.0 * normal(1), alive=uniform() < 0.85)
    state = init_train_state(scene)
    for moments in (state.adam.mu, state.adam.nu):
        for v in moments.values():
            v.copy_(normal(*v.shape[1:]).abs_())
    vis = torch.floor(uniform() * 20.0)
    # avg_grad = norm / vis * 0.5 * W passes 2e-4 where normal() > 1.28
    state.refine = RefineState(
        xys_grad_norm=vis * (4e-4 / W) * torch.exp(normal() - 1.28),
        vis_counts=vis, max_2dsize=0.1 * uniform())
    state.step = torch.tensor(REFINE_STEP, dtype=torch.int32, device=DEVICE)
    return state


def sharded_at_scale(gmesh, counted, report) -> None:
    """Phase 17(b) at 2^21 global lanes (SH 3): the sharded refine equal
    bit for bit to the replicated refine of the whole state, and the
    sharded growth 2^20 -> 2^21 equal to the padded state sharded again.
    Each rank makes the whole state from the seed, keeps its lanes of the
    reference result on the host, and frees the whole state before the
    sharded path and the whole-state gather it replaces are timed, each
    with its peak above the resident shard. Then the sharded checkpoint
    (rank 0 writes it) against one written from the gathered state:
    members equal byte for byte."""
    cfg = VanillaConfig(sh_degree=SH_DEGREE)
    gen = lambda: torch.Generator(device=DEVICE).manual_seed(SEED)
    full = seeded_state(BIG_CAPACITY, SEED)
    shard = shard_train_state(full, gmesh)
    g_want = gen()
    _, _, full.refine, info = refine(full.scene, full.adam, full.refine,
                                     REFINE_STEP, cfg, 21, W, generator=g_want)
    want = _flat_copy(shard_train_state(full, gmesh))
    del full
    torch.cuda.empty_cache()
    report["big_state_mib"] = sum(
        t.numel() * t.element_size() for t in
        [getattr(shard.scene, k) for k in FIELD_NAMES]
        + list(shard.adam.mu.values()) + list(shard.adam.nu.values())
        + list(shard.refine)) / 2**20
    counted("big_refine_gather", lambda: gather_train_state(shard, gmesh))
    g_got = gen()
    _, _, shard.refine, got_info = counted("big_refine_sharded", lambda: refine(
        shard.scene, shard.adam, shard.refine, REFINE_STEP, cfg, 21, W,
        generator=g_got, mesh=gmesh))
    bad = _mismatches(_flat_copy(shard), want)
    assert not bad, f"the sharded refine at 2^21 differs: {bad}"
    assert torch.equal(g_got.get_state(), g_want.get_state())
    info = {k: int(v) for k, v in info.items()}
    assert {k: int(v) for k, v in got_info.items()} == info
    assert info["num_split"] > 0 and info["num_dup"] > 0, info
    report["big_refine_info"] = info
    del want

    with tempfile.TemporaryDirectory(prefix="gstk_torch_ckpt_") as tmp:
        tmp = Path(tmp)
        extras = {"isect_capacity": TRAIN_ISECT, "bands": 1, "sh_degree": 3}
        counted("big_ckpt_sharded", lambda: save_checkpoint(
            tmp / "sharded", shard, extras=extras, mesh=gmesh))

        def gathered_ckpt():
            whole = gather_train_state(shard, gmesh)
            if gmesh["gauss"].index == 0:
                save_checkpoint(tmp / "gathered", whole, extras=extras)

        counted("big_ckpt_gathered", gathered_ckpt)
        if gmesh["gauss"].index == 0:
            (a,), (b,) = ((tmp / d).glob("*.npz") for d in ("sharded", "gathered"))
            with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
                assert za.namelist() == zb.namelist()
                for name in zb.namelist():
                    assert za.read(name) == zb.read(name), name
    del shard
    torch.cuda.empty_cache()

    small = seeded_state(BIG_CAPACITY // 2, SEED + 1)
    want = _flat_copy(shard_train_state(grow_train_state(small, BIG_CAPACITY),
                                        gmesh))
    shard = shard_train_state(small, gmesh)
    del small
    torch.cuda.empty_cache()
    counted("big_grow_gather", lambda: gather_train_state(shard, gmesh))
    grown = counted("big_grow_sharded",
                    lambda: grow_train_state(shard, BIG_CAPACITY, gmesh))
    bad = _mismatches(_flat_copy(grown), want)
    assert not bad, f"the sharded growth differs: {bad}"
    del shard, grown, want
    torch.cuda.empty_cache()
    assert (report["big_refine_sharded_peak_mib"]
            < 0.5 * report["big_refine_gather_peak_mib"]), report


def gauss_train_run(io: Path, rank: int, counted, report) -> None:
    """gs-train with ``--param-sharding auto`` on the two ranks, from phase
    11's dataset at a full capacity (headroom 1) with every visible
    Gaussian densifying and few culled (alpha threshold 0.005; the warmup
    covers step 10, so no opacity reset): refines every 10 steps
    (densifying at 40 and 50), a capacity growth after step 40, the
    checkpoint at step 50; the whole state gathered no time
    (``gather_train_state`` counted)."""
    with np.load(io / "in.npz") as z:
        data = str(z["data"])
    calls = []
    whole = gaussian_sharding.gather_train_state

    def counting(*args, **kwargs):
        calls.append(1)
        return whole(*args, **kwargs)

    gaussian_sharding.gather_train_state = counting
    PROFILER.totals.clear()
    PROFILER.counts.clear()
    try:
        trainer = counted("gauss_train", lambda: train_main([
            "--device", DEVICE, "gaussian-splatting", "--data", data,
            "--output-dir", str(io / "gauss_train"),
            "--max-num-iterations", str(GAUSS_TRAIN_ITERS),
            "--steps-per-eval-image", "0", "--steps-per-eval-all-images", "0",
            "--steps-per-save", str(GAUSS_TRAIN_ITERS),
            "--model.num-downscales", "0", "--model.warmup-length", "10",
            "--model.refine-every", "10", "--model.densify-grad-thresh",
            "1e-12", "--model.cull-alpha-thresh", "0.005",
            "--initial-capacity-headroom", "1.0",
            "--param-sharding", "auto",
            "--dataparser.eval-mode", "interval", "--dataparser.eval-interval",
            "8"]))
    finally:
        gaussian_sharding.gather_train_state = whole
    grew = [m for _, m in trainer.growth_events
            if m.startswith("Growing Gaussian capacity")]
    refines = PROFILER.counts.get("refine", 0)
    assert trainer.gauss_mesh is not None and not calls, len(calls)
    assert refines >= 2 and grew, (refines, trainer.growth_events)
    report["gauss_train"] = {
        "whole_state_gathers": len(calls), "refines": refines, "growths": grew,
        "refine_ms": PROFILER.totals.get("refine", 0.0) / refines * 1e3,
        "grow_ms": PROFILER.totals.get("grow_capacity", 0.0) * 1e3,
        "save_ms": PROFILER.totals.get("save_checkpoint", 0.0) * 1e3,
        "capacity": trainer.state.scene.capacity * 2,
        "run_dir": str(trainer.config.run_dir)}


def quality_phase(work_dir: Path, counters) -> dict:
    """Phase 18: the quality reference's capture, its recipe through
    ``run_quality`` with capacity growth and bands, a multi-band step
    against one band, gs-eval on the run and the LPIPS converter; the
    counters reset just before the run and read just after."""
    phase("18 quality path: the sharded capture, run_quality with growth "
          "and bands, a multi-band step vs one band, gs-eval, the LPIPS "
          "converter")
    t0 = time.perf_counter()
    capture = capture_check(work_dir)
    run, trainer = quality_run(work_dir, counters)
    bands = bands_check(trainer)
    run["gs_eval"] = quality_eval(trainer)
    converter = lpips_converter_check(work_dir)
    PROFILER.totals.clear()
    PROFILER.counts.clear()
    loaded = [m for m in ("PIL", "cv2", "yaml") if m in sys.modules]
    assert not loaded, f"phase 18 imported {loaded}"
    wall_s = time.perf_counter() - t0
    print(f"phase 18 wall time {wall_s:.1f} s")
    return {"capture": capture, "run": run, "bands_step": bands,
            "lpips_converter": converter, "launches": run.pop("launches"),
            "wall_s": wall_s}


def capture_check(work_dir: Path) -> dict:
    """18(a): the sharded capture on the card and on the CPU, byte for
    byte."""
    argv = lambda out: ["--output-dir", str(out), "--n-views", str(Q_VIEWS),
                        "--width", str(Q_SIDE), "--height", str(Q_SIDE),
                        "--seed-points", str(Q_SEEDS)]
    card, cpu = work_dir / "sharded_card", work_dir / "sharded_cpu"
    card_s = synchronized_s(lambda: gen_raytraced_sharded.main(
        argv(card) + ["--device", DEVICE]))
    t0 = time.perf_counter()
    gen_raytraced_sharded.main(argv(cpu) + ["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    files = sorted(p.relative_to(card) for p in card.rglob("*") if p.is_file())
    assert len(files) == 2 * Q_VIEWS + 2, files
    differ = [str(f) for f in files
              if (card / f).read_bytes() != (cpu / f).read_bytes()]
    n_seed = len(read_ply_points(card / "sparse.ply")[0])
    print(f"sharded capture: {Q_VIEWS} views at {Q_SIDE}x{Q_SIDE} ss 3 in "
          f"{card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU; {len(files)} "
          f"files, {len(differ)} differ {differ}; seed cloud {n_seed} points")
    assert not differ and n_seed == Q_SEEDS
    return {"views": Q_VIEWS, "side": Q_SIDE, "card_s": card_s,
            "cpu_s": cpu_s, "files": len(files), "files_differ": len(differ)}


def quality_run(work_dir: Path, counters):
    """18(b): ``run_quality`` in two stretches on 15(a)'s views with a
    460,000-point seed cloud; returns its numbers and the second
    stretch's trainer."""
    data = work_dir / "quality_data"
    shutil.copytree(work_dir / "raytraced", data)
    write_seed_cloud(data, Q_POINTS, Q_JITTER)
    runs = work_dir / "quality_runs"
    trainers = []

    def train(argv):
        trainers.append(train_main(argv))
        return 0

    for f in counters:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for iters in Q_STRETCHES:
        assert run_quality.main([
            str(data), str(runs), "gaussian-splatting", str(iters),
            "--device", DEVICE, "--initial-capacity-headroom", str(Q_HEADROOM),
            "--model.num-downscales", "0"], train=train) == 0
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launches_of(counters)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    first, second = trainers
    events = first.growth_events + second.growth_events
    grew = [e for e in events if e[1].startswith("Growing Gaussian")]
    isect = [e for e in events if e[1].startswith("Growing intersection")]
    splits = [e for e in events if "splitting into" in e[1]]
    rows = [json.loads(line) for line in
            (second.config.run_dir / "metrics.jsonl").open()]
    iter_ms = {}
    for k, (s0, s1) in enumerate(zip((0,) + Q_STRETCHES, Q_STRETCHES)):
        ms = [r["Train Iter (time)"] * 1e3 for r in rows
              if "Train Iter (time)" in r and s0 + 10 <= r["step"] < s1]
        iter_ms[f"stretch_{k + 1}"] = statistics.median(ms)
    final = [r for r in rows if "eval_psnr" in r][-1]
    losses_ = [r["loss"] for r in rows if "loss" in r]
    print(f"run_quality: {Q_STRETCHES} steps ({run_s:.1f} s, two gs-train "
          f"runs in process, the second resumed); events {events}; bands "
          f"{first.raster_cfg.bands} -> {second.raster_cfg.bands}, capacity "
          f"{second.state.scene.capacity}, intersection buffer "
          f"{second.raster_cfg.isect_capacity}; ITER_TRAIN_TIME medians "
          f"{iter_ms} ms; device peak {peak_mib:.1f} MiB; final eval PSNR "
          f"{final['eval_psnr']:.4f} (step {final['step']}); launches "
          f"{launches}")
    assert all(math.isfinite(v) for v in losses_), "loss not finite"
    start = run_quality.start_capacity(Q_POINTS, Q_HEADROOM)
    assert len(grew) == 1 and grew[0][1].endswith(f"{start} -> {2 * start}"), grew
    assert isect and splits and second.raster_cfg.bands >= 2, events
    assert second.state.scene.capacity == 2 * start
    assert int(second.state.step) == Q_STRETCHES[-1]
    assert launches["composite_tiles_bwd"] == launches["segment_sum_sorted"]
    assert launches["composite_tiles_fwd"] == launches["segment_broadcast"]
    # one launch a band a step: more launches than steps once split
    assert launches["composite_tiles_bwd"] > Q_STRETCHES[-1], launches
    reduced = {
        "views": "24 of 240 (phase 15's serial ss 3 capture at 800x800)",
        "steps": f"{Q_STRETCHES[-1]} of 15000, in stretches {Q_STRETCHES}",
        "num_downscales": "0 of 2: full resolution from step 0",
        "seed_points": f"{Q_POINTS} (the capture's: 160,000): 15(a)'s "
                       f"96,000 picked with repeats, jittered N(0, {Q_JITTER})",
        "initial_capacity_headroom": f"{Q_HEADROOM} of 1.6"}
    return {"run_s": run_s, "events": events, "launches": launches,
            "bands": second.raster_cfg.bands,
            "isect_capacity": second.raster_cfg.isect_capacity,
            "capacity": second.state.scene.capacity, "iter_ms": iter_ms,
            "peak_mib": peak_mib, "final_eval_psnr": final["eval_psnr"],
            "final_eval_ssim": final["eval_ssim"], "reduced": reduced}, second


def bands_check(trainer) -> dict:
    """18(c): one train step in the trainer's bands through the kernels
    against the same step in one band, from one state and one generator
    state, with phase 10's tolerances."""
    cfg = trainer.config
    step = int(trainer.state.step)
    sh = trainer._sh_degree(step)
    multi = trainer.raster_cfg
    one = dataclasses.replace(multi, bands=1, isect_capacity=ONE_BAND_ISECT)
    idx, frame = trainer.datamanager.next_train()
    inputs = trainer._train_inputs(idx, frame, 1)
    before = train_state_to_numpy(trainer.state)
    gen_state = trainer.generator.get_state()
    outs = []
    for rc in (multi, one):
        fn = make_train_step(cfg.model, rc, cfg.optim, H, W, sh)
        gen = torch.Generator(device=DEVICE)
        gen.set_state(gen_state)
        s, m = fn(train_state_from_numpy(before, DEVICE), *inputs[:2], gen,
                  *inputs[2:])
        torch.cuda.synchronize()
        outs.append((train_state_to_numpy(s), m))
    (got, m_b), (want, m_1) = outs
    n_b, n_1 = int(m_b["num_intersects"]), int(m_1["num_intersects"])
    print(f"step {step} in {multi.bands} bands (at most {n_b} intersections "
          f"a band of {multi.isect_capacity}) vs one band ({n_1} of "
          f"{ONE_BAND_ISECT}):", end=" ")
    assert n_b <= multi.isect_capacity and n_1 <= ONE_BAND_ISECT
    assert n_1 > n_b, "the bands do not split the intersections"
    compare_steps(m_b, m_1, before, got, want, cfg.optim, step)
    return {"bands": multi.bands, "band_intersections_max": n_b,
            "one_band_intersections": n_1, "step": step,
            "loss": float(m_b["loss"]), "loss_one_band": float(m_1["loss"])}


def quality_eval(trainer) -> dict:
    """18(d): gs-eval on the run's checkpoint against the trainer's final
    eval, bit for bit."""
    run_dir = trainer.config.run_dir
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]
    want = [r for r in rows if "eval_psnr" in r][-1]
    res = eval_cli.main(["--load-config", str(run_dir / "config.yml"),
                         "--output-path", str(run_dir / "eval.json"),
                         "--skip-lpips", "--device", DEVICE])
    got = res["results"]
    print(f"gs-eval on the quality run: PSNR {got['psnr']!r} SSIM "
          f"{got['ssim']!r} (checkpoint {res['checkpoint']}; the trainer's "
          f"final eval: {want['eval_psnr']!r} / {want['eval_ssim']!r})")
    assert res["checkpoint"] == str(Q_STRETCHES[-1])
    assert got["psnr"] == want["eval_psnr"] and got["ssim"] == want["eval_ssim"]
    return {"psnr": got["psnr"], "ssim": got["ssim"],
            "views": got["num_images"]}


def lpips_converter_check(work_dir: Path) -> dict:
    """18(e): the converter on random VGG16 (torchvision layout) and LPIPS
    head (lpips repo layout) state dicts; its self-test on the card against
    the same on the CPU."""
    rng = np.random.default_rng(SEED)
    vgg = {}
    for layer, (co, ci) in zip(VGG_LAYERS, convert_lpips_weights.VGG_CONVS):
        vgg[f"{layer}.weight"] = torch.from_numpy(
            rng.normal(0, 0.05, (co, ci, 3, 3)).astype(np.float32))
        vgg[f"{layer}.bias"] = torch.from_numpy(
            rng.normal(0, 0.05, co).astype(np.float32))
    lin = {f"lin{j}.model.1.weight": torch.from_numpy(
        rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32))
        for j, c in enumerate(convert_lpips_weights.HEAD_WIDTHS)}
    torch.save(vgg, work_dir / "vgg16.pth")
    torch.save(lin, work_dir / "lpips_lin.pth")
    argv = ["--vgg", str(work_dir / "vgg16.pth"), "--lpips",
            str(work_dir / "lpips_lin.pth"), "--out",
            str(work_dir / "lpips_vgg16.npz")]
    t0 = time.perf_counter()
    card = convert_lpips_weights.main(argv + ["--device", DEVICE])
    card_s = time.perf_counter() - t0
    cpu = convert_lpips_weights.main(argv + ["--device", "cpu"])
    print(f"convert_lpips_weights: self-test {card!r} on the card "
          f"({card_s:.2f} s), {cpu!r} on the CPU")
    assert math.isfinite(card) and math.isclose(card, cpu, rel_tol=1e-4)
    return {"self_test_card": card, "self_test_cpu": cpu, "card_s": card_s}


def configs_phase(work_dir: Path, counters) -> dict:
    """Phase 19: the reference's other published configurations at a small
    size: the 1-spp capture on the card against the CPU and its mono
    variant, an antialiased step through the kernels against the plain
    step, and short runs of co-gs, mono co-gs, the antialiased mode and
    the surface-gs refinement with exact and rounded cameras; the counters
    reset just before each run and read just after."""
    phase("19 configurations: the 1-spp capture and its mono variant, the "
          "antialiased step vs plain, co-gs / mono co-gs / antialiased / "
          "the surface-gs refinement through quality_workflow and the probe")
    t0 = time.perf_counter()
    launches = {}
    capture = capture_1spp_check(work_dir)
    aa_step = aa_step_check(counters)
    launches["240_aa_step"] = aa_step.pop("launches")
    runs = {}
    for name, (flags, extra) in CONFIGS.items():
        runs[name] = config_runs(work_dir / f"cfg_{name}", name, flags,
                                 extra, counters)
        launches.update(runs[name].pop("launches"))
    runs["240_surfacegs"] = config_runs(
        work_dir / "cfg_240_surfacegs", "240_surfacegs", REFINE_FLAGS, [],
        counters, iters=R_ITERS, stretch=R_STRETCH)
    launches.update(runs["240_surfacegs"].pop("launches"))
    PROFILER.totals.clear()
    PROFILER.counts.clear()
    loaded = [m for m in ("PIL", "cv2", "yaml") if m in sys.modules]
    assert not loaded, f"phase 19 imported {loaded}"
    wall_s = time.perf_counter() - t0
    print(f"phase 19 wall time {wall_s:.1f} s")
    return {"capture": capture, "aa_step": aa_step, "runs": runs,
            "launches": launches, "wall_s": wall_s}


def capture_1spp_check(work_dir: Path) -> dict:
    """19(a): ``quality_workflow``'s 1-spp capture (the serial generator)
    on the card and on the CPU, every file equal byte for byte; its mono
    variant made from the card's."""
    size = (Q_SIDE, Q_SIDE)
    card, cpu = work_dir / "c1spp_card", work_dir / "c1spp_cpu"
    card_s = synchronized_s(lambda: quality_workflow.prepare_data(
        card, "1spp", True, Q_VIEWS, size, Q_SEEDS, DEVICE))
    t0 = time.perf_counter()
    quality_workflow.prepare_data(cpu, "1spp", False, Q_VIEWS, size, Q_SEEDS,
                                  "cpu")
    cpu_s = time.perf_counter() - t0
    name = quality_workflow.data_name("1spp", False)
    files = sorted(p.relative_to(card / name)
                   for p in (card / name).rglob("*") if p.is_file())
    assert len(files) == 2 * Q_VIEWS + 2, files
    differ = [str(f) for f in files if (card / name / f).read_bytes()
              != (cpu / name / f).read_bytes()]
    mono = card / quality_workflow.data_name("1spp", True)
    meta = json.loads((mono / "transforms.json").read_text())
    scales = [f["scale"] for f in meta["frames"]]
    print(f"1-spp capture: {Q_VIEWS} views at {Q_SIDE}x{Q_SIDE} with its "
          f"mono variant in {card_s:.2f} s on the card, the capture alone "
          f"{cpu_s:.2f} s on the CPU; {len(files)} files, {len(differ)} "
          f"differ {differ}; mono scales {[round(x, 4) for x in scales]}")
    assert not differ and len(scales) == Q_VIEWS
    assert all(math.isfinite(x) and x > 0 for x in scales)
    return {"views": Q_VIEWS, "side": Q_SIDE, "card_s": card_s,
            "cpu_s": cpu_s, "files": len(files), "files_differ": len(differ)}


def aa_step_check(counters) -> dict:
    """19(b): one antialiased train step through K1-K4 against the same
    step with ``backend="plain"`` (phase 10's tolerances), on bench.py's
    scene with log-scales in ``AA_SCALES``: the compensation the opacities
    are multiplied by reaches far below 1."""
    dev = torch.device(DEVICE)
    cfg = VanillaConfig(sh_degree=SH_DEGREE, background_color="black",
                        rasterize_mode="antialiased")
    camera = Camera.create(FOCAL, FOCAL, W / 2, H / 2, pose(0), device=dev)
    gt = torch.rand((H, W, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    scene = bench_scene(dev, AA_SCALES)
    with torch.no_grad():
        aa = splat_inputs(scene, camera, H, W, sh_degree=SH_DEGREE, config=cfg)
        classic = splat_inputs(scene, camera, H, W, sh_degree=SH_DEGREE,
                               config=dataclasses.replace(
                                   cfg, rasterize_mode="classic"))
    seen = (aa["radii"] > 0) & (classic["opacities"] > 0)
    comp = (aa["opacities"][seen] / classic["opacities"][seen]).double()
    quantiles = [float(q) for q in torch.quantile(
        comp, torch.tensor([0.0, 0.1, 0.5, 0.9, 1.0], dtype=comp.dtype,
                           device=comp.device))]
    below = float((comp < 0.5).double().mean())
    print(f"antialiased scene: {int(seen.sum())} lanes on screen, "
          f"compensation quantiles 0/0.1/0.5/0.9/1 {[round(q, 4) for q in quantiles]}"
          f", {below:.3f} of them below 0.5")
    assert quantiles[0] < 0.05 and below > 0.1 and quantiles[-1] > 0.9
    step_fn = make_train_step(cfg, RasterizeConfig(isect_capacity=TRAIN_ISECT),
                              OptimizerConfig(), H, W, sh_degree=SH_DEGREE)
    plain_fn = make_train_step(
        cfg, RasterizeConfig(isect_capacity=TRAIN_ISECT, backend="plain"),
        OptimizerConfig(), H, W, sh_degree=SH_DEGREE)
    state, state_p = init_train_state(scene), init_train_state(bench_scene(dev, AA_SCALES))
    before = train_state_to_numpy(state)
    torch.cuda.synchronize()
    for f in counters:
        f.launches = 0
    state, metrics = step_fn(state, camera, gt)
    torch.cuda.synchronize()
    launches = launches_of(counters)
    state_p, metrics_p = plain_fn(state_p, camera, gt)
    torch.cuda.synchronize()
    print(f"antialiased step: launches {launches}; {int(metrics['num_intersects'])} "
          f"intersections;", end=" ")
    assert all(n == 1 for n in launches.values()), launches
    compare_steps(metrics, metrics_p, before, train_state_to_numpy(state),
                  train_state_to_numpy(state_p), OptimizerConfig())
    return {"compensation_quantiles": quantiles, "share_below_half": below,
            "num_intersects": int(metrics["num_intersects"]),
            "loss": float(metrics["loss"]), "loss_plain": float(metrics_p["loss"]),
            "launches": launches}


def config_runs(work_dir: Path, name: str, flags: list, extra: list,
                counters, capture: str = "1spp", iters: int = C_ITERS,
                stretch: int = C_FIRST) -> dict:
    """19(c): configuration ``name`` on the ``capture`` at 18(a)'s size:
    ``quality_workflow`` (exact cameras; gs-train and gs-eval in child
    processes, stretches of ``stretch`` steps to ``iters``; its counted
    steps here), then the probe with ``fullmat`` rounded (gs-train in
    process, ``iters`` steps); after the probe the exact camera and SH
    functions are back in place."""
    common = ["--capture", capture, "--work-dir", str(work_dir), "--n-views",
              str(Q_VIEWS), "--seed-points", str(Q_SEEDS), "--iters",
              str(iters), "--stretch", str(stretch), "--device", DEVICE,
              *flags]
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    rep = quality_workflow.main([
        *common, "--out-dir", str(work_dir / "report"), "--width",
        str(Q_SIDE), "--height", str(Q_SIDE), "--", *extra])
    exact_s = time.perf_counter() - t0
    counted = rep["counted"]
    step = {k: v // counted["steps"] for k, v in counted["launches"].items()}
    evals = rep["evals"]
    assert rep["config"] == name, rep["config"]
    assert evals[iters]["bit_for_bit"], evals
    if "refinement" in rep:
        assert all(e["bit_for_bit"] for e in evals.values()), evals
    assert all(math.isfinite(e["psnr"]) for e in evals.values()), evals
    assert all(n == counted["bands"] for n in step.values()), counted
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    probe = tpu_precision_probe.main([
        *common, "--rounded", "fullmat", "--out-dir",
        str(work_dir / "probe"), "--size", str(Q_SIDE), "--", *extra])
    probe_s = time.perf_counter() - t0
    probe_launches = launches_of(counters)
    restored = (vanilla_mod.camera_matrices is cameras_mod.camera_matrices
                and vanilla_mod.spherical_harmonics is sh_mod.spherical_harmonics)
    final = probe["trainer_evals"][-1]
    print(f"{name}: quality_workflow {iters} steps in {exact_s:.1f} s, "
          f"gs-eval {[e['psnr'] for e in evals.values()]} (the last = the "
          f"trainer's), "
          f"launches a step {step}; probe (fullmat rounded) {probe_s:.1f} s, "
          f"screen shift {probe['screen_shift']}, trainer's eval {final[1]!r}"
          f" = gs-eval rounded {probe['eval_rounded']['psnr']!r} (exact "
          f"{probe['eval_exact']['psnr']!r}), launches {probe_launches}; "
          f"exact functions back: {restored}")
    assert restored, "the probe left its rounding in place"
    assert probe["config"] == name and final[0] == iters
    assert final[1] == probe["eval_rounded"]["psnr"]
    assert probe["screen_shift"]["max_px"] > 0
    assert probe_launches["composite_tiles_bwd"] >= iters, probe_launches
    assert probe_launches["composite_tiles_bwd"] == probe_launches["segment_sum_sorted"]
    refinement = {k: r["refinement"] for k, r in (("exact", rep),
                                                  ("rounded", probe))
                  if "refinement" in r}
    if refinement:
        print(f"{name}: refinement {refinement}")
    assert all(r["frozen"] for r in refinement.values()), refinement
    return {"exact_s": exact_s, "probe_s": probe_s, **(
                {"refinement": refinement} if refinement else {}),
            "exact_psnr": [e["psnr"] for e in evals.values()],
            "rounded_psnr": probe["eval_rounded"]["psnr"],
            "rounded_scored_exact_psnr": probe["eval_exact"]["psnr"],
            "screen_shift": probe["screen_shift"],
            "stretches": [st["iters"] for st in rep["stretches"]],
            "stretch_flags": [st["flags"] for st in rep["stretches"]],
            "launches": {f"{name}_step": step,
                         f"{name}_probe_{iters}_steps": probe_launches}}


def largest_phase(work_dir: Path, counters) -> dict:
    """Phase 20: the reference's largest operating points: the 4K banded
    frame at full size against the plain twins, a continuation with a
    larger capacity and a reopened split window, and the two 30k
    configurations at a small size; the counters reset just before each
    run and read just after."""
    phase("20 largest points: the 4K banded frame vs the plain twins, a "
          "continuation that grows and reopens the split window, the 30k "
          "configurations through quality_workflow and the probe")
    t0 = time.perf_counter()
    frame = frame_4k_check(counters)
    launches = {"4k_frame": frame.pop("launches")}
    cont = continuation_check(work_dir / "continuation", counters)
    launches["continuation"] = cont.pop("launches")
    runs = {}
    for name, (capture, flags, extra) in CONFIGS_30K.items():
        runs[name] = config_runs(work_dir / f"cfg_{name}", name, flags, extra,
                                 counters, capture, C30_ITERS, C30_STRETCH)
        launches.update(runs[name].pop("launches"))
    assert runs["240_ss3_30k"]["stretch_flags"][2][-4:] == \
        quality_workflow.SS3_CONTINUATION, runs["240_ss3_30k"]
    PROFILER.totals.clear()
    PROFILER.counts.clear()
    loaded = [m for m in ("PIL", "cv2", "yaml") if m in sys.modules]
    assert not loaded, f"phase 20 imported {loaded}"
    wall_s = time.perf_counter() - t0
    print(f"phase 20 wall time {wall_s:.1f} s")
    return {"frame_4k": frame, "continuation": cont, "runs": runs,
            "launches": launches, "wall_s": wall_s}


def frame_4k_check(counters) -> dict:
    """20(a): ``bench_render_4k``'s frame through K1 and K3, a band at a
    time, against the same frame through the plain twins; each band's
    count against the CPU's count of the CPU's projection."""
    dev = torch.device(DEVICE)
    cam, arrays = bench_render_4k.scene_arrays()
    proj = bench_render_4k.project(cam, arrays, dev)
    torch.cuda.synchronize()
    for f in counters:
        f.launches = 0
    img, alpha, info = bench_render_4k.frame(proj, arrays, cam)
    torch.cuda.synchronize()
    launches = launches_of(counters)
    bands = [int(x) for x in info["band_intersects"].cpu()]
    plain = dataclasses.replace(bench_render_4k.CONFIG, backend="plain")
    t0 = time.perf_counter()
    img_p, alpha_p, info_p = bench_render_4k.frame(proj, arrays, cam, plain)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    outside = [assert_close(f"4K frame {k} vs the plain twins", a, b,
                            **PARITY, max_outside=0.001)
               for k, a, b in (("rgb+depth", img, img_p),
                               ("alpha", alpha, alpha_p))]
    cpu = bench_render_4k.band_intersections(
        bench_render_4k.project(cam, arrays, "cpu"), arrays, cam)
    ms = event_samples(lambda: bench_render_4k.frame(proj, arrays, cam),
                       R4K_ITERS)
    total = int(proj.num_tiles_hit.long().sum())
    print(f"4K frame: {len(bands)} bands of {bands} intersections (CPU "
          f"{cpu}; plain {[int(x) for x in info_p['band_intersects'].cpu()]})"
          f", total {total} (3-sigma squares), launches {launches}; "
          f"outside tolerance {outside} of {img.numel()} / {alpha.numel()}; "
          f"device ms {[round(x, 3) for x in ms]}; the plain frame "
          f"{plain_s:.2f} s")
    assert len(bands) == 13 and bands == cpu, (bands, cpu)
    assert max(bands) <= bench_render_4k.ISECT_CAPACITY
    assert launches["composite_tiles_fwd"] == launches["segment_broadcast"] == 13
    assert launches["composite_tiles_bwd"] == launches["segment_sum_sorted"] == 0
    assert bool(torch.isfinite(img).all())
    return {"bands": bands, "total_intersections": total,
            "outside": outside, "ms": ms, "ms_median": statistics.median(ms),
            "plain_s": plain_s, "launches": launches}


def continuation_check(work_dir: Path, counters) -> dict:
    """20(b): gs-train on the 1-spp capture at 160x160 with 7,500 seeds in
    8192 lanes, ``--max-capacity`` 8192 (saturated) and the split window
    closed at the last step, then resumed with four times the capacity
    and the split window reopened (densifying at every refine): the
    capacity grows on the resume's first metrics window, children are
    placed, the resumed ``config.yml`` holds the new flags and gs-eval of
    its checkpoint equals the trainer's eval bit for bit."""
    data, _ = quality_workflow.prepare_data(
        work_dir, "1spp", False, Q_VIEWS, (Q_SIDE, Q_SIDE), Q_SEEDS, DEVICE)
    write_seed_cloud(data, CONT_SEEDS)
    base = [
        "--device", DEVICE, "gaussian-splatting", "--data", str(data),
        "--output-dir", str(work_dir / "runs"), "--experiment-name", "cont",
        "--steps-per-eval-image", "0", "--steps-per-eval-all-images", "0",
        "--initial-capacity-headroom", "1.0", "--model.num-downscales", "0",
        "--model.warmup-length", "5", "--model.refine-every", "5",
        "--model.densify-grad-thresh", "0", "--isect-capacity", "1048576",
        "--dataparser.eval-mode", "interval", "--dataparser.eval-interval", "3"]
    first = train_main([*base, "--max-num-iterations", str(CONT_STEPS[0]),
                        "--max-capacity", str(CONT_CAPACITY),
                        "--model.stop-split-at", str(CONT_STEPS[0])])
    alive_first = int(first.state.scene.alive.sum())
    reopened = ["--max-capacity", str(4 * CONT_CAPACITY),
                "--model.stop-split-at", "1000"]
    for f in counters:
        f.launches = 0
    second = train_main([*base, "--max-num-iterations", str(CONT_STEPS[1]),
                         "--load-dir", str(first.run_dir / "ckpts"),
                         *reopened])
    torch.cuda.synchronize()
    launches = launches_of(counters)
    cfg = load_config(second.run_dir / "config.yml")
    rows = [json.loads(line) for line in
            (second.run_dir / "metrics.jsonl").open()]
    final = [r for r in rows if "eval_psnr" in r][-1]
    res = eval_cli.main(["--load-config", str(second.run_dir / "config.yml"),
                         "--output-path", str(work_dir / "eval.json"),
                         "--skip-lpips", "--device", DEVICE])["results"]
    grew = [e for e in second.growth_events if "Gaussian capacity" in e[1]]
    alive = int(second.state.scene.alive.sum())
    print(f"continuation: {alive_first} alive in {first.state.scene.capacity}"
          f" lanes at step {CONT_STEPS[0]} (events {first.growth_events}); "
          f"resumed with {reopened}: events {second.growth_events}, "
          f"{alive} alive in {second.state.scene.capacity} lanes at step "
          f"{CONT_STEPS[1]}; config.yml max_capacity {cfg.max_capacity}, "
          f"stop_split_at {cfg.model.stop_split_at}; gs-eval "
          f"{res['psnr']!r} / {res['ssim']!r}, the trainer's "
          f"{final['eval_psnr']!r} / {final['eval_ssim']!r}; launches "
          f"{launches}")
    assert first.state.scene.capacity == CONT_CAPACITY
    assert alive_first > 0.85 * CONT_CAPACITY
    assert grew and grew[0][0] == CONT_STEPS[0], second.growth_events
    assert grew[0][1].endswith(f"{CONT_CAPACITY} -> {2 * CONT_CAPACITY}")
    assert alive > alive_first, "the reopened window placed no children"
    assert (cfg.max_capacity, cfg.model.stop_split_at) == (4 * CONT_CAPACITY,
                                                           1000)
    assert (res["psnr"], res["ssim"]) == (final["eval_psnr"],
                                          final["eval_ssim"])
    steps = CONT_STEPS[1] - CONT_STEPS[0]
    assert launches["composite_tiles_bwd"] == launches["segment_sum_sorted"] == steps
    return {"alive": [alive_first, alive], "events": second.growth_events,
            "capacity": second.state.scene.capacity,
            "psnr": res["psnr"], "launches": launches}


def tools_phase(work_dir: Path, counters) -> dict:
    """Phase 21: the reference's last tools through the port's entry
    points, each at a reduced size and checked, the round-2 64-view run
    rehearsed with its downstream stage and co-gs smoke, and the preflight
    gate's refusal; the counters reset just before each in-process run and
    read just after. The timed tools run in one fresh process
    (:func:`tools_main`): late in this long process torch.profiler loses
    device events (4266 of 4314 in one trace, then none in three
    sessions), which a fresh process does not."""
    phase("21 the last tools: profile_step, bench_kernels, bench_render, "
          "bench_refine, the sort / scatter / gather benchmarks, the 64-view "
          "run with its toolchain and co-gs smoke, the preflight gate")
    t0 = time.perf_counter()
    timed = tools_run(work_dir / "tools")
    out = {"profile_step": profile_check(work_dir / "tools" / "traces")}
    launches = {"profile_step_per_step": out["profile_step"].pop("launches")}
    out["bench_kernels"] = bench_kernels_check(timed["bench_kernels"])
    launches["bench_kernels"] = out["bench_kernels"].pop("launches")
    out["bench_render"] = bench_render_check(timed["bench_render"])
    launches["bench_render_frame"] = out["bench_render"].pop("launches")
    out["bench_refine"] = bench_refine_check(timed["bench_refine"])
    out["microbenchmarks"] = microbench_check(timed)
    out["render_4k_main"] = render_4k_main_check(timed["render_4k"])
    out["run_15k"] = run_15k_check(work_dir / "run_15k", counters)
    launches.update(out["run_15k"].pop("launches"))
    out["preflight_refusal"] = refusal_check(work_dir / "preflight")
    PROFILER.totals.clear()
    PROFILER.counts.clear()
    loaded = [m for m in ("PIL", "cv2", "yaml") if m in sys.modules]
    assert not loaded, f"phase 21 imported {loaded}"
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = launches
    print(f"phase 21 wall time {out['wall_s']:.1f} s")
    return out


def tools_main(work_dir: Path, device: str) -> int:
    """``chip_smoke.py --tools <dir> <device>``: phase 21's timed tools,
    each through its entry point's ``main`` at a reduced size, in this
    fresh process; their results go to ``<dir>/results.json`` and
    profile_step's trace to ``<dir>/traces``."""
    dev = ["--device", device]
    it, rows = ["--iters", "3"], str(TOOL_ROWS)
    profile_step.main(["--steps", str(PROFILE_STEPS), "--top", "12",
                       "--trace-dir", str(work_dir / "traces"), *dev])
    res = {
        "bench_kernels": bench_kernels.main([*it, *dev]),
        "bench_render": bench_render.main(["--iters", "5", *dev]),
        "bench_refine": bench_refine.main(["--caps", str(TOOL_REFINE_CAP),
                                           *it, *dev]),
        "sort": bench_sort.main(["--logn", *map(str, TOOL_SORT_LOGN), *it,
                                 *dev]),
        "scatter": bench_scatter.main(["--n", rows, "--cap", rows, *it, *dev]),
        "gather_geometry": bench_gather.main(["geometry", "--n-out", rows,
                                              *it, *dev]),
        "gather_locality": bench_gather.main(["locality", "--n-out", rows,
                                              *it, *dev]),
        "gather_port": bench_gather.main(["port", "--n-out", rows, *it, *dev]),
        "render_4k": bench_render_4k.main([
            "--gaussians", str(TOOL_4K_GAUSSIANS), "--width", "1920",
            "--height", "1080", "--iters", "3", "--warmup", "1", *dev]),
    }
    (work_dir / "results.json").write_text(json.dumps(res))
    return 0


def tools_run(work_dir: Path) -> dict:
    """:func:`tools_main` in a fresh process; its output's tail printed,
    its results returned."""
    work_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--tools", str(work_dir),
         DEVICE], cwd=REPO, capture_output=True, text=True, timeout=900,
        env=dict(run_quality.child_env()))
    lines = [l for l in proc.stdout.splitlines() if not l.startswith("{")]
    print("\n".join(l[:300] for l in lines[-60:]))
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    print(f"the timed tools in one process: {time.perf_counter() - t0:.1f} s")
    return json.loads((work_dir / "results.json").read_text())


def profile_check(traces: Path) -> dict:
    """21(a): ``profile_step`` at bench.py's point (``PROFILE_STEPS``
    traced steps): the table holds K1-K4, each launch made is recorded,
    the device's busy time is within the traced window, and
    ``--parse-only`` (here) reads the report back."""
    rep = profile_step.main(["--parse-only", "--top", "100000",
                             "--trace-dir", str(traces)])
    names = [row[2] for row in rep["table"]["rows"]]
    for name, k in rep["kernels"].items():
        sym = profile_step.KERNEL_NAMES[name]
        assert any(sym in n for n in names), f"{name} not in the table"
        assert k["made"] == k["recorded"] == PROFILE_STEPS, (name, k)
    assert 0 < rep["device_busy_ms"] <= rep["window_ms"], rep
    assert 0 <= rep["step_idle_share"] < 1, rep["step_idle_share"]
    assert rep["device_events_matched"] <= rep["device_events"]
    return {"step_ms": rep["step_ms"], "busy_ms_per_step":
            rep["device_busy_ms"] / PROFILE_STEPS,
            "idle_share": rep.get("idle_share"),
            "step_idle_share": rep.get("step_idle_share"),
            "device_events_per_step": rep["device_events"] / PROFILE_STEPS,
            "launch_calls": rep["launch_calls"],
            "num_intersects": rep["num_intersects"],
            "launches": {k: v["made"] // PROFILE_STEPS
                         for k, v in rep["kernels"].items()}}


def bench_kernels_check(rep: dict) -> dict:
    """21(b): ``bench_kernels``' inputs at its full point through K1 and K2
    against their plain twins at phases 5 and 9's tolerances (here, the
    counters read), and the tool's own run (``rep``), timed."""
    inputs = bench_kernels.kernel_inputs(
        bench_point.kernels_scene(), bench_point.K_RES, bench_point.K_ISECT,
        DEVICE)
    got = {}
    launches = launches_during(
        lambda: got.update(bench_kernels.run_kernels(inputs)))
    for r in (got, rep):
        assert r["k1_outside"] == 0, r["k1_outside"]
        assert r["k2_outside"] <= bench_kernels.K2_MAX_OUTSIDE * r["k2_values"]
    assert launches["composite_tiles_fwd"] == launches["composite_tiles_bwd"] == 1
    print(f"bench_kernels' inputs here: K1 max abs err {got['k1_max_abs_err']:.3g}"
          f", K2 {got['k2_max_abs_err']:.3g} ({got['k2_outside']} outside), "
          f"launches {launches}")
    return {k: rep[k] for k in ("num_intersects", "pairs", "kept_pairs",
                                "k1_max_abs_err", "k2_max_abs_err",
                                "k2_outside")} | {
        "k1_ms": rep.get("composite_tiles_fwd", {}).get("ms"),
        "k2_ms": rep.get("composite_tiles_bwd", {}).get("ms"),
        "launches": launches}


def bench_render_check(rep: dict) -> dict:
    """21(c): ``bench_render``'s forward-only frame at bench.py's point
    against the same frame through the plain twins (here), and the tool's
    own run (``rep``), timed."""
    point = bench_point.bench_point(device=DEVICE)
    out = {}
    launches = launches_during(
        lambda: out.update(bench_render.render_fn(point)()))
    torch.cuda.synchronize()
    plain = bench_render.render_fn(point, dataclasses.replace(
        point.raster, forward_only=True, backend="plain"))()
    outside = {k: assert_close(f"bench_render {k} vs the plain twins",
                               out[k], plain[k], **PARITY, max_outside=0.001)
               for k in ("rgb", "depth", "alpha")}
    assert launches["composite_tiles_fwd"] == launches["segment_broadcast"] == 1
    assert rep["launches_per_frame"] == launches, rep
    print(f"bench_render's frame vs the plain twins: outside {outside}")
    return {"outside": outside,
            "frame_ms": rep.get("frame", {}).get("median_ms"),
            "host_numpy_ms": rep.get("host_numpy", {}).get("median_ms"),
            "launches": launches}


def bench_refine_check(rep: dict) -> dict:
    """21(d): ``bench_refine``'s inputs at ``TOOL_REFINE_CAP`` lanes refined
    on the card and on the CPU: equal alive masks and ``info``, parameters
    within rtol 1e-6 (means within 1e-6 of the largest ``|mean|``), as
    phase 11 holds refine; and the tool's own run (``rep``), timed."""
    got = bench_refine.run_refine(bench_refine.refine_inputs(TOOL_REFINE_CAP,
                                                             DEVICE))
    want = bench_refine.run_refine(bench_refine.refine_inputs(TOOL_REFINE_CAP,
                                                              "cpu"))
    info = lambda r: {k: int(v) for k, v in r[3].items()}
    assert info(got) == info(want), (info(got), info(want))
    assert torch.equal(got[0].alive.cpu(), want[0].alive)
    means_atol = 1e-6 * float(want[0].means.abs().max())
    for name, p in want[0].params().items():
        q = got[0].params()[name].detach().cpu()
        atol = means_atol if name == "means" else 1e-7
        assert torch.allclose(q, p.detach(), rtol=1e-6, atol=atol), name
    print(f"bench_refine at {TOOL_REFINE_CAP} lanes: card = CPU, info "
          f"{info(want)}")
    assert rep["caps"][str(TOOL_REFINE_CAP)]["info"] == info(want)
    return {"info": info(want), **rep["caps"][str(TOOL_REFINE_CAP)]}


def microbench_check(reps: dict) -> dict:
    """21(e): ``bench_sort``, ``bench_scatter`` and ``bench_gather`` at a
    reduced size, ``bench_gather port`` at bench.py's point (their runs in
    ``reps``); each case equals numpy (the tools assert it)."""
    cases = {"sort": sum(len(v) for v in reps["sort"]["cases"].values()),
             "scatter": len(reps["scatter"]["cases"]),
             "gather_geometry": len(reps["gather_geometry"]["cases"]),
             "gather_locality": 2 * len(reps["gather_locality"]["cases"]),
             "gather_port": len(reps["gather_port"]["cases"])}
    # locality: uniform and the windows up to the table's rows, rows and
    # columns each
    assert cases == {"sort": 7 * len(TOOL_SORT_LOGN), "scatter": 16,
                     "gather_geometry": 12, "gather_locality": 6,
                     "gather_port": 6}, cases
    assert all(e["equal"] for r in (reps["sort"], reps["scatter"],
                                     reps["gather_port"])
               for c in r["cases"].values()
               for e in (c.values() if "equal" not in c else [c]))
    port = reps["gather_port"]["cases"]
    assert port["port positions int32"]["rows"] == bench_point.BENCH_DEFAULTS[
        "BENCH_ISECT"], port
    print(f"microbenchmarks: every case equal to numpy {cases}")
    return cases


def render_4k_main_check(rep: dict) -> dict:
    """21(e'): ``bench_render_4k``'s own ``main`` on the card at
    ``TOOL_4K_GAUSSIANS`` Gaussians and 1920x1080 (its run in ``rep``):
    finite, no band truncated, K1 and K3 once a band in the frame and in
    the Renderer's, whose bands hold the same intersections, and timed."""
    bands = rep["bands"]
    want = {"composite_tiles_fwd": bands, "composite_tiles_bwd": 0,
            "segment_broadcast": bands, "segment_sum_sorted": 0}
    assert rep["finite"] and not rep["truncated"], rep
    assert rep["launches_per_frame"] == rep["renderer_launches_per_frame"] \
        == want, rep
    assert rep["renderer_band_intersections"] == rep["band_intersections"]
    assert all(rep[k]["samples"] == 3 for k in ("frame", "renderer_frame",
                                                 "renderer_numpy")), rep
    print(f"bench_render_4k main at {rep['width']}x{rep['height']}: {bands} "
          f"bands, frame {rep['frame']['median_ms']:.3f} ms")
    return {"bands": bands, "frame_ms": rep["frame"]["median_ms"],
            "renderer_numpy_ms": rep["renderer_numpy"]["median_ms"]}


def run_15k_check(work_dir: Path, counters) -> dict:
    """21(f): the round-2 64-view run (``tools/run_15k.sh``) at 18(a)'s
    side: 64 views, ``quality_workflow`` with two stretches of 300 steps
    standing for the recipe's 7500 each and the downstream stage, then the
    co-gs smoke for 20 steps; gs-eval equal to the trainer's eval bit for
    bit, K1-K4 once a step in each counted step, and a non-empty TSDF mesh
    (after 40 steps the mesh was empty: the rendered depth's median was
    about 10x the capture's; after 600, past the recipe's first refine at
    step 500, it is within 5% of it and the mesh has some 300k
    vertices)."""
    common = ["--capture", "1spp", "--n-views", str(R15_VIEWS), "--width",
              str(Q_SIDE), "--height", str(Q_SIDE), "--seed-points",
              str(Q_SEEDS), "--work-dir", str(work_dir), "--published",
              str(R15_PUBLISHED), "--device", DEVICE]
    t0 = time.perf_counter()
    rep = quality_workflow.main([
        *common, "--out-dir", str(work_dir / "report"), "--iters",
        str(R15_ITERS), "--stretch", str(R15_STRETCH), "--downstream"])
    exact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cogs = quality_workflow.main([
        *common, "--out-dir", str(work_dir / "report_cogs"), "--method",
        "co-gs", "--iters", str(R15_COGS_ITERS), "--",
        "--model.use-depth-loss", "True"])
    cogs_s = time.perf_counter() - t0
    down = rep["downstream"]
    step = {k: v // rep["counted"]["steps"]
            for k, v in rep["counted"]["launches"].items()}
    cogs_step = {k: v // cogs["counted"]["steps"]
                 for k, v in cogs["counted"]["launches"].items()}
    print(f"64-view run at {Q_SIDE}x{Q_SIDE}: {exact_s:.1f} s, gs-eval "
          f"{[e['psnr'] for e in rep['evals'].values()]} (bit for bit "
          f"{[e['bit_for_bit'] for e in rep['evals'].values()]}), downstream "
          f"{down}, launches a step {step}; co-gs smoke {cogs_s:.1f} s, "
          f"gs-eval {cogs['evals'][R15_COGS_ITERS]['psnr']!r}, launches a "
          f"step {cogs_step}")
    assert rep["config"] == "64" and cogs["config"] == "64_cogs"
    assert all(e["bit_for_bit"] for e in rep["evals"].values()), rep["evals"]
    assert cogs["evals"][R15_COGS_ITERS]["bit_for_bit"]
    assert down["gaussian_splat"]["gaussians"] == down["checkpoint_alive"]
    assert down["render_pose"]["views"] == R15_VIEWS - R15_VIEWS // 8
    assert down["tsdf_tetra"]["vertices"] > 0 and down["tsdf_tetra"]["faces"] > 0
    assert len(rep["train_curve"]) == 16
    for s in (step, cogs_step):
        assert all(n == rep["counted"]["bands"] for n in s.values()), s
    return {"exact_s": exact_s, "cogs_s": cogs_s,
            "psnr": [e["psnr"] for e in rep["evals"].values()],
            "cogs_psnr": cogs["evals"][R15_COGS_ITERS]["psnr"],
            "downstream": down,
            "launches": {"64_step": step, "64_cogs_step": cogs_step}}


def refusal_check(work_dir: Path) -> dict:
    """21(g): the preflight gate on the card: against a copy of the kernel
    files with no stamp, ``quality_workflow`` on CUDA exits 3 before any
    work, ``GSTK_SKIP_PREFLIGHT`` unset. (This script stamps the real tree
    when every phase has passed.)"""
    for rel in preflight.kernel_files():
        (work_dir / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / rel, work_dir / rel)
    repo, skip = preflight.REPO, os.environ.pop(preflight.SKIP_ENV, None)
    preflight.REPO = work_dir
    try:
        with contextlib.redirect_stderr(sys.stdout):
            quality_workflow.main(["--capture", "1spp", "--n-views", "64",
                                   "--work-dir", str(work_dir / "never"),
                                   "--out-dir", str(work_dir / "never")])
        raise AssertionError("quality_workflow trained on a missing stamp")
    except SystemExit as e:
        code = e.code
    finally:
        preflight.REPO = repo
        if skip is not None:
            os.environ[preflight.SKIP_ENV] = skip
    assert code == 3 and not (work_dir / "never").exists(), code
    print(f"preflight: quality_workflow on CUDA without a stamp exited {code}")
    return {"exit_code": code}


def trace(label, fn, top: int = 8, show: tuple = ()) -> dict:
    """One call of ``fn`` under torch.profiler (a separate, traced run): wall
    time, device busy time (the sum over device-side events, kernels and
    copies; one stream, so they do not overlap), the device's idle share,
    the device events that take most time and those whose name holds one
    of ``show``; printed, and returned with the ``top`` events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # CPU ops also report the device time of what they launched: count
    # only the device-side events, or every kernel is counted twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_events = sum(e.count for e in events)
    print(f"traced {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"device idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{n_events} device events")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < top or any(s in e.key for s in show):
            print(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:4d}x  {e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "device_events": n_events,
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                    for e in ranked[:top]]}


if __name__ == "__main__":
    sys.exit(main())
