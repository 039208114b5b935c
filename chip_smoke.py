#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card, the CUDA toolkit
(``nvcc``), ``ninja`` and no network. In order it:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the port's CUDA kernels from ``uforecon_tpu_torch/csrc``;
  3. kernel phase: each of the nine kernels against its plain PyTorch
     version on the card at main-path shapes (the ray head and its NeuS
     variant at both token widths, 88 and 72, on random weights of each
     width; the split-weight point head at 65,536 and the ragged 65,537
     points, timed beside the point head on the same inputs; the row
     gather at 2048 blocks of 4096 rows, bit for bit, timed beside
     ``torch.index_select``), with max abs errors,
     CUDA-event times (median of several runs) of kernel and plain version,
     and the bound (the least time the card could take for the work; for
     the point heads and the ray head, whose layer GEMMs run on the tensor
     cores in 3xTF32, the tensor bound beside the FP32 bound), with each kernel's
     share of its bounds; the tiny attention at route A's head width 10
     and route B's 8, at 65,536 and the ragged 65,537 points, and at the
     training configurations' L = S = 5 with heads of 9 and 13; its
     backward at route A's L = S = 4 (65,536 and 65,537 points), at the
     training shape L = S = 6 and at L = S = 5 with heads of 10, 9 and 13; the volume fusion at 2, 3, 5 and 11 views and the
     ragged 65,537 points, timed with its inputs in the L2 (as the main
     path finds them) and, at 3 views, after a 64 MB write (cold L2); the
     grouped cosine at 3 views, at the 5-view similarity field's
     (5, 65,536, 128) and at 11 views' 55 pairs (11, 65,536, 320); then the
     heads' fast variants (kernel_precision 'fast': kernels 1, 2 and 3 at
     widths 88 and 72, 4; fast kernels 2 and 3 at every width by
     ``csrc/ray_head_fast.cuh``, from C 96 on in its wide layout, each
     width's instances a unit of its own) at the same shapes, each
     against its fast plain
     version (FAST_SHARE) and against the 3xTF32 kernel on the same inputs
     (a distance of bf16's size), with bf16 tensor bounds beside the
     3xTF32 ones; kernels 2 and 3 (both precisions) also at the other model
     configurations' widths and lengths (CONFIG_RAY_SHAPES: C 112 at SN 64,
     128 and 256, C 80 and 64 at SN 64 and 128, C 88 at SN 256), on random
     weights of each width, resident and streamed tiles; kernels 1 and 4
     (both precisions) also at the feature grid's volume width 16 (tokens
     of 72), on random weights of that width, and at 6, 8 and 11 views
     (VIEWS_NV: DTU's evaluation set 1 has 11); fast kernel 1 at every
     view count from 2 to 11 (FAST_NV); kernels 1, 4 (both precisions) and
     8 past the compiled-in counts, at 12 and 49 views on 16,384 points
     (VIEWS_PAST: the streamed kernels and the fusion's runtime count);
  4. slice phase: ``extract_geometry_for_dataset`` on one DTU-scale view
     (800x640, 3 views, 192 hypotheses, 64 + 64 samples, seeded random
     weights) by six routes: on the exact path (``config.EXACT``) the
     default (knobs off), the render-glue knobs on, route A
     (``fused_point_head='never'``: the view transformer and the
     tiny-attention kernel, same weights), route B (the ablation without
     explicit similarity, its own seeded weights) and route v2
     (``point_head='v2'``: the split-weight point head, same weights); and
     the shipped route, the JAX package's extraction defaults (merged
     volumes, bf16 volumes and gather sources, fast heads: kernels 1 and 2
     in fast, no volume fusion), checking each depth map written to disk,
     the path each run resolved, which kernels each run launched and how
     often each head built its weight pack (once per head, set of weights
     and precision: the packs are cached); then, for each route, that a
     small ray chunk of the same scene agrees with the plain versions run
     on the CPU (a fast route by the size of the bf16 effect: medians,
     max, and ray by ray); the merged volume's bytes beside the JAX guard's count;
     one 1024-ray chunk of the shipped route with the glue knobs on
     (kernel 3 in fast) and one with ``point_head='v2'`` (kernel 4 in
     fast);
  5. gradient phase: one backward through route A's per-point stage of a
     256-ray coarse chunk, through the tiny-attention backward kernel,
     against the same backward on the CPU;
  6. probe phase: the row-gather benchmark's probe entry point
     (``uforecon_tpu_torch/script/bench_tile_gather.py --mode probe``) at
     256 blocks: its JSON line, bit-equal first block, the kernel launched;
  7. A/B phase: AB_ROUNDS rounds of full views in the order off, on,
     on, off on one encoding, warm from the slice phase's views (rays/s
     per view, SM clock and power read after each);
  8. pipeline phase: the shipped DTU evaluation flow through the port's
     CLIs. The fixture (``script/make_dtu_fixture.py``: a textured sphere
     at 1600x1200, views 23 24 33); ``cli.run`` at full width (800x640, 3
     views, 64 + 64 samples) on the seeded weights from a state-dict file
     (``--load_ckpt``) at its defaults (the JAX package's: kernels 1 and 2
     in fast on every view) and with the exact flags (kernels 1 and 2 in
     3xTF32), each scan's rays/s; on
     analytic depth maps of the sphere in the extract layout,
     ``cli.tsdf_fusion`` on the card at voxel 4 mm (the shipped size) and
     1.5 mm, each volume held against the same integration on the CPU;
     ``cli.depth_fusion``, ``cli.clean_mesh`` and ``cli.dtu_eval`` against
     points on the sphere (accuracy and completeness within one voxel);
     each stage's time; and the cards phase's (a): ``cli.run --mesh_shape 2``
     at its defaults, which on one card resolves to 1 (its printed line
     says so) and writes the depth files of ``--mesh_shape 1`` bit for bit;
  9. general phase: the custom-capture flow (``--test_general``): the
     port's GeneralFit fixture (``script/make_general_fixture.py``, 5 views
     of a sphere at 768x576 as baseline JPEGs and masks) and the host time
     of ``read_jpeg``; ``cli.run --test_general --dataset blendedmvs
     --use_mask`` at full width (64 + 64 samples, seeded weights from a
     state-dict file) at 3 views at its defaults with
     ``--extract_similarity --sim_reso 128`` (fast kernels 1 and 2 on every
     view, then 32 launches of kernel 7 for the field), with the exact
     flags, and at 5 views (per-stage volumes by the JAX guard; peak
     memory); a chunk of the field and the scene's first 256 rays, card
     against CPU; ``cli.tsdf_fusion --dataset general``;
 10. configs phase: the JAX package's other model configurations
     (CONFIGS: the feature grid without depth PE, the feature grid with
     the depth guide and the similarity, no depth PE, ``use_dir_srdf``,
     ``volume_reso`` 0, and the default model at 128 + 128 samples), each
     with seeded weights on the exact path rendering one 1024-ray chunk
     of the slice's scene on the card (kernels 5 and 2; the guided
     feature grid kernel 1 at tokens of 72 and 2; at 128 + 128, 1 and 2)
     against the CPU; then ``cli.run --use_dir_srdf
     --test_sample_coarse 128 --test_sample_fine 128`` at its defaults on
     the DTU sphere fixture at 800x640 (ray-head width 112 at SN 128 and 256,
     fast kernels 5 and 2 on every view): rays/s and peak memory; and a
     1024-ray chunk of each bf16 policy at the JAX extraction defaults,
     card vs CPU (``--encoder_dtype bfloat16``: fast kernels 1 and 2, held
     as a fast route; ``--compute_dtype bfloat16``: kernel 5 alone, by the
     bf16 effect's distribution);
 11. training phase (``pipeline/trainer.py``, ``pipeline/fit.py``): at the
     full width of the JAX training default (``ndepths`` 48/32/8, 192
     hypotheses, 64 + 64 samples, 1024 rays, 5 views at 640x512 on the
     learn_sanity sphere, seeded weights, matcher frozen, Adam on the
     rest; volumes stored in bf16, kernels in 3xTF32): (a) one coarse
     256-ray gradient step on the card against the same step on the CPU
     (the matcher's outputs taken from the card on both); (b) TRAIN_STEPS
     timed steps of the default route (kernels 1 and 2 on every step) and
     of route A (kernels 5 and 6, and 2; TRAIN_STEPS): s/step,
     peak memory, launches and weight-pack builds per step, and after each
     step's forward kernel 1 at the updated weights against its plain
     version (the stale-pack guard), then one default-route step under
     torch.profiler (device ms of its encode, render and backward, busy
     share, the costliest operations); (c) ``cli.run --debug`` on the
     fixture's DTU training layout (``make_dtu_fixture.
     write_train_layout``), then ``cli.run --extract_geometry --load_ckpt``
     on the checkpoint it wrote; (d) in step 14; (e) every model
     configuration, cascade flag and precision policy the JAX CLI trains
     (TRAIN_CONFIGS: the feature grid without and with the depth guide, no
     depth PE, no depth guide, ``use_dir_srdf``, ``volume_reso`` 0,
     ``share_cr``, ``--encoder_dtype bfloat16``, ``--compute_dtype
     bfloat16``), each with seeded weights: a coarse 128-ray step at
     320x256 card vs CPU, then TRAIN_CFG_STEPS timed full steps at the
     training default (s/step, peak memory, the kernels JAX's gates imply on every step),
     then ``cli.run --debug`` with ``--use_dir_srdf --share_cr
     --encoder_dtype bfloat16 --grad_method undetached`` and the
     extraction from its checkpoint with the same flags;
 12. views phase: DTU's evaluation set 1 (the fixture's 11 views at
     800x640, ``script/make_dtu_fixture.py``): ``cli.run --extract_geometry
     --set 1`` at its defaults at 11 views (at 480x384, 36 % of the rays,
     the guard's per-stage volumes still: at 800x640 it took a quarter of
     the run) and at 4 (the JAX
     guard's per-stage volumes): fast kernels 1 and 2 on every view, rays/s,
     encode seconds, peak memory; then a 1024-ray chunk at 6, 8 and 11
     views on the card against the CPU, on the exact path and at the JAX
     extraction defaults, the latter also with the card's fine pass on the
     CPU's fine samples (``views_phase`` says how each is held);
 13. cards phase (``parallel/sharding.py``, after the views phase's
     chunks): one 1024-ray training step at the
     JAX training default (640x512, kernels 1 and 2) on one rank, then the
     slice's 800x640 view at the CLI defaults (fast kernels 1 and 2)
     through ``extract_geometry_for_dataset`` and that step on
     CARDS_RANKS gloo ranks that share this card (each its share of the
     rays; NCCL refuses two ranks on one card): rank 0's depth map equal
     to the slice phase's shipped route bit for bit, the all-reduced
     step's loss within rtol 1e-3 and its gradient tree within relative L2
     2e-2 of one rank's, each rank's kernel launches counted. Ranks
     sharing a card measure correctness only. With two cards or more the
     same runs over NCCL across the cards (rays/s and s/step per card
     count); with one, a line says it was not run;
 14. from step 8 on, beside steps 8, 9, 12 and 13, each in a process of
     its own: steps 10 and 11 (SIDE_PHASES, one process, in that order),
     the training phase's (d), ``script/learn_sanity.py --mesh_eval`` at its defaults (120 MVS + 300
     render steps, 160x128, 6 views), which must pass its rule, and the GPU unit tests of the
     kernels (``python -m pytest --noconftest -k on_gpu``
     ``tests/test_torch_port_kernels.py``, the fast ray heads' file and
     the fast kernel 4 cases that step 3 does not hold, GPU_TESTS: every
     kernel against its plain version at further shapes, ragged edges and
     padded ray lengths), which must pass. The device timings (steps 3-7) are done by then; the
     host-clock figures of steps 8-13 (rays/s, s/step) are taken with the
     card and the host shared among these processes;
 15. prints a JSON line of per-kernel results, then the final
     ``{"ok": true, "device": {...}}`` line.
Any failure exits non-zero without printing a result; without a CUDA card
it exits 1 at once.
"""
import collections
import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np

SEED = 0
# f32 with another summation order; the three heads' layer GEMMs
# in 3xTF32 on the tensor cores. Measured on an H100: token 6.6e-6,
# radiance 3.6e-7, srdf 3.6e-6 (3x margin); grouped cosine 1.8e-7 and
# NeuS outputs 3.6e-6 (5x margin, the cosine's tolerance being the 1e-6 of
# the CPU parity tests); volume fusion 0 at 3 views (the same roundings in
# the same order), 4.8e-7 at 5 (torch sums the views in another order).
# NeuS weight, rgb and opacity are also held relative where they
# reach 1e-2, on inputs where compositing matters: measured 3.3e-5 (6x
# margin). The tiny attention is held as the JAX package holds its kernel:
# rtol = atol = 2e-5 forward, 3e-4 on the gradients; route A's per-point
# gradients on the card and on the CPU to 1e-3 of each weight's largest
# gradient (sums over 16,384 points in another order)
TOL = {"token": 2e-5, "radiance": 2e-6, "srdf": 2e-5,
       "cosine": 1e-6, "fusion": 1e-6, "neus": 2e-5, "neus_rel": 2e-4,
       "attention": 2e-5, "attention_grad": 3e-4, "route_grad_rel": 1e-3,
       "tsdf": 1e-5, "tsdf_share": 0.999}
NEUS_OUT = ("srdf", "weight", "rgb", "depth", "opacity")
# pipeline phase: the fixture's views; the shipped TSDF voxel size (mm) and
# fuse_scan's default. The card's TSDF volume is held against the CPU's:
# voxels within TOL["tsdf"] on at least TOL["tsdf_share"] of the grid (the
# same float32 operations in the same order on both)
PIPELINE_VIEWS = (23, 24, 33)
PIPELINE_WH = (800, 640)               # the DTU render size cli.run gives
PIPELINE_VOXELS = (4.0, 1.5)
# general phase: the GeneralFit fixture's scan and size (768x576, BlendedMVS),
# the view sets rendered, and the similarity field's resolution: 128^3
# points, 32 chunks of 65,536 (pipeline/extract.py)
GENERAL_SCAN = "scan_sphere"
GENERAL_WH = (768, 576)
GENERAL_SIM_RESO = 128
GENERAL_SIM_CHUNKS = GENERAL_SIM_RESO ** 3 // 65536
# views phase: DTU's evaluation set 1 (data/dtu_test.SET1_VIEW_LIST, 11
# views): the view counts of its card-vs-CPU chunks and of the kernel
# phase's extra point-head cases; cli.run --set 1 at 11 views and at 4 (the
# JAX merge guard's per-stage volumes) at the DTU render size
VIEWS_NV = (6, 8, 11)
VIEWS_CLI = (11, 4)
# view counts past the 11 the kernels compile in (a custom capture's pair
# file with more sources; DTU's 49 views in training), at a small P, in
# the kernel phase; and the views phase's one chunk at 12 views (the
# fixture's 11 ids of set 1 and one more, each its own camera) of 1024
# rays, as the phase's other chunks. The per-ray rule is at the edge of
# what the card's render holds there with the heads' plain versions too
# (script/views_agreement.py, four draws of 256 rays and three of 1024:
# the kernels missed it on 3 of 7, both heads' plain versions on the card
# on 3 of 7; at 256 rays this chunk's draw misses it with either)
VIEWS_PAST = (12, 49)
VIEWS_PAST_P = 16384
VIEWS_CHUNK = (12, 1024, 16)   # views, rays (CONFIG_CHUNK), the extra view's id
# the view counts at which the kernel phase holds fast kernel 1
FAST_NV = tuple(range(2, 12))
# the GPU unit tests of the side process: the kernels' file, the fast ray
# heads' and fast kernel 4's at the (volume width, views) cases of FAST_NV
# that the kernel phase does not hold (it holds width 24 at 3 views and at
# VIEWS_NV, width 16 at 3)
_PH2F_TESTS = "tests/test_torch_port_point_head2_fast.py::test_fast_kernel2_"
GPU_TESTS = ("tests/test_torch_port_kernels.py", "tests/test_torch_port_ray_head_fast.py",
             f"{_PH2F_TESTS}pack_size_is_the_image_on_gpu",
             *(f"{_PH2F_TESTS}matches_plain_on_gpu[{cv}-{nv}]" for cv in (24, 16)
               for nv in FAST_NV if (cv, nv) not in {(24, 3), *((24, v) for v in VIEWS_NV),
                                                     (16, 3)}))
# the 11-view scan renders at 36 % of the rays (it took 270.8 s of the run
# at 800x640): the smallest size of multiples of 32 at which the JAX guard
# still keeps its per-stage volumes (its byte count above merge_max_bytes);
# the 4-view scan, the chunks and the kernel phase's NV 11 rows stay at the
# full size
VIEWS_CLI_WH = {11: (480, 384)}
# views per route in the A/B phase: 2 x AB_ROUNDS
AB_ROUNDS = 1
# training phase: the DTU training crop; timed steps per route
TRAIN_WH = (640, 512)
TRAIN_STEPS = {"off": 3, "A": 2}
# cards phase: ranks along the ray axis (parallel/sharding.py); on one card
# they share it over gloo (NCCL refuses two ranks on one card)
CARDS_RANKS = 2
PORT = "uforecon_tpu_torch"
# the JAX reference package, never imported here: the port's name without
# its suffix
JAX_PACKAGE = PORT.removesuffix("_torch")
# kernel -> (its source, the Pallas function it replaces)
KERNEL_SOURCES = {
    "point_head": (f"{PORT}/csrc/point_head.cuh",
                   f"{JAX_PACKAGE}/ops/fused_point_head.py:207"),
    "ray_head": (f"{PORT}/csrc/ray_head.cu",
                 f"{JAX_PACKAGE}/ops/fused_ray_head.py:134"),
    "grouped_cosine": (f"{PORT}/csrc/grouped_cosine.cu",
                       f"{JAX_PACKAGE}/ops/fused_similarity.py:93"),
    "volume_fusion": (f"{PORT}/csrc/volume_fusion.cu",
                      f"{JAX_PACKAGE}/ops/fused_volume_fusion.py:62"),
    "ray_head_neus": (f"{PORT}/csrc/ray_head.cu",
                      f"{JAX_PACKAGE}/ops/fused_ray_head.py:332"),
    "tiny_attention": (f"{PORT}/csrc/tiny_attention.cuh",
                       f"{JAX_PACKAGE}/ops/pallas_attention.py:190"),
    "tiny_attention_bwd": (f"{PORT}/csrc/tiny_attention.cuh",
                           f"{JAX_PACKAGE}/ops/pallas_attention.py:147"),
    "point_head2": (f"{PORT}/csrc/point_head2.cuh",
                    f"{JAX_PACKAGE}/ops/fused_point_head2.py:163"),
    "block_row_gather": (f"{PORT}/csrc/row_gather.cu",
                         "script/bench_tile_gather.py:210"),
}
# the heads' bf16 instantiations (kernel_precision 'fast'), which replace
# the same Pallas kernels run in the JAX package's 'fast' mode; counted on
# the wrappers' launches_fast
FAST = {"point_head_fast": "point_head", "ray_head_fast": "ray_head",
        "ray_head_neus_fast": "ray_head_neus", "point_head2_fast": "point_head2"}
KERNEL_SOURCES.update({f: KERNEL_SOURCES[k] for f, k in FAST.items()})
# fast kernels 1, 2, 3 and 4 are designs of their own: persistent blocks,
# resident weights (fast kernels 2 and 3 at the widths of frh.FAST_WIDTHS,
# 40 .. 112, mlp1 and the density MLP's first two matrices from the L2 at
# frh.WIDE_WIDTHS; fast kernels 1 and 4 at 2..11 views, past them the
# streamed kernels)
KERNEL_SOURCES["point_head_fast"] = (f"{PORT}/csrc/point_head_fast.cuh",
                                     KERNEL_SOURCES["point_head"][1])
KERNEL_SOURCES["point_head2_fast"] = (f"{PORT}/csrc/point_head2_fast.cuh",
                                      KERNEL_SOURCES["point_head2"][1])
for _name in ("ray_head_fast", "ray_head_neus_fast"):
    KERNEL_SOURCES[_name] = (f"{PORT}/csrc/ray_head_fast.cuh", KERNEL_SOURCES[FAST[_name]][1])
# the translation units of the fast ray heads' instances, one a width
# (ray_head_fast.cu: C 88 and the entry points); the kernels line lists them
RAY_FAST_UNITS = tuple(f"{PORT}/csrc/ray_head_fast{'' if c == 88 else f'_{c}'}.cu"
                       for c in range(40, 113, 8))
# configs phase: the JAX package's other model configurations (flags of
# both packages' Config), each rendering a 1024-ray chunk of the slice's
# scene on the card against the CPU; their ray-head widths (d_view + 8) and
# lengths (64 + 64 samples: SN 64 and 128; 128 + 128: 128 and 256)
CONFIGS = {
    "featuregrid": dict(volume_type="featuregrid", mvs_depth_guide=0,
                        depth_pos_encoding=False),            # C 72
    # with the depth guide and the similarity, JAX's gate sends the feature
    # grid to the point head (tokens of 72)
    "featuregrid_guided": dict(volume_type="featuregrid"),    # C 80
    "no_depth_pe": dict(depth_pos_encoding=False),            # C 80
    "dir_srdf": dict(use_dir_srdf=True),                      # C 112
    "no_volume": dict(volume_reso=0),                         # C 64
    "samples_128": dict(coarse_sample=128, fine_sample=128),  # C 88, SN 128 + 256
}
CONFIG_RAY_SHAPES = ((112, (64, 128, 256)), (80, (64, 128)), (64, (64, 128)),
                     (88, (256,)))
CONFIG_CHUNK = 1024
# training phase (e): the model configurations, cascade flags and precision
# policies the JAX CLI trains (flags of the port's Config), each a coarse
# step card vs CPU at TRAIN_CFG_A_WH with TRAIN_CFG_A_RAYS rays and
# TRAIN_CFG_STEPS timed steps at the training default
TRAIN_CONFIGS = {
    "featuregrid": dict(volume_type="featuregrid", mvs_depth_guide=0,
                        depth_pos_encoding=False),
    "featuregrid_guided": dict(volume_type="featuregrid"),
    "no_depth_pe": dict(depth_pos_encoding=False),
    "no_depth_guide": dict(mvs_depth_guide=0),
    "dir_srdf": dict(use_dir_srdf=True),
    "no_volume": dict(volume_reso=0),
    "share_cr": dict(share_cr=True),
    "mixed": dict(encoder_dtype="bfloat16"),
    "bf16": dict(compute_dtype="bfloat16"),
}
TRAIN_CFG_A_WH = (320, 256)
TRAIN_CFG_A_RAYS = 128
TRAIN_CFG_STEPS = 1
TRAIN_CFG_CLI = ["--depth_pos_encoding", "--explicit_similarity", "--use_dir_srdf",
                 "--share_cr", "--encoder_dtype", "bfloat16", "--grad_method",
                 "undetached"]
# the run each kernel belongs to: its launches are read from that run
ROUTE = {"point_head": "off", "ray_head": "off", "grouped_cosine": "on",
         "volume_fusion": "on", "ray_head_neus": "on", "tiny_attention": "A",
         "tiny_attention_bwd": "grad", "point_head2": "v2",
         "block_row_gather": "probe", "point_head_fast": "shipped",
         "ray_head_fast": "shipped", "ray_head_neus_fast": "shipped_on",
         "point_head2_fast": "shipped_v2"}
# the kernels each run must launch; every other kernel must stay idle
MUST_RUN = {"off": ("point_head", "ray_head"),
            "on": ("point_head", "grouped_cosine", "volume_fusion", "ray_head_neus"),
            "A": ("tiny_attention", "ray_head"),
            "B": ("tiny_attention", "ray_head"),
            "grad": ("tiny_attention", "tiny_attention_bwd"),
            "v2": ("point_head2", "ray_head"),
            # the JAX defaults: merged volumes, bf16 volumes and gather
            # sources, 'fast' heads; the merged query needs no fusion kernel
            "shipped": ("point_head_fast", "ray_head_fast"),
            "shipped_on": ("point_head_fast", "grouped_cosine", "ray_head_neus_fast"),
            "shipped_v2": ("point_head2_fast", "ray_head_fast"),
            "probe": ("block_row_gather",),
            "pipeline": ("point_head_fast", "ray_head_fast"),
            "pipeline_exact": ("point_head", "ray_head"),
            "train": ("point_head", "ray_head"),
            "train_A": ("tiny_attention", "tiny_attention_bwd", "ray_head"),
            "train_cli": ("point_head", "ray_head"),
            "train_cli_extract": ("point_head_fast", "ray_head_fast"),
            # cards phase: cli.run --mesh_shape 2 at its defaults; each rank's
            # share of a view at the defaults, and of a training step
            "pipeline_mesh2": ("point_head_fast", "ray_head_fast"),
            "cards_render": ("point_head_fast", "ray_head_fast"),
            "cards_step": ("point_head", "ray_head"),
            # the training configurations (TRAIN_CONFIGS), as JAX's gates
            # route them: the point head where the full feature set is
            # there in float32, the view transformer (kernel 5 and its
            # backward, kernel 6) elsewhere, the ray head in float32 only
            **{f"train_cfg_{name}": ("point_head", "ray_head")
               for name in ("featuregrid_guided", "share_cr", "mixed")},
            **{f"train_cfg_{name}": ("tiny_attention", "tiny_attention_bwd", "ray_head")
               for name in ("featuregrid", "no_depth_pe", "no_depth_guide", "dir_srdf",
                            "no_volume")},
            "train_cfg_bf16": ("tiny_attention", "tiny_attention_bwd"),
            "train_cfg_cli": ("tiny_attention", "tiny_attention_bwd", "ray_head"),
            "train_cfg_cli_extract": ("tiny_attention", "ray_head_fast"),
            # a chunk of each bf16 policy at the JAX extraction defaults
            "config_mixed": ("point_head_fast", "ray_head_fast"),
            "config_bf16": ("tiny_attention",),
            # it trains, then renders its depth maps and mesh at the
            # trainer's precision (3xTF32), as the JAX package's process does
            "learn_sanity": ("point_head", "ray_head"),
            # cli.run --test_general: its renders at the defaults and exact,
            # at 3 and 5 views; the similarity field, kernel 7 alone
            "general": ("point_head_fast", "ray_head_fast"),
            "general_exact": ("point_head", "ray_head"),
            "general_5": ("point_head_fast", "ray_head_fast"),
            "general_sim": ("grouped_cosine",),
            # the other model configurations: the view transformer (no
            # point-head kernel, JAX's gate) and the ray head at their widths;
            # the guided feature grid and the default model at 128 + 128
            # samples take the point head
            **{f"config_{name}": ("tiny_attention", "ray_head") for name in CONFIGS
               if name not in ("samples_128", "featuregrid_guided")},
            "config_featuregrid_guided": ("point_head", "ray_head"),
            "config_samples_128": ("point_head", "ray_head"),
            "config_cli": ("tiny_attention", "ray_head_fast"),
            # DTU's evaluation set 1: a chunk at 6, 8 and 11 views on the
            # exact path and at the JAX extraction defaults, and cli.run at
            # its defaults at 11 views and at 4
            **{f"views_exact_{nv}": ("point_head", "ray_head") for nv in VIEWS_NV},
            **{f"views_shipped_{nv}": ("point_head_fast", "ray_head_fast")
               for nv in (*VIEWS_NV, VIEWS_CHUNK[0])},
            "views_cli": ("point_head_fast", "ray_head_fast"),
            **{f"views_cli_{nv}": ("point_head_fast", "ray_head_fast") for nv in VIEWS_CLI[1:]}}
# H100 SXM data sheet at 700 W: FP32 outside the tensor cores, dense TF32
# and dense bf16 on the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_TF32 = 494.7e12
PEAK_BF16 = 989.4e12
PEAK_BYTES = 3.35e12
# the kernels whose layer GEMMs run on the tensor cores: in 3xTF32, and
# their fast variants in bf16
TENSOR_CORE = ("point_head", "ray_head", "ray_head_neus", "point_head2", *FAST)
# a fast kernel against its fast plain version: both take products of
# bf16-rounded operands but sum them in other orders, so now and then an
# intermediate lands on the other side of a bf16 rounding and moves an
# output by a bf16 step of that input; in the ray head a flip of one of a
# ray's key-value sums moves that head's outputs in all the ray's samples
# (measured on an H100: 95.2-99.4 % of elements within the tolerance, the
# fewest at SN 128). At least FAST_SHARE of the elements of each
# per-sample output within the 3xTF32 tolerance, none of any output
# further off than the largest bf16 effect on it (the fast plain version
# against the FP32 one); a kernel that rounds at one site more or fewer
# than JAX misses the tolerance on most elements. The NeuS epilogue's
# per-ray sums (rgb, depth, opacity: 87-94 % within the tolerance at SN
# 128) take any flip of their ray's samples: they are held by the bound
FAST_SHARE = 0.9
PER_RAY = ("rgb", "depth", "opacity")
# a fast route's render, card vs CPU (agree_with_cpu): at least RAY_SHARE
# of the rays no further apart than RAY_EFFECT times that ray's bf16
# effect (CPU fast vs CPU FP32), or 2e-4
RAY_SHARE = 0.97
RAY_EFFECT = 2.0


def log(msg):
    print(msg, flush=True)



def smi(fields):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=10):
    """Median CUDA-event time of fn() in ms, after two warm-up calls."""
    import torch

    fn()
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_times(fn, reps=10):
    """(kernel ms, call ms) per call of fn, a kernel wrapper: the device
    time of the port's own kernels (``device_ms``) and the CUDA-event time
    of the whole call (``time_ms``), which adds the wrapper's host work
    (weight packs, checks) where the device waits for it."""
    return device_ms(fn, reps), time_ms(fn, reps)


def device_ms(fn, reps=10, before=None):
    """Device time per call of fn, a kernel wrapper: the mean time of the
    port's own kernels (namespace ``ufo::``) that it launches, from
    torch.profiler over reps calls; before(), if given, runs ahead of each
    call (a write that evicts the L2, say) and is not counted.

    The trace now and then loses a few kernel records of a run (seen on an
    H100: 7 of 10), so a short trace is taken again, up to three times;
    if every trace is short, the kernel time is the mean over the launches
    the best trace saw. A trace with more launches than calls fails: the
    wrapper launches one kernel per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and "ufo::" in e.name]
        if len(us) > reps:
            raise AssertionError(f"{reps} calls, the profiler saw {len(us)} "
                                 "launches of the port's kernels")
        if len(us) > len(best):
            best = us
        if len(us) == reps:
            break
    if not best:
        raise AssertionError("the profiler saw no launch of the port's kernels")
    if len(best) < reps:
        log(f"[profile] the trace kept {len(best)} of {reps} launches; "
            "kernel time is their mean")
    return sum(best) / len(best) / 1e3


def bound(n_bytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    FP32 operations over the peak rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_bound(n_bytes, gemm_flops, other_flops, fast=False):
    """The bounds of a kernel whose GEMMs run on the tensor cores, in
    3xTF32 (three TF32 products per FP32 product) or with ``fast`` in one
    bf16 pass, and the rest in FP32: {"bound_ms", "bound_by", "bound_rate",
    "fp32_bound_ms", "fp32_bound_by"}, the FP32 bound as if every operation
    ran on the CUDA cores; with ``fast`` also "tf32_bound_ms", the 3xTF32
    bound of the same operations."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3

    def t_ops(gemm_ms):
        return gemm_ms + other_flops / PEAK_FLOPS * 1e3

    t_tf32 = t_ops(3 * gemm_flops / PEAK_TF32 * 1e3)
    t = t_ops(gemm_flops / PEAK_BF16 * 1e3) if fast else t_tf32
    fp32_ms, fp32_by = bound(n_bytes, gemm_flops + other_flops)
    out = {"bound_ms": max(t_bytes, t),
           "bound_by": "bytes" if t_bytes >= t else "operations",
           "bound_rate": ("tensor operations (bf16, dense peak 989.4 TFLOP/s)" if fast
                          else "tensor operations (3xTF32)"),
           "fp32_bound_ms": fp32_ms, "fp32_bound_by": fp32_by}
    if fast:
        out["tf32_bound_ms"] = max(t_bytes, t_tf32)
    return out


def shares(ms, bounds):
    """The kernel's share of each bound (bound / time)."""
    out = {"bound_share": bounds["bound_ms"] / ms}
    if "fp32_bound_ms" in bounds:
        out["fp32_bound_share"] = bounds["fp32_bound_ms"] / ms
    return out


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def point_head_flops(nv, p, c=80, fast=False):
    """Multiply-adds x 2 of the point head per launch, as (GEMM, other):
    per token (NV views + the view token) the q/k/v/merge projections and
    the 2C -> 2C -> C MLP, the layers on the tensor cores; the similarity
    MLP per point, attention across the tokens and the radiance MLP per
    view. In ``fast`` the two small MLPs are bf16 products too (sites of
    JAX's kernel_dot, whose operands it rounds to bf16) and count with the
    GEMMs, at every view count, however the kernel sums them."""
    tokens = nv + 1
    sim = 2 * (8 * 32 + 32 * 32 + 32 * 16)
    per_token = 4 * 2 * c * c + 2 * (2 * c) ** 2 + 2 * (2 * c) * c
    attn = 4 * tokens * tokens * c
    rad = 2 * ((c + 3) * 16 + 16 * 8 + 8)
    gemm, small = p * tokens * per_token, p * (sim + nv * rad)
    return (gemm + small, p * attn) if fast else (gemm, small + p * attn)


def point_head2_flops(nv, p, c=80, g_view=40, g_shared=40, fast=False):
    """Multiply-adds x 2 of the split-weight point head per launch, as
    (GEMM, other). On the tensor cores: once per point the view-shared
    groups [vol | sim16] through the q/k/v, mlp1 and radiance rows; per
    view [img | pe] through the q/k/v and mlp1 rows and [img | pe | dir |
    m2] through the radiance layer 0 (the function's work, not the
    kernel's zero padding); per token (NV views + the view token) merge,
    mlp1's message half and mlp2. On the CUDA cores: the similarity MLP,
    attention across the tokens, and the radiance tail per view; in
    ``fast`` the similarity MLP and the radiance tail count with the GEMMs
    (bf16 products, as point_head_flops has it)."""
    tokens = nv + 1
    sim = 8 * 32 + 32 * 32 + 32 * 16
    shared = g_shared * (3 * c + 2 * c + 16)
    view = nv * (g_view * (3 * c + 2 * c) + (g_view + 3 + c) * 16)
    per_token = c * c + c * 2 * c + 2 * c * c
    attn = 2 * tokens * tokens * c
    rad_tail = nv * (16 * 8 + 8)
    gemm, small = 2 * p * (shared + view + tokens * per_token), 2 * p * (sim + rad_tail)
    return (gemm + small, 2 * p * attn) if fast else (gemm, small + 2 * p * attn)


def attention_flops(b, l, s, h, d, m, backward=False):
    """FP32 operations of the tiny attention per launch: per (point, head)
    phi of q and k, L x S scores, denominators and weighted sums, the
    divisions; the backward recomputes those and adds ds, dv, dq and dk."""
    fwd = (l + s) * d + 2 * l * s * (d + m) + l * s + l * m
    if not backward:
        return b * h * fwd
    return b * h * (fwd + l * s * (3 * m + 2) + 2 * l * s * (m + 2 * d)
                    + 2 * (l + s) * d)


def ray_head_flops(rn, sn, c=88, heads=8, neus=False, fast=False):
    """Multiply-adds x 2 of the ray head per launch, as (GEMM, other):
    q/k/v/merge and the 2C -> 2C -> C MLP per sample, the layers on the
    tensor cores; the density MLP and the kv-order attention per sample
    (kv and num 2 NH DK^2 each, den 2C, ksum and the divisions 2C), and
    ~30 operations per sample of the NeuS epilogue. In ``fast`` the
    density MLP, kv, num and den are bf16 products too (sites of JAX's
    kernel_dot, whose operands it rounds to bf16; kv and num per head, what
    the inputs need, not JAX's masked C x C) and count with the GEMMs;
    only the elementwise work stays at the FP32 rate."""
    dk = c // heads
    gemm = 4 * 2 * c * c + 2 * (2 * c) ** 2 + 2 * (2 * c) * c
    small = 2 * (c * 32 + 32 * 16 + 16) + 4 * heads * dk * dk + 2 * c
    other = 2 * c + (30 if neus else 0)
    if fast:
        return rn * sn * (gemm + small), rn * sn * other
    return rn * sn * gemm, rn * sn * (small + other)


def fast_ray_kernel(c, sn=None, neus=False):
    """The source of the fast ray head's instances at width c (and, on
    ray_head.cu, its tile rows at sn)."""
    from uforecon_tpu_torch.ops import fused_ray_head as frh

    if c in frh.FAST_WIDTHS:
        return RAY_FAST_UNITS[(c - 40) // 8]
    tiles = "" if sn is None else f", tiles of {frh.tile_rows(sn, c, neus)} rows"
    return f"{PORT}/csrc/ray_head.cu (kFast{tiles})"


def neus_check(got, want):
    """The NeuS outputs where compositing matters: the regime of the
    inputs (srdf crosses zero inside the rays, so alpha spans 0..1 and the
    transmittance product shapes the weights), the median size of each
    output and the relative error where an output reaches 1e-2."""
    weight, opacity = want[1], want[4]
    regime = {"opacity_median": opacity.median().item(),
              "rays_max_weight_gt_0.05": (weight.amax(dim=1) > 0.05).float().mean().item()}
    size = {k: b.abs().median().item() for k, b in zip(NEUS_OUT, want)}
    rel = {}
    for k, a, b in zip(NEUS_OUT, got, want):
        if k in ("weight", "rgb", "opacity"):
            big = b.abs() >= 1e-2
            rel[k] = ((a - b).abs()[big] / b.abs()[big]).max().item()
    in_regime = regime["opacity_median"] > 0.3 and regime["rays_max_weight_gt_0.05"] >= 0.9
    return in_regime, regime, size, rel


def kernel_phase(model, card):
    """Each kernel vs its plain version on the card at main-path shapes,
    the point heads on model's weights."""
    import torch

    from uforecon_tpu_torch.ops import cuda_build
    from uforecon_tpu_torch.ops import fused_point_head as fph
    from uforecon_tpu_torch.ops import fused_point_head2 as fph2
    from uforecon_tpu_torch.ops import fused_ray_head as frh
    from uforecon_tpu_torch.ops import fused_similarity as fsim
    from uforecon_tpu_torch.ops import fused_volume_fusion as fvf
    from uforecon_tpu_torch.ops import row_gather as frg
    from uforecon_tpu_torch.ops import tiny_attention as fta

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0, g=gen):
        return torch.randn(shape, generator=g, device=dev) * scale

    def rand(*shape, g=gen):
        return torch.rand(shape, generator=g, device=dev)

    rt = model.ray_transformer
    results = {}

    # point head: 1024 rays x 64 samples, 3 views; ~30% of (view, point)
    # pairs masked and the first 256 points masked in every view
    nv, p = 3, 1024 * 64

    def point_inputs(n, views=nv, g=gen, c_vol=24):
        mask = (rand(views, n, g=g) > 0.3).float()
        mask[:, :256] = 0.0
        return fph.PointHeadInputs(
            img_feat=randn(views, n, 32, g=g), vol_feat=randn(n, c_vol, g=g),
            sim_feat=rand(n, 8, g=g) * 2 - 1,
            depth_dist=randn(views, n, scale=0.3, g=g),
            dir_rel=randn(views, n, 3, scale=0.1, g=g), rgb=rand(views, n, 3, g=g),
            mask=mask)

    inp = point_inputs(p)
    params = rt.point_head_params()
    with torch.no_grad():
        tok, rad = fph.point_head(inp, params)
        tok_ref, rad_ref = fph.point_head_reference(inp, params)
        torch.cuda.synchronize()
        err_t = (tok - tok_ref).abs().max().item()
        err_r = (rad - rad_ref).abs().max().item()
        masked_mean = inp.rgb[:, :256].mean(0)
        err_masked = (rad[:256] - masked_mean).abs().max().item()
        ms, call_ms = kernel_times(lambda: fph.point_head(inp, params))
        plain_ms = time_ms(lambda: fph.point_head_reference(inp, params))
    # weights counted once, as the kernel reads them: the hi/lo pack
    bounds = tensor_bound(nbytes(*inp, fph.pack_weights(params), tok, rad),
                          *point_head_flops(nv, p))
    log(f"[kernel] point_head P={p} NV={nv}: max|token err| {err_t:.3e} "
        f"(tol {TOL['token']}), max|radiance err| {err_r:.3e} "
        f"(tol {TOL['radiance']}), all-masked points vs mean rgb "
        f"{err_masked:.3e}; kernel {ms:.3f} ms (call {call_ms:.3f}, call - kernel "
        f"{call_ms - ms:.3f}), plain {plain_ms:.3f} ms, tensor bound "
        f"{bounds['bound_ms']:.4f} ms ({bounds['bound_by']}, share "
        f"{bounds['bound_ms'] / ms:.3f}), FP32 bound {bounds['fp32_bound_ms']:.4f} ms "
        f"(share {bounds['fp32_bound_ms'] / ms:.3f}) [{card}]")
    if not (err_t <= TOL["token"] and err_r <= TOL["radiance"]
            and err_masked <= TOL["radiance"]):
        raise AssertionError("point_head kernel disagrees with its plain version")
    results["point_head"] = {"max_abs_err": max(err_t, err_r), "ms": ms, "call_ms": call_ms,
                             "plain_ms": plain_ms, **bounds, **shares(ms, bounds),
                             "token_err": err_t, "radiance_err": err_r}

    # split-weight point head (point_head='v2') on the same weights, at the
    # main path's 65,536 points and the ragged 65,537; no single PyTorch
    # call computes this function, so the point head on the same inputs is
    # its yardstick
    v2 = {}
    for n in (p, p + 1):
        inp2 = inp if n == p else point_inputs(n)
        with torch.no_grad():
            tok, rad = fph2.point_head2(inp2, params)
            tok_ref, rad_ref = fph2.point_head2_reference(inp2, params)
            torch.cuda.synchronize()
            err_t = (tok - tok_ref).abs().max().item()
            err_r = (rad - rad_ref).abs().max().item()
            err_masked = (rad[:256] - inp2.rgb[:, :256].mean(0)).abs().max().item()
            k_ms, call_ms = kernel_times(lambda: fph2.point_head2(inp2, params))
            p_ms = time_ms(lambda: fph2.point_head2_reference(inp2, params))
            v1_ms, v1_call_ms = kernel_times(lambda: fph.point_head(inp2, params))
        # weights counted once, as the kernel reads them: the hi/lo pack
        bounds2 = tensor_bound(nbytes(*inp2, fph2.pack_weights2(params), tok, rad),
                               *point_head2_flops(nv, n))
        log(f"[kernel] point_head2 P={n} NV={nv}: max|token err| {err_t:.3e} "
            f"(tol {TOL['token']}), max|radiance err| {err_r:.3e} (tol "
            f"{TOL['radiance']}), all-masked points vs mean rgb {err_masked:.3e}; "
            f"kernel {k_ms:.3f} ms (call {call_ms:.3f}), plain {p_ms:.3f} ms, "
            f"point_head kernel on the same inputs {v1_ms:.3f} ms (call "
            f"{v1_call_ms:.3f}), tensor bound {bounds2['bound_ms']:.4f} ms "
            f"({bounds2['bound_by']}, share {bounds2['bound_ms'] / k_ms:.3f}), FP32 "
            f"bound {bounds2['fp32_bound_ms']:.4f} ms (share "
            f"{bounds2['fp32_bound_ms'] / k_ms:.3f}) [{card}]")
        if not (err_t <= TOL["token"] and err_r <= TOL["radiance"]
                and err_masked <= TOL["radiance"]):
            raise AssertionError(f"point_head2 kernel disagrees with its plain "
                                 f"version at P={n}")
        v2[n] = {"max_abs_err": max(err_t, err_r), "ms": k_ms, "call_ms": call_ms,
                 "plain_ms": p_ms, "point_head_ms": v1_ms,
                 "point_head_call_ms": v1_call_ms, **bounds2, **shares(k_ms, bounds2),
                 "token_err": err_t, "radiance_err": err_r}
    results["point_head2"] = {**v2[p], "max_abs_err": max(x["max_abs_err"]
                                                          for x in v2.values()),
                              "ragged": v2[p + 1]}

    # ray head, with and without the NeuS epilogue: one render chunk
    # launches it once at SN 64 (coarse) and once at SN 128 (fine), so the
    # per-chunk figures are the sums over the two; at width 88 (the
    # default) and 72 (route B), on random weights of each width
    # (random_ray_params)
    near, far = 425.0 / 300.0, 900.0 / 300.0

    def ray_head_case(name, head, c, sn):
        """One launch of the ray head (or its NeuS variant) at width c and
        SN samples on head = (RayHeadParams, NeuS variance), against its
        plain version."""
        neus = name == "ray_head_neus"
        tol = TOL["neus" if neus else "srdf"]
        rparams, variance = head
        y = randn(1024, sn, c)
        if neus:
            z = near + (far - near) * torch.sort(rand(1024, sn), dim=1).values
            args = (y, z, rand(1024, sn, 3), torch.exp(variance * 10.0))
            kern, plain = frh.ray_head_neus, frh.ray_head_neus_reference
        else:
            args = (y,)
            kern, plain = frh.ray_head, frh.ray_head_reference
        with torch.no_grad():
            got = kern(*args, rparams)
            want = plain(*args, rparams)
            got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
            torch.cuda.synchronize()
            # depth sums weights x z (up to 3 scene units): relative where
            # it exceeds 1
            err_by = {k: ((a - b).abs() / (b.abs().clamp(min=1.0)
                                           if k == "depth" else 1.0)).max().item()
                      for k, a, b in zip(NEUS_OUT, got, want)}
            k_ms, call_ms = kernel_times(lambda: kern(*args, rparams))
            p_ms = time_ms(lambda: plain(*args, rparams))
        bounds = tensor_bound(nbytes(*args, frh.pack_weights(rparams), *got),
                              *ray_head_flops(1024, sn, c=c, neus=neus))
        err = max(err_by.values())
        rows = frh.tile_rows(sn, c, neus)
        log(f"[kernel] {name} (1024, {sn}, {c}), tiles of {rows} rows "
            f"({'resident' if rows >= sn else 'streamed'}): max err {err:.3e} {err_by} "
            f"(tol {tol}); kernel {k_ms:.3f} ms (call {call_ms:.3f}, call - kernel "
            f"{call_ms - k_ms:.3f}), plain {p_ms:.3f} ms, tensor bound "
            f"{bounds['bound_ms']:.4f} ms ({bounds['bound_by']}, share "
            f"{bounds['bound_ms'] / k_ms:.3f}), FP32 bound "
            f"{bounds['fp32_bound_ms']:.4f} ms (share "
            f"{bounds['fp32_bound_ms'] / k_ms:.3f}) [{card}]")
        case = {"ms": k_ms, "call_ms": call_ms, "plain_ms": p_ms, **bounds,
                "errors": err_by, "tile_rows": rows}
        if neus:
            in_regime, regime, size, rel = neus_check(got, want)
            log(f"[kernel] {name} C={c} SN={sn}: inputs {regime}; median |output| "
                f"{size}; max rel err where |output| >= 1e-2 {rel} "
                f"(tol {TOL['neus_rel']})")
            case.update(regime=regime, median_abs=size, rel_errors=rel)
            if not in_regime:
                raise AssertionError(f"{name} inputs at C={c} SN={sn} leave "
                                     f"compositing idle: {regime}")
            if not max(rel.values()) <= TOL["neus_rel"]:
                raise AssertionError(f"{name} kernel disagrees at C={c} SN={sn}: {rel}")
        if not err <= tol:
            raise AssertionError(f"{name} kernel disagrees at C={c} SN={sn}: {err_by}")
        return case

    # the ray heads' weights: random, of each width, drawn as the GPU unit
    # tests draw them, so that their srdf crosses zero inside the rays and
    # compositing matters (neus_check fails the run where it does not)
    def random_ray_params(c):
        def w(o, i):
            return randn(o, i, scale=1.0 / np.sqrt(i))
        return (frh.RayHeadParams(
            wq=w(c, c), wk=w(c, c), wv=w(c, c), wmerge=w(c, c),
            norm1_scale=1 + randn(c, scale=0.1), norm1_bias=randn(c, scale=0.1),
            w1=w(2 * c, 2 * c), w2=w(c, 2 * c), norm2_scale=1 + randn(c, scale=0.1),
            norm2_bias=randn(c, scale=0.1), dens_w=(w(32, c), w(16, 32), w(1, 16)),
            dens_b=(randn(32, scale=0.1), randn(16, scale=0.1), randn(1, scale=0.1))),
            torch.tensor(0.3, device=dev))

    heads = {c: random_ray_params(c) for c in (88, 72)}
    for name in ("ray_head", "ray_head_neus"):
        by_c = {}
        for c in (88, 72):
            cases = {sn: ray_head_case(name, heads[c], c, sn) for sn in (64, 128)}
            by_c[c] = {k: sum(x[k] for x in cases.values())
                       for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                 "fp32_bound_ms")}
            by_c[c].update({k: cases[128][k] for k in ("bound_by", "bound_rate",
                                                       "fp32_bound_by")},
                           by_sn=cases)
            by_c[c].update(shares(by_c[c]["ms"], by_c[c]))
        # the JSON line's times are per chunk at the default width 88
        results[name] = {"max_abs_err": max(e for v in by_c.values()
                                            for x in v["by_sn"].values()
                                            for e in x["errors"].values()),
                         **{k: by_c[88][k] for k in (
                             "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                             "bound_rate", "fp32_bound_ms", "fp32_bound_by",
                             "bound_share", "fp32_bound_share")},
                         "by_width": by_c}

    # the other model configurations' widths and lengths (configs phase)
    config_heads = {c: random_ray_params(c) for c, _ in CONFIG_RAY_SHAPES}
    for name in ("ray_head", "ray_head_neus"):
        results[name]["by_shape"] = {
            f"C{c} SN{sn}": ray_head_case(name, config_heads[c], c, sn)
            for c, sns in CONFIG_RAY_SHAPES for sn in sns}
        results[name]["max_abs_err"] = max(
            results[name]["max_abs_err"],
            *(e for x in results[name]["by_shape"].values() for e in x["errors"].values()))

    # the fast variants (kernel_precision 'fast') at the same shapes: each
    # against its fast plain version (FAST_SHARE rule), and against the
    # 3xTF32 kernel on the same inputs, which it must miss by bf16's size
    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def fast_case(name, wrapper, plain, args, tols, flops, pack, neus=False):
        with torch.no_grad():
            got = as_tuple(wrapper(*args, precision="fast"))
            twin = as_tuple(plain(*args, precision="fast"))
            exact = as_tuple(plain(*args))
            tf32 = as_tuple(wrapper(*args))
            torch.cuda.synchronize()
            errs, shares_in, gaps, ok = {}, {}, {}, True
            for key, a, b, e, tol in zip(tols, got, twin, exact, tols.values()):
                # depth sums weights x z (up to 3 scene units): relative
                # where it exceeds 1
                scale = b.abs().clamp(min=1.0) if key == "depth" else 1.0
                d = (a - b).abs() / scale
                gap = ((b - e).abs() / scale).max().item()
                errs[key], gaps[key] = d.max().item(), gap
                shares_in[key] = (d <= tol).float().mean().item()
                ok &= (errs[key] <= tol if gap <= tol
                       else errs[key] <= gap and (key in PER_RAY
                                                  or shares_in[key] >= FAST_SHARE))
            vs_tf32 = max((a - t).abs().max().item() for a, t in zip(got, tf32))
            k_ms, call_ms = kernel_times(lambda: wrapper(*args, precision="fast"))
            p_ms = time_ms(lambda: plain(*args, precision="fast"))
        bounds = tensor_bound(nbytes(*[a for a in args if torch.is_tensor(a)], pack, *got),
                              *flops, fast=True)
        log(f"[kernel] {name}: vs its fast plain version max err {errs} (tol {tols}), "
            f"share within tol {shares_in} (min {FAST_SHARE}), bf16 effect (fast plain vs "
            f"FP32 plain) {gaps} (per-ray outputs {PER_RAY} held by it alone); vs the "
            f"3xTF32 kernel {vs_tf32:.3e}; kernel {k_ms:.3f} ms "
            f"(call {call_ms:.3f}), fast plain {p_ms:.3f} ms, bf16 tensor bound "
            f"{bounds['bound_ms']:.4f} ms ({bounds['bound_by']}, share "
            f"{bounds['bound_ms'] / k_ms:.3f}), 3xTF32 bound {bounds['tf32_bound_ms']:.4f}"
            f" ms, FP32 bound {bounds['fp32_bound_ms']:.4f} ms [{card}]")
        case = {"ms": k_ms, "call_ms": call_ms, "plain_ms": p_ms, **bounds,
                "errors": errs, "share_within_tol": shares_in, "bf16_effect": gaps,
                "vs_tf32": vs_tf32}
        if neus:
            in_regime, regime, _, _ = neus_check(got, twin)
            case["regime"] = regime
            if not in_regime:
                raise AssertionError(f"{name} inputs leave compositing idle: {regime}")
        if not (ok and 1e-4 < vs_tf32 < 0.1):
            raise AssertionError(f"{name} disagrees with its fast plain version or is "
                                 f"not the bf16 variant: {case}")
        return case

    def fast_result(cases):
        """The per-chunk sums of several launches' cases."""
        out = {k: sum(c[k] for c in cases) for k in ("ms", "call_ms", "plain_ms",
                                                      "bound_ms", "fp32_bound_ms",
                                                      "tf32_bound_ms")}
        out.update({k: cases[-1][k] for k in ("bound_by", "bound_rate", "fp32_bound_by")})
        out["max_abs_err"] = max(e for c in cases for e in c["errors"].values())
        out["vs_tf32"] = max(c["vs_tf32"] for c in cases)
        out.update(shares(out["ms"], out))
        return out

    # and at 5 views, as the general phase's 5-view set runs it (one launch
    # per 1024-ray chunk and stage, 65,536 points); drawn from a generator
    # of its own, so the other cases keep their inputs
    inp5 = point_inputs(p, views=5, g=torch.Generator(device=dev).manual_seed(SEED + 5))
    fast_views = {views: fast_result([fast_case(
        f"point_head_fast P={p} NV={views}", fph.point_head, fph.point_head_reference,
        (x, params), {"token": TOL["token"], "radiance": TOL["radiance"]},
        point_head_flops(views, p, fast=True), fph.pack_weights(params, "fast"))])
        for views, x in ((nv, inp), (5, inp5))}
    results["point_head_fast"] = {**fast_views[nv], "max_abs_err": max(
        x["max_abs_err"] for x in fast_views.values()), "by_views": fast_views}
    results["point_head2_fast"] = {**fast_result([fast_case(
        f"point_head2_fast P={p} NV={nv}", fph2.point_head2, fph2.point_head2_reference,
        (inp, params), {"token": TOL["token"], "radiance": TOL["radiance"]},
        point_head2_flops(nv, p, fast=True), fph2.fast_image2(params))])}

    # the feature grid's 16 volume features (tokens of 72, heads of 9; the
    # configs phase's featuregrid_guided): both point heads in 3xTF32 and
    # fast at the main path's P and NV, on random weights of that width
    # drawn as the GPU unit tests draw them, from a generator of their own
    g16 = torch.Generator(device=dev).manual_seed(SEED + 16)
    inp16 = point_inputs(p, g=g16, c_vol=16)

    def linear_w(o, i):
        return randn(o, i, scale=1.0 / np.sqrt(i), g=g16)

    c16 = 72
    params16 = fph.PointHeadParams(
        view_token=randn(c16, g=g16), wq=linear_w(c16, c16), wk=linear_w(c16, c16),
        wv=linear_w(c16, c16), wmerge=linear_w(c16, c16),
        norm1_scale=1 + randn(c16, scale=0.1, g=g16), norm1_bias=randn(c16, scale=0.1, g=g16),
        w1=linear_w(2 * c16, 2 * c16), w2=linear_w(c16, 2 * c16),
        norm2_scale=1 + randn(c16, scale=0.1, g=g16), norm2_bias=randn(c16, scale=0.1, g=g16),
        sim_w=(linear_w(32, 8), linear_w(32, 32), linear_w(16, 32)),
        sim_b=tuple(randn(n, scale=0.1, g=g16) for n in (32, 32, 16)),
        rad_w=(linear_w(16, c16 + 3), linear_w(8, 16), linear_w(1, 8)),
        rad_b=tuple(randn(n, scale=0.1, g=g16) for n in (16, 8, 1)))

    def pack2(w, precision="high", streamed=False):
        """The pack kernel 4 reads: in fast up to 11 views the fast image."""
        if cuda_build.is_fast(precision) and not streamed:
            return fph2.fast_image2(w)
        return fph2.pack_weights2(w, precision=precision)

    def point_head_cases(name, label, wrapper, plain, x, prm, flops, pack):
        """A point head at one shape: the 3xTF32 kernel against its plain
        version (TOL, the all-masked points' mean rgb), timed, with its
        tensor bound; then its fast variant (fast_case). flops(fast): the
        head's flop count in that precision. Returns both results."""
        with torch.no_grad():
            tok, rad = wrapper(x, prm)
            tok_ref, rad_ref = plain(x, prm)
            torch.cuda.synchronize()
            err_t = (tok - tok_ref).abs().max().item()
            err_r = (rad - rad_ref).abs().max().item()
            err_masked = (rad[:256] - x.rgb[:, :256].mean(0)).abs().max().item()
            k_ms, call_ms = kernel_times(lambda: wrapper(x, prm))
            p_ms = time_ms(lambda: plain(x, prm))
        bounds_x = tensor_bound(nbytes(*x, pack(prm), tok, rad), *flops(fast=False))
        log(f"[kernel] {name} {label}: max|token err| {err_t:.3e} (tol {TOL['token']}), "
            f"max|radiance err| {err_r:.3e} (tol {TOL['radiance']}), all-masked points vs "
            f"mean rgb {err_masked:.3e}; kernel {k_ms:.3f} ms (call {call_ms:.3f}), plain "
            f"{p_ms:.3f} ms, tensor bound {bounds_x['bound_ms']:.4f} ms "
            f"({bounds_x['bound_by']}, share {bounds_x['bound_ms'] / k_ms:.3f}) [{card}]")
        if not (err_t <= TOL["token"] and err_r <= TOL["radiance"]
                and err_masked <= TOL["radiance"]):
            raise AssertionError(f"{name} kernel disagrees with its plain version at {label}")
        exact = {"max_abs_err": max(err_t, err_r), "ms": k_ms, "call_ms": call_ms,
                 "plain_ms": p_ms, **bounds_x, **shares(k_ms, bounds_x)}
        fast = fast_result([fast_case(
            f"{name}_fast {label}", wrapper, plain, (x, prm),
            {"token": TOL["token"], "radiance": TOL["radiance"]}, flops(fast=True),
            pack(prm, precision="fast"))])
        return exact, fast

    def file_case(name, exact, fast, views=None):
        """Files a point head's results, in both precisions, as its feature
        grid's or under by_views, and their errors into the kernel's."""
        for n, r in ((name, exact), (f"{name}_fast", fast)):
            if views is None:
                results[n]["feature_grid"] = r
            else:
                results[n].setdefault("by_views", {})[views] = r
            results[n]["max_abs_err"] = max(results[n]["max_abs_err"], r["max_abs_err"])

    heads16 = {"point_head": (fph.point_head, fph.point_head_reference,
                              partial(point_head_flops, nv, p, c=c16), fph.pack_weights),
               "point_head2": (fph2.point_head2, fph2.point_head2_reference,
                               partial(point_head2_flops, nv, p, c=c16, g_shared=32),
                               pack2)}
    for name, (wrapper, plain, flops16, pack) in heads16.items():
        file_case(name, *point_head_cases(
            name, f"P={p} NV={nv} C={c16} (feature grid)", wrapper, plain, inp16, params16,
            flops16, pack))

    # more views (DTU's evaluation set 1 has 11: --test_n_view up to 11):
    # both point heads in both precisions at NV 6, 8 and 11 on the main
    # path's 65,536 points and the shared weights, each view count's inputs
    # from a generator of its own
    for views in VIEWS_NV:
        x = point_inputs(p, views=views,
                         g=torch.Generator(device=dev).manual_seed(SEED + 100 + views))
        for name, wrapper, plain, flops, pack in (
                ("point_head", fph.point_head, fph.point_head_reference,
                 partial(point_head_flops, views, p), fph.pack_weights),
                ("point_head2", fph2.point_head2, fph2.point_head2_reference,
                 partial(point_head2_flops, views, p), pack2)):
            file_case(name, *point_head_cases(name, f"P={p} NV={views}", wrapper, plain, x,
                                              params, flops, pack), views=views)
        del x
    # fast kernel 1 at the other view counts of 2..11 (FAST_NV), on the
    # main path's 65,536 points, each count's inputs from a generator of its
    # own
    fast1 = results["point_head_fast"]
    for views in FAST_NV:
        if views in fast1["by_views"]:
            continue
        x = point_inputs(p, views=views,
                         g=torch.Generator(device=dev).manual_seed(SEED + 100 + views))
        fast1["by_views"][views] = fast_result([fast_case(
            f"point_head_fast P={p} NV={views}", fph.point_head, fph.point_head_reference,
            (x, params), {"token": TOL["token"], "radiance": TOL["radiance"]},
            point_head_flops(views, p, fast=True), fph.pack_weights(params, "fast"))])
        fast1["max_abs_err"] = max(fast1["max_abs_err"],
                                   fast1["by_views"][views]["max_abs_err"])
        del x
    # from 6 views on fast kernel 1 is a design of its own, FMA-summed
    for views, r in fast1["by_views"].items():
        if 6 <= views <= FAST_NV[-1]:
            r["source"] = f"{PORT}/csrc/point_head_fast_views.cu"
    # past the 11 views the kernels compile in (VIEWS_PAST): both point
    # heads in both precisions on 16,384 points, the streamed kernels
    for views in VIEWS_PAST:
        x = point_inputs(VIEWS_PAST_P, views=views,
                         g=torch.Generator(device=dev).manual_seed(SEED + 100 + views))
        for name, wrapper, plain, flops, pack in (
                ("point_head", fph.point_head, fph.point_head_reference,
                 partial(point_head_flops, views, VIEWS_PAST_P),
                 partial(fph.pack_weights, streamed=True)),
                ("point_head2", fph2.point_head2, fph2.point_head2_reference,
                 partial(point_head2_flops, views, VIEWS_PAST_P),
                 partial(pack2, streamed=True))):
            file_case(name, *point_head_cases(name, f"P={VIEWS_PAST_P} NV={views}", wrapper,
                                              plain, x, params, flops, pack), views=views)
        del x
    for name in ("ray_head", "ray_head_neus"):
        neus = name == "ray_head_neus"
        by_c = {}
        for c in (88, 72):
            rparams, variance = heads[c]
            cases = []
            for sn in (64, 128):
                y = randn(1024, sn, c)
                if neus:
                    z = near + (far - near) * torch.sort(rand(1024, sn), dim=1).values
                    args = (y, z, rand(1024, sn, 3), torch.exp(variance * 10.0), rparams)
                    tols = {k: TOL["neus"] for k in NEUS_OUT}
                    wrapper, plain = frh.ray_head_neus, frh.ray_head_neus_reference
                else:
                    args, tols = (y, rparams), {"srdf": TOL["srdf"]}
                    wrapper, plain = frh.ray_head, frh.ray_head_reference
                cases.append(fast_case(
                    f"{name}_fast (1024, {sn}, {c}), {fast_ray_kernel(c)}", wrapper, plain,
                    args, tols, ray_head_flops(1024, sn, c=c, neus=neus, fast=True),
                    frh.pack_weights(rparams, "fast"), neus=neus))
            by_c[c] = fast_result(cases)
        by_shape = {}
        for c, sns in CONFIG_RAY_SHAPES:
            rparams, variance = config_heads[c]
            for sn in sns:
                y = randn(1024, sn, c)
                if neus:
                    z = near + (far - near) * torch.sort(rand(1024, sn), dim=1).values
                    args = (y, z, rand(1024, sn, 3), torch.exp(variance * 10.0), rparams)
                    tols = {k: TOL["neus"] for k in NEUS_OUT}
                    wrapper, plain = frh.ray_head_neus, frh.ray_head_neus_reference
                else:
                    args, tols = (y, rparams), {"srdf": TOL["srdf"]}
                    wrapper, plain = frh.ray_head, frh.ray_head_reference
                by_shape[f"C{c} SN{sn}"] = fast_result([fast_case(
                    f"{name}_fast (1024, {sn}, {c}), {fast_ray_kernel(c, sn, neus)}", wrapper,
                    plain, args, tols, ray_head_flops(1024, sn, c=c, neus=neus, fast=True),
                    frh.pack_weights(rparams, "fast"), neus=neus)])
                by_shape[f"C{c} SN{sn}"]["source"] = fast_ray_kernel(c)
        for c in by_c:
            by_c[c]["source"] = fast_ray_kernel(c)
        results[f"{name}_fast"] = {**by_c[88], "by_width": by_c, "by_shape": by_shape}
        results[f"{name}_fast"]["max_abs_err"] = max(
            by_c[88]["max_abs_err"], *(x["max_abs_err"] for x in by_shape.values()))

    # grouped cosine at (3, 65,536, 64) in the layout the sampler hands
    # over: channel-first memory, strides (64 P, 1, P)
    x = randn(nv, 64, p).permute(0, 2, 1)
    with torch.no_grad():
        got = fsim.grouped_cosine(x, 8)
        want = fsim.grouped_cosine_reference(x, 8)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        k_ms, call_ms = kernel_times(lambda: fsim.grouped_cosine(x, 8))
        p_ms = time_ms(lambda: fsim.grouped_cosine_reference(x, 8))
    n_pairs = nv * (nv - 1) // 2
    b_ms, b_by = bound(nbytes(x, got), p * n_pairs * (6 * 32 + 8 * 6))
    log(f"[kernel] grouped_cosine {tuple(x.shape)} strides {x.stride()}: max "
        f"abs err {err:.3e} (tol {TOL['cosine']}); kernel {k_ms:.4f} ms (call "
        f"{call_ms:.4f}), plain "
        f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{card}]")
    if not err <= TOL["cosine"]:
        raise AssertionError("grouped_cosine kernel disagrees with its plain version")
    by_views = {nv: {"max_abs_err": err, "ms": k_ms, "call_ms": call_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by}}
    # and at 5 views, (5, 65,536, 128): a chunk of a 5-view set's
    # similarity field (pipeline/extract.py), in the same layout
    x5 = randn(5, 128, p).permute(0, 2, 1)
    with torch.no_grad():
        got5 = fsim.grouped_cosine(x5, 8)
        want5 = fsim.grouped_cosine_reference(x5, 8)
        torch.cuda.synchronize()
        err5 = (got5 - want5).abs().max().item()
        k5_ms, call5_ms = kernel_times(lambda: fsim.grouped_cosine(x5, 8))
        p5_ms = time_ms(lambda: fsim.grouped_cosine_reference(x5, 8))
    b5_ms, b5_by = bound(nbytes(x5, got5), p * 10 * (6 * 32 + 8 * 6))
    log(f"[kernel] grouped_cosine {tuple(x5.shape)} strides {x5.stride()}: max abs err "
        f"{err5:.3e} (tol {TOL['cosine']}); kernel {k5_ms:.4f} ms (call {call5_ms:.4f}), "
        f"plain {p5_ms:.4f} ms, bound {b5_ms:.4f} ms ({b5_by}) [{card}]")
    if not err5 <= TOL["cosine"]:
        raise AssertionError("grouped_cosine kernel disagrees with its plain version "
                             "at 5 views")
    by_views[5] = {"max_abs_err": err5, "ms": k5_ms, "call_ms": call5_ms,
                   "plain_ms": p5_ms, "bound_ms": b5_ms, "bound_by": b5_by}
    del x5, got5, want5
    # and at 11 views, (11, 65,536, 320): the 55 pairs of a render chunk of
    # DTU's evaluation set 1, in the same layout, from a generator of its own
    v11 = VIEWS_NV[-1]
    x11 = randn(v11, (v11 - 1) * 32, p,
                g=torch.Generator(device=dev).manual_seed(SEED + 200)).permute(0, 2, 1)
    with torch.no_grad():
        got11 = fsim.grouped_cosine(x11, 8)
        want11 = fsim.grouped_cosine_reference(x11, 8)
        torch.cuda.synchronize()
        err11 = (got11 - want11).abs().max().item()
        k11_ms, call11_ms = kernel_times(lambda: fsim.grouped_cosine(x11, 8))
        p11_ms = time_ms(lambda: fsim.grouped_cosine_reference(x11, 8))
    pairs11 = v11 * (v11 - 1) // 2
    b11_ms, b11_by = bound(nbytes(x11, got11), p * pairs11 * (6 * 32 + 8 * 6))
    log(f"[kernel] grouped_cosine {tuple(x11.shape)} ({pairs11} pairs) strides "
        f"{x11.stride()}: max abs err {err11:.3e} (tol {TOL['cosine']}); kernel "
        f"{k11_ms:.4f} ms (call {call11_ms:.4f}), plain {p11_ms:.4f} ms, bound "
        f"{b11_ms:.4f} ms ({b11_by}, share {b11_ms / k11_ms:.3f}) [{card}]")
    if not err11 <= TOL["cosine"]:
        raise AssertionError(f"grouped_cosine kernel disagrees with its plain version "
                             f"at {v11} views")
    by_views[v11] = {"max_abs_err": err11, "ms": k11_ms, "call_ms": call11_ms,
                     "plain_ms": p11_ms, "bound_ms": b11_ms, "bound_by": b11_by}
    del x11, got11, want11
    results["grouped_cosine"] = {**by_views[nv], "by_views": by_views,
                                 "max_abs_err": max(x["max_abs_err"]
                                                    for x in by_views.values())}

    # volume fusion at 3 x (NV, 65,536, 9), channel-first as the sampler
    # gives it, sigmoid-range weights; the first 512 points have zero
    # weight in every view and stage. The main path's 3 views are timed with
    # the inputs in the L2, as F.grid_sample leaves them there just before
    # the kernel (the table's time), and after a 64 MB write (cold L2); 2
    # and 5 views and the ragged 65,537 points are checked and timed warm
    def fusion_inputs(n_views, n, g=gen):
        fws = []
        for _ in range(3):
            fw = randn(n_views, 9, n, g=g)
            fw[:, 8] = rand(n_views, n, g=g)
            fw[:, 8, :512] = 0.0
            fws.append(fw.permute(0, 2, 1))
        return fws

    flush = torch.empty(16 * 2 ** 20, device=dev)   # 64 MB, more than the L2's 50
    fusion = {}
    for n_views, n in ((3, p), (3, p + 1), (2, p), (5, p), (VIEWS_NV[-1], p),
                       *((v, VIEWS_PAST_P) for v in VIEWS_PAST)):
        # 11 views (DTU's evaluation set 1) and the counts past it (the
        # runtime count) each from a generator of its own
        fws = (fusion_inputs(n_views, n) if n_views <= 5 else fusion_inputs(
            n_views, n, g=torch.Generator(device=dev).manual_seed(
                SEED + 300 + (n_views if n_views > VIEWS_NV[-1] else 0))))
        with torch.no_grad():
            got = fvf.volume_fusion(*fws)
            want = fvf.volume_fusion_reference(fws)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            zero_ok = bool(torch.all(got[:512] == 0).item())
            k_ms, call_ms = kernel_times(lambda: fvf.volume_fusion(*fws))
            p_ms = time_ms(lambda: fvf.volume_fusion_reference(fws))
            cold_ms = (device_ms(lambda: fvf.volume_fusion(*fws), before=flush.zero_)
                       if (n_views, n) == (3, p) else None)
        b_ms, b_by = bound(nbytes(*fws, got), n * (n_views * (3 + 1 + 3 * 8 * 2) + 24))
        if cold_ms is not None:
            log(f"[kernel] volume_fusion 3 x {tuple(fws[0].shape)} after a 64 MB write "
                f"(cold L2): kernel {cold_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, share "
                f"{b_ms / cold_ms:.3f}) [{card}]")
        log(f"[kernel] volume_fusion 3 x {tuple(fws[0].shape)}: max abs err "
            f"{err:.3e} (tol {TOL['fusion']}), zero-weight points give 0: {zero_ok}; "
            f"kernel {k_ms:.4f} ms (call {call_ms:.4f}, call - kernel "
            f"{call_ms - k_ms:.4f}), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"share {b_ms / k_ms:.3f}) [{card}]")
        if not (err <= TOL["fusion"] and zero_ok):
            raise AssertionError(f"volume_fusion kernel disagrees with its plain version "
                                 f"at NV={n_views} P={n}")
        fusion[n_views, n] = {"max_abs_err": err, "ms": k_ms, "call_ms": call_ms,
                              "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                              **({"cold_ms": cold_ms} if cold_ms is not None else {})}
    del flush
    results["volume_fusion"] = {**fusion[3, p], "max_abs_err": max(
        f["max_abs_err"] for f in fusion.values()), "ragged": fusion[3, p + 1],
        "nv2": fusion[2, p], "nv5": fusion[5, p], "nv11": fusion[VIEWS_NV[-1], p],
        **{f"nv{v}": fusion[v, VIEWS_PAST_P] for v in VIEWS_PAST}}
    # tiny attention, forward and backward, at route A's shape: one
    # 1024-ray chunk x 64 samples, the view token and 3 views, 8 heads of
    # 10; the forward also at a ragged batch and at route B's head width 8
    def attention_inputs(b, d=10, l_=4):
        return (randn(b, l_, 8, d), randn(b, l_, 8, d), randn(b, l_, 8, d))

    # and at the training configurations' shapes: the view token and 4
    # source views (L = S = 5), heads of 9 (no depth PE or guide) and 13
    # (use_dir_srdf), 65,536 points a pass
    fwd = {}
    for d, b, l_ in ((10, p, 4), (10, p + 1, 4), (8, p, 4), (8, p + 1, 4), (9, p, 5),
                     (13, p, 5)):
        dims = dict(l=l_, s=l_, h=8, d=d, m=d)
        q, k, v = attention_inputs(b, d, l_)
        with torch.no_grad():
            got = fta.tiny_linear_attention(q, k, v)
            want = fta.tiny_linear_attention_reference(q, k, v)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            excess = ((got - want).abs() - TOL["attention"] * want.abs()).max().item()
            k_ms, call_ms = kernel_times(lambda: fta.tiny_linear_attention(q, k, v))
            p_ms = time_ms(lambda: fta.tiny_linear_attention_reference(q, k, v))
        b_ms, b_by = bound(nbytes(q, k, v, got), attention_flops(b, **dims))
        log(f"[kernel] tiny_attention B={b} L=S={l_} H=8 D=M={d}: max abs err {err:.3e} "
            f"(rtol = atol = {TOL['attention']}); kernel {k_ms:.4f} ms (call "
            f"{call_ms:.4f}), plain "
            f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, share {b_ms / k_ms:.3f}) "
            f"[{card}]")
        if not excess <= TOL["attention"]:
            raise AssertionError(f"tiny_attention kernel disagrees at B={b} D={d}")
        fwd[d, b] = {"max_abs_err": err, "ms": k_ms, "call_ms": call_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by}
    results["tiny_attention"] = {**fwd[10, p], "max_abs_err": max(f["max_abs_err"]
                                                                   for f in fwd.values()),
                                 "ragged": fwd[10, p + 1], "d8": fwd[8, p],
                                 "d8_ragged": fwd[8, p + 1], "train_l5_d9": fwd[9, p],
                                 "train_l5_d13": fwd[13, p]}

    # its backward kernel against torch.autograd through the plain forward,
    # at route A's L = S = 4 (65,536 and the ragged 65,537 points), at the
    # training shape the JAX package names (L = S = 6: the view token and
    # train_n_view 5), and at the training configurations' L = S = 5 (the
    # view token and 4 source views) with heads of 10 (--compute_dtype
    # bfloat16), 9 and 13
    bwd = {}
    for l_, b, d in ((4, p, 10), (4, p + 1, 10), (6, p, 10), (5, p, 10), (5, p, 9),
                     (5, p, 13)):
        dims = dict(l=l_, s=l_, h=8, d=d, m=d)
        q, k, v, g = (randn(b, l_, 8, d) for _ in range(4))
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(fta.tiny_linear_attention_reference(*qkv), qkv, g)
        with torch.no_grad():
            got = fta.tiny_linear_attention_backward(q, k, v, g)
            twin = fta.tiny_linear_attention_backward_reference(q, k, v, g)
            torch.cuda.synchronize()
            errs = {n: (a - b_).abs().max().item()
                    for n, a, b_ in zip(("dq", "dk", "dv"), got, want)}
            excess = max(((a - b_).abs() - TOL["attention_grad"] * b_.abs()).max().item()
                         for a, b_ in zip(got, want))
            twin_err = max((a - b_).abs().max().item() for a, b_ in zip(got, twin))
            k_ms, call_ms = kernel_times(
                lambda: fta.tiny_linear_attention_backward(q, k, v, g))
            p_ms = time_ms(lambda: fta.tiny_linear_attention_backward_reference(q, k, v, g))

        def autograd_plain():
            xs = [t.detach().requires_grad_() for t in (q, k, v)]
            torch.autograd.grad(fta.tiny_linear_attention_reference(*xs), xs, g)

        a_ms = time_ms(autograd_plain)
        b_ms, b_by = bound(nbytes(q, k, v, g, *got),
                           attention_flops(b, **dims, backward=True))
        log(f"[kernel] tiny_attention_bwd B={b} L=S={l_} H=8 D=M={d}: max abs err vs "
            f"autograd of the plain forward {errs} (rtol = atol = "
            f"{TOL['attention_grad']}), vs the plain backward {twin_err:.3e}; kernel "
            f"{k_ms:.4f} ms (call {call_ms:.4f}), plain backward {p_ms:.4f} ms, autograd "
            f"of the plain forward {a_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, share "
            f"{b_ms / k_ms:.3f}) [{card}]")
        if not excess <= TOL["attention_grad"]:
            raise AssertionError(f"tiny_attention backward kernel disagrees at B={b} "
                                 f"L={l_} D={d}: {errs}")
        bwd[l_, b, d] = {"max_abs_err": max(errs.values()), "ms": k_ms, "call_ms": call_ms,
                      "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "errors": errs, "plain_backward_err": twin_err,
                      "autograd_plain_ms": a_ms}
        del q, k, v, g, qkv, want, got, twin
    results["tiny_attention_bwd"] = {**bwd[4, p, 10], "max_abs_err": max(
        x["max_abs_err"] for x in bwd.values()), "ragged": bwd[4, p + 1, 10],
        "train_l6": bwd[6, p, 10], "train_l5_d10": bwd[5, p, 10],
        "train_l5_d9": bwd[5, p, 9], "train_l5_d13": bwd[5, p, 13]}

    # row gather at the probe's shape: 2048 blocks of 4096 rows of 128 bf16,
    # random in-block indices; bit for bit against its plain version, timed
    # beside one library call for the same gather (index_select on global
    # indices computed beforehand)
    blocks, rows = 2048, frg.BLOCK_ROWS
    src = randn(blocks * rows, frg.ROW_WIDTH).to(torch.bfloat16)
    idx = torch.randint(0, rows, (blocks * rows,), generator=gen, device=dev,
                        dtype=torch.int32)
    gidx = torch.arange(blocks, device=dev).repeat_interleave(rows) * rows + idx.long()
    with torch.no_grad():
        got = frg.block_row_gather(src, idx)
        want = frg.block_row_gather_reference(src, idx)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        lib_equal = bool(torch.equal(torch.index_select(src, 0, gidx), want))
        err = (got.float() - want.float()).abs().max().item()
        k_ms, call_ms = kernel_times(lambda: frg.block_row_gather(src, idx))
        p_ms = time_ms(lambda: frg.block_row_gather_reference(src, idx))
        l_ms = time_ms(lambda: torch.index_select(src, 0, gidx))
    moved = frg.bytes_moved(idx, rows, frg.ROW_WIDTH * src.element_size())
    distinct = (moved - nbytes(idx, got)) / (frg.ROW_WIDTH * src.element_size())
    b_ms, b_by = bound(moved, 0)
    log(f"[kernel] block_row_gather {blocks} blocks x {rows} rows x {frg.ROW_WIDTH} "
        f"bf16: bit-equal to its plain version {equal} (index_select {lib_equal}), "
        f"distinct source rows {distinct / (blocks * rows):.4f} of all; kernel "
        f"{k_ms:.4f} ms (call {call_ms:.4f}), plain {p_ms:.4f} ms, index_select "
        f"{l_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}) [{card}]")
    if not (equal and lib_equal):
        raise AssertionError("block_row_gather kernel disagrees with its plain version")
    results["block_row_gather"] = {"max_abs_err": err, "ms": k_ms, "call_ms": call_ms,
                                   "plain_ms": p_ms,
                                   "library_ms": l_ms, "bound_ms": b_ms,
                                   "bound_by": b_by,
                                   "distinct_row_share": distinct / (blocks * rows)}
    del src, idx, gidx, got, want
    torch.cuda.empty_cache()
    # no single PyTorch call computes the other eight functions
    # (scaled_dot_product_attention is softmax attention, not elu+1 linear)
    for name, r in results.items():
        r.setdefault("library_ms", None)
        if name not in TENSOR_CORE:
            r.update(shares(r["ms"], r))
    log("[kernel] share of the bound (bound ms / kernel ms): " + json.dumps(
        {n: {k: round(v, 4) for k, v in r.items() if k.endswith("_share")}
         for n, r in results.items()}) + f" [{card}]")
    return results


class FastCount:
    """A head wrapper's count of its fast launches (``launches_fast``),
    read and reset as ``launches`` under the fast variant's name."""

    def __init__(self, wrapper):
        self.wrapper = wrapper

    @property
    def launches(self):
        return self.wrapper.launches_fast

    @launches.setter
    def launches(self, n):
        self.wrapper.launches_fast = n


def launch_counts():
    from uforecon_tpu_torch.ops.fused_point_head import point_head
    from uforecon_tpu_torch.ops.fused_point_head2 import point_head2
    from uforecon_tpu_torch.ops.fused_ray_head import ray_head, ray_head_neus
    from uforecon_tpu_torch.ops.fused_similarity import grouped_cosine
    from uforecon_tpu_torch.ops.fused_volume_fusion import volume_fusion
    from uforecon_tpu_torch.ops.row_gather import block_row_gather
    from uforecon_tpu_torch.ops.tiny_attention import (
        tiny_linear_attention, tiny_linear_attention_backward)

    counts = {"point_head": point_head, "ray_head": ray_head,
              "grouped_cosine": grouped_cosine, "volume_fusion": volume_fusion,
              "ray_head_neus": ray_head_neus, "tiny_attention": tiny_linear_attention,
              "tiny_attention_bwd": tiny_linear_attention_backward,
              "point_head2": point_head2, "block_row_gather": block_row_gather}
    counts.update({f: FastCount(counts[k]) for f, k in FAST.items()})
    return counts


def pack_counters():
    """The wrappers that build a weight pack, by kernel name (ray_head's
    counter also counts ray_head_neus, which shares its pack)."""
    return {n: w for n, w in launch_counts().items() if hasattr(w, "pack_builds")}


def check_launches(run, launches):
    """Each kernel of the run launched at least once, every other none."""
    idle = [n for n in MUST_RUN[run] if launches[n] < 1]
    stray = [n for n, c in launches.items() if n not in MUST_RUN[run] and c]
    if idle or stray:
        raise AssertionError(f"run {run}: kernels not launched {idle}, launched "
                             f"off their route {stray}: {launches}")


def to_cpu(x):
    """Tensors, dicts and named tuples of them (None as it is), on the CPU."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_cpu(v) for v in x])
    return x.cpu()


def render_view(model, sample, route, card):
    """One full view through extract_geometry_for_dataset; returns its
    stats (with its depth map) and the kernel launches counted during it."""
    import torch

    from uforecon_tpu_torch.pipeline.extract import extract_geometry_for_dataset

    wrappers = launch_counts()
    with tempfile.TemporaryDirectory() as out_dir:
        for w in wrappers.values():
            w.launches = 0
        for w in pack_counters().values():
            w.pack_builds = 0
        torch.cuda.reset_peak_memory_stats()
        stats = extract_geometry_for_dataset(model, [sample], out_dir=out_dir,
                                             device="cuda", seed=SEED,
                                             previews=False)
        launches = {k: w.launches for k, w in wrappers.items()}
        builds = {k: w.pack_builds for k, w in pack_counters().items()}
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        saved = np.load(os.path.join(out_dir, "depth", "scan1", "00000000.npy"),
                        allow_pickle=True).item()
    depth = saved["depth"]
    path = "merged" if stats["merged"] else "per-stage"
    log(f"[slice] route {route}: 1 view 800x640, 3 views, 64+64 samples, {path} "
        f"volumes, kernel_precision {stats['kernel_precision']}: encode "
        f"{stats['encode_s']:.3f} s, render {stats['render_s']:.3f} s, "
        f"{stats['rays'] / stats['render_s']:.1f} rays/s over the render, peak "
        f"{peak_gb:.2f} GiB [{card}]")
    log(f"[slice] route {route}: launches during the run: {launches}; weight packs "
        f"built: {builds}")
    if depth.shape != (640, 800) or not np.all(np.isfinite(depth)):
        raise AssertionError(f"depth map {depth.shape}, finite "
                             f"{np.isfinite(depth).mean():.4f}")
    log(f"[slice] route {route}: depth map (640, 800) finite, range "
        f"[{depth.min():.1f}, {depth.max():.1f}] mm")
    return {**stats, "peak_gib": peak_gb, "pack_builds": builds, "depth": depth}, launches


def effect_figures(a, b, e, ctrl=None):
    """One output of an rn-ray chunk (leading axis the rays): the distances
    of a (the card's render) to b (the CPU's fast render) against the bf16
    effect, b's distance to e (the CPU's FP32 render); ctrl (the card's
    3xTF32 render), where given, measured beside it. Returns the figures,
    whether the rules held (the median distance at most 0.2 of the
    effect's, the max at most twice its max, at least RAY_SHARE of the rays
    within RAY_EFFECT times their own effect or 2e-4) and, per ray, whether
    it lies beyond RAY_EFFECT times its effect."""
    rn = a.shape[0]

    def per_ray(x):
        return x.reshape(rn, -1).max(axis=1)

    d, gap = np.abs(a - b), np.abs(b - e)
    d_r, gap_r = per_ray(d), per_ray(gap)
    ctrl_r = None if ctrl is None else per_ray(np.abs(ctrl - b))
    # the share of rays within k times their own effect (or 2e-4)
    within = {k: {"fast": float((d_r <= np.maximum(k * gap_r, 2e-4)).mean()),
                  **({} if ctrl_r is None else
                     {"control": float((ctrl_r <= np.maximum(k * gap_r, 2e-4)).mean())})}
              for k in (0.5, 1.0, RAY_EFFECT, 4.0)}
    figures = {"median": float(np.median(d)), "effect_median": float(np.median(gap)),
               "max": float(d.max()), "effect_max": float(gap.max()),
               **({} if ctrl is None else {"control_median": float(np.median(np.abs(ctrl - b)))}),
               "ray_median": float(np.median(d_r)),
               "ray_effect_median": float(np.median(gap_r)),
               **({} if ctrl_r is None else {"ray_control_median": float(np.median(ctrl_r))}),
               "rays_within_k_effect": within}
    ok = bool(np.median(d) <= max(0.2 * np.median(gap), 2e-4)
              and d.max() <= max(2 * gap.max(), 2e-4)
              and within[RAY_EFFECT]["fast"] >= RAY_SHARE)
    return figures, ok, d_r > np.maximum(RAY_EFFECT * gap_r, 2e-4)


@contextlib.contextmanager
def fine_samples(replay=None):
    """Inside it, render_chunk's fine samples (its importance sampler's
    points and z): recorded into the yielded dict's "out", or, given
    ``replay`` (such a pair), those, on the render's device."""
    from uforecon_tpu_torch.models import uforecon as uf

    inner, box = uf.sample_importance, {}

    def sampler(*args, **kw):
        if replay is not None:
            return tuple(t.to(args[0].device) for t in replay)
        box["out"] = inner(*args, **kw)
        return box["out"]

    uf.sample_importance = sampler
    try:
        yield box
    finally:
        uf.sample_importance = inner


def agree_with_cpu(model, sample, route, rn=256, tag="slice", staged=False):
    """An rn-ray chunk of the scene with the kernels on the card against
    the plain versions on the CPU, with the same draws: the share of rays
    within 2e-4 must reach 0.99. A model whose heads run in ``fast`` is
    held by the size of the bf16 effect instead: the fast plain versions
    and the fast kernels sum bf16-rounded products in other orders, so now
    and then an intermediate rounds the other way, and where the weights
    composite a surface the flip moves the coarse weights, the fine
    samples and the ray's outputs. Per output, against the bf16 effect
    (the distance between the CPU's fast and FP32 (``highest``) renders of
    the chunk): the median card-CPU distance at most 0.2 of the effect's
    median and the max at most twice its max (the rule of
    tests/test_torch_port_general_cli.py), and ray by ray, on at least
    RAY_SHARE of the rays, the ray's card-CPU distance (its largest over
    the output's elements) at most RAY_EFFECT times that ray's effect, or
    2e-4. A fault in a minority of rays (a slot, a tile) fails the last.
    The control, the card's 3xTF32 kernels (no bf16 rounding at all) in
    place of the fast ones against the same CPU render, is measured and
    reported beside it. With ``staged`` (in fast) the card's fine pass is
    also held apart from its fine samples: the card renders the chunk again
    with the CPU's fine samples in place of its own importance sampler's,
    and its fine depth and rgb must hold the per-ray rule against the
    CPU's (at least RAY_SHARE of the rays within RAY_EFFECT times their
    effect, or 2e-4): past 6 views a coarse weight that moves within its
    bf16 effect carries a fine sample across a bin of the CDF now and then
    (script/views_agreement.py), which the end-to-end rule counts against
    the card's fine pass. The rays and the draws come from SEED (the
    per-ray rule over other draws: script/views_agreement.py). Returns the
    shares (and, in fast, the distances) and the kernels the card's render
    launched."""
    import torch

    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample

    scene, extras = scene_inputs_from_sample(sample, "cuda")
    sn = model.cfg.coarse_sample
    wrappers = launch_counts()
    idx = np.random.default_rng(SEED).choice(len(extras["ray_d"]), rn, replace=False)
    ray_d = torch.as_tensor(extras["ray_d"][idx], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    u_c = torch.rand((rn, sn), generator=gen, device="cuda")
    u_f = torch.rand((rn, model.cfg.fine_sample), generator=gen, device="cuda")
    fast = model.kernel_precision == "fast"
    with torch.no_grad():
        enc = model.encode(scene)
        for w in wrappers.values():
            w.launches = 0
        out_gpu = model.render_chunk(scene, enc, ray_d, u_coarse=u_c, u_fine=u_f)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        model_cpu = copy.deepcopy(model).cpu()
        args = (to_cpu(scene), to_cpu(enc), ray_d.cpu())
        draws = dict(u_coarse=u_c.cpu(), u_fine=u_f.cpu())
        with fine_samples() as cpu_fine:
            out_cpu = model_cpu.render_chunk(*args, **draws)
        staged = staged and fast
        if staged:
            with fine_samples(replay=cpu_fine["out"]):
                out_staged = model.render_chunk(scene, enc, ray_d, u_coarse=u_c, u_fine=u_f)
        if fast:
            out_fp32 = model_cpu.with_knobs(kernel_precision="highest").render_chunk(
                *args, **draws)
            out_ctrl = model.with_knobs(kernel_precision="highest").render_chunk(
                scene, enc, ray_d, u_coarse=u_c, u_fine=u_f)

    agree, effect, ok_fast = {}, {}, True
    for phase in ("coarse", "fine"):
        for key in ("depth", "rgb"):
            a = out_gpu[phase][key].cpu().numpy()
            b = out_cpu[phase][key].numpy()
            ok = np.isclose(a, b, rtol=2e-4, atol=2e-4).reshape(rn, -1).all(axis=1)
            agree[f"{phase}_{key}"] = float(ok.mean())
            if fast:
                effect[f"{phase}_{key}"], ok_out, _ = effect_figures(
                    a, b, out_fp32[phase][key].numpy(), out_ctrl[phase][key].cpu().numpy())
                ok_fast &= ok_out
    fine_pass, ok_staged = {}, True
    if staged:
        for key in ("depth", "rgb"):
            fine_pass[key], _, _ = effect_figures(out_staged["fine"][key].cpu().numpy(),
                                                  out_cpu["fine"][key].numpy(),
                                                  out_fp32["fine"][key].numpy())
            ok_staged &= fine_pass[key]["rays_within_k_effect"][RAY_EFFECT]["fast"] >= RAY_SHARE
    log(f"[{tag}] route {route}: {rn}-ray chunk, card kernels vs CPU plain "
        f"versions: share of rays within rtol=atol=2e-4: {agree}"
        + (f"; fast: distances against the bf16 effect (CPU fast vs FP32) and the "
           f"control (card 3xTF32 vs CPU fast); per-ray rule: >= {RAY_SHARE} of rays "
           f"within {RAY_EFFECT} x their effect or 2e-4: {effect}" if fast else "")
        + (f"; staged: the card's fine pass on the CPU's fine samples, per-ray rule on the "
           f"fine depth and rgb: {fine_pass}" if staged else ""))
    ok = (ok_fast and ok_staged) if fast else min(agree.values()) >= 0.99
    if not ok:
        raise AssertionError(f"card and CPU renders disagree (route {route}): {agree} "
                             f"{effect} {fine_pass}")
    return {**agree, **({"fast_vs_effect": effect} if fast else {}),
            **({"fine_pass_on_cpu_samples": fine_pass} if staged else {}), "launches": launches}


def bf16_chunk_card_vs_cpu(model, sample, run, rn, card):
    """An rn-ray chunk of a bf16 ray transformer (``--compute_dtype
    bfloat16``) on the card against the CPU on the card's encoding, with
    the same draws, by the bf16 rule over the distribution
    (``tests/test_torch_port_bf16_model.py``): per output, the median
    card-CPU distance within the median bf16 effect and its 97th
    percentile within twice the effect's, the effect being the CPU's
    render of the same weights in the mixed policy (float32 ray
    transformer) on the same encoding. The card's view transformer runs
    the tiny attention in float32 (the JAX wrapper's cast), the CPU's in
    bf16, as JAX does on each. Returns the distances and the card's
    launches."""
    import dataclasses

    import torch

    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
    from uforecon_tpu_torch.models.uforecon import UFORecon

    scene, extras = scene_inputs_from_sample(sample, "cuda")
    wrappers = launch_counts()
    idx = np.random.default_rng(SEED).choice(len(extras["ray_d"]), rn, replace=False)
    ray_d = torch.as_tensor(extras["ray_d"][idx], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    u_c = torch.rand((rn, model.cfg.coarse_sample), generator=gen, device="cuda")
    u_f = torch.rand((rn, model.cfg.fine_sample), generator=gen, device="cuda")
    ref = UFORecon(dataclasses.replace(model.cfg, compute_dtype="float32",
                                       encoder_dtype="bfloat16"))
    ref.load_state_dict(model.state_dict())
    ref.requires_grad_(False)
    with torch.no_grad():
        enc = model.encode(scene)
        for w in wrappers.values():
            w.launches = 0
        out_gpu = model.render_chunk(scene, enc, ray_d, u_coarse=u_c, u_fine=u_f)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        args = (to_cpu(scene), to_cpu(enc), ray_d.cpu())
        draws = dict(u_coarse=u_c.cpu(), u_fine=u_f.cpu())
        out_cpu = copy.deepcopy(model).cpu().render_chunk(*args, **draws)
        out_ref = ref.render_chunk(*args, **draws)
    dist, ok = {}, True
    for phase in ("coarse", "fine"):
        for key in ("depth", "rgb", "opacity"):
            a = out_gpu[phase][key].float().cpu().numpy()
            b = out_cpu[phase][key].float().numpy()
            if not np.all(np.isfinite(a)):
                raise AssertionError(f"{run}: non-finite {phase} {key}")
            d, e = np.abs(a - b), np.abs(b - out_ref[phase][key].float().numpy())
            q_d, q_e = np.percentile(d, 100 * RAY_SHARE), np.percentile(e, 100 * RAY_SHARE)
            dist[f"{phase}_{key}"] = {"median": float(np.median(d)),
                                      "effect_median": float(np.median(e)),
                                      "q97": float(q_d), "effect_q97": float(q_e),
                                      "rays_within_2x_effect": float(np.mean(
                                          d.reshape(rn, -1).max(1)
                                          <= 2 * e.reshape(rn, -1).max(1)))}
            ok &= bool(np.median(d) <= max(np.median(e), 2e-4) and q_d <= max(2 * q_e, 2e-4))
    log(f"[configs] {run}: {rn}-ray chunk, bf16 ray transformer, card vs CPU against "
        f"the bf16 effect (CPU bf16 vs its float32 trained half): {json.dumps(dist)} "
        f"[{card}]")
    if not ok:
        raise AssertionError(f"{run}: card and CPU bf16 renders disagree beyond the bf16 "
                             f"effect: {dist}")
    return {"bf16_vs_effect": dist, "launches": launches}


def slice_phase(model, model_b, card):
    """The main path, extract_geometry_for_dataset on one full view, by
    six routes: the render-glue knobs off and on, route A (the view
    transformer), route v2 (the split-weight point head), the shipped route
    (the JAX package's extraction defaults: merged volumes, bf16 volumes
    and gather sources, fast heads; all five on the same weights, the first
    four on the exact path) and route B (model_b, the ablation without
    explicit similarity)."""
    from uforecon_tpu_torch.config import EXACT, FUSED_GLUE, Config
    from uforecon_tpu_torch.data.synthetic import dtu_scale_sample
    from uforecon_tpu_torch.ops import cuda_build

    shipped = {k: getattr(Config(), k) for k in EXACT}
    models = {"off": model, "on": model.with_knobs(**FUSED_GLUE),
              "A": model.with_knobs(fused_point_head="never"), "B": model_b,
              "v2": model.with_knobs(point_head="v2"),
              "shipped": model.with_knobs(extract_geometry=True, **shipped)}
    # route B's ray head runs at the kernel's second width
    if model_b.ray_transformer.ray_head_params().wq.shape[0] != 72:
        raise AssertionError("route B's ray-head width is not 72")
    sample = dtu_scale_sample()
    stats, launches = {}, {}
    # the packs the kernel phase built are dropped: each head builds its
    # pack once per set of weights and precision over the six views, at
    # the first view that runs it (point_head: the shared weights in
    # 3xTF32 and in bf16; ray_head: those and route B's; point_head2: the
    # shared weights)
    cuda_build.clear_pack_caches()
    depths = {}
    for route, m in models.items():
        stats[route], launches[route] = render_view(m, sample, route, card)
        depths[route] = stats[route].pop("depth")
        check_launches(route, launches[route])
    if not stats["shipped"]["merged"] or stats["shipped"]["kernel_precision"] != "fast":
        raise AssertionError(f"the shipped route resolved {stats['shipped']}")
    built = {n: sum(stats[r]["pack_builds"][n] for r in models)
             for n in pack_counters()}
    log(f"[slice] weight packs built over the six views: {built} (one per head, set "
        f"of weights and precision)")
    if built != {"point_head": 2, "ray_head": 3, "point_head2": 1}:
        raise AssertionError(f"a head rebuilt its weight pack: {built}")
    for route, m in models.items():
        stats[route]["cpu_agree"] = agree_with_cpu(m, sample, route)
    # the shipped route with point_head='v2' (fast kernels 4 and 2) by the
    # same rule
    agree_v2 = agree_with_cpu(models["shipped"].with_knobs(point_head="v2"), sample,
                              "shipped_v2")
    check_launches("shipped_v2", agree_v2["launches"])
    stats["shipped"]["cpu_agree_v2"] = agree_v2
    return models, sample, stats, launches, depths["shipped"]


def shipped_knob_runs(model_s, scene, enc, extras, card):
    """One 1024-ray chunk of the shipped route with the render-glue knobs
    on (kernels 1, 7 and 3 in fast; no volume fusion: the merged volume
    fuses by itself) and one with point_head='v2' (kernels 4 and 2 in
    fast). Returns each run's launches."""
    import torch

    from uforecon_tpu_torch.config import FUSED_GLUE

    wrappers = launch_counts()
    ray_d, near, far = chunk_args(scene, extras, 0, 1024)
    launches = {}
    for run, m in (("shipped_on", model_s.with_knobs(**FUSED_GLUE)),
                   ("shipped_v2", model_s.with_knobs(point_head="v2"))):
        for w in wrappers.values():
            w.launches = 0
        with torch.no_grad():
            out = m.render_chunk(scene, enc, ray_d, torch.Generator(device="cuda"),
                                 near_per_ray=near, far_per_ray=far)
        torch.cuda.synchronize()
        launches[run] = {k: w.launches for k, w in wrappers.items()}
        log(f"[slice] route {run}: one 1024-ray chunk of the shipped route: launches "
            f"{launches[run]} [{card}]")
        check_launches(run, launches[run])
        if not torch.isfinite(out["fine"]["depth"]).all():
            raise AssertionError(f"{run}: depth not finite")
    return launches


def gradient_phase(model_a, sample, card):
    """One backward through route A's per-point stage (the view
    transformer, whose attention backward is the tiny-attention backward
    kernel) for a 256-ray coarse chunk: the gradients of the view
    transformer's weights on the card against the same backward on the
    CPU. Returns the launches counted during the card's run."""
    import torch

    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
    from uforecon_tpu_torch.ops.sampling import sample_coarse

    scene, extras = scene_inputs_from_sample(sample, "cuda")
    with torch.no_grad():
        enc = model_a.encode(scene)
    rn, sn = 256, model_a.cfg.coarse_sample
    idx = np.random.default_rng(SEED + 1).choice(len(extras["ray_d"]), rn, replace=False)
    ray_d = torch.as_tensor(extras["ray_d"][idx], device="cuda")
    u = torch.rand((rn, sn), generator=torch.Generator(device="cuda").manual_seed(SEED),
                   device="cuda")

    def grads(m, scene, enc, ray_d, u):
        names, weights = zip(*m.ray_transformer.density_view_transformer.named_parameters())
        points, _ = sample_coarse(scene.ray_o.expand(rn, 3), ray_d, sn,
                                  scene.near.expand(rn), scene.far.expand(rn), u=u)
        with torch.enable_grad():
            pp = m._point_features(scene, enc, points)
            loss = pp["token"].square().mean() + pp["radiance"].square().mean()
            return dict(zip(names, torch.autograd.grad(loss, weights)))

    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    got = grads(model_a, scene, enc, ray_d, u)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    want = grads(copy.deepcopy(model_a).cpu(), to_cpu(scene), to_cpu(enc),
                 ray_d.cpu(), u.cpu())
    rel = {k: ((got[k].cpu() - want[k]).abs().max()
               / want[k].abs().max().clamp(min=1e-30)).item() for k in want}
    log(f"[grad] route A, {rn}-ray coarse chunk ({rn * sn} points): launches "
        f"{launches}; view-transformer weight gradients, card vs CPU, max abs "
        f"error over each weight's largest gradient: {rel} (tol "
        f"{TOL['route_grad_rel']}) [{card}]")
    check_launches("grad", launches)
    if not max(rel.values()) <= TOL["route_grad_rel"]:
        raise AssertionError(f"route A gradients disagree between card and CPU: {rel}")
    return launches


def probe_phase(card, blocks=256):
    """The row-gather benchmark's probe entry point, as a user runs it
    (``python -m uforecon_tpu_torch.script.bench_tile_gather --mode
    probe``), in this process so that its launches are counted: its JSON
    line must be well formed, its first block bit-equal and every number
    finite. Returns the launches counted during it."""
    import contextlib
    import io

    from uforecon_tpu_torch.script import bench_tile_gather

    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_tile_gather.main(["--mode", "probe", "--blocks", str(blocks)])
    launches = {k: w.launches for k, w in wrappers.items()}
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    result = json.loads(lines[-1])
    log(f"[probe] bench_tile_gather --mode probe --blocks {blocks}: {lines[-1]}; "
        f"launches {launches} [{card}]")
    check_launches("probe", launches)
    numbers = [v for v in result.values() if isinstance(v, (int, float))
               and not isinstance(v, bool)]
    if not (len(lines) == 1 and result["bit_equal_block0"] is True
            and result["rows"] == blocks * 4096
            and all(np.isfinite(v) for v in numbers)):
        raise AssertionError(f"the gather probe's line is wrong: {lines}")
    return launches


def chunk_args(scene, extras, start, rn):
    """ray_d and per-ray near/far of rays start .. start + rn, as
    SceneRenderer.render_depth_view gives them."""
    import torch

    cam_z = torch.as_tensor(extras["cam_ray_d"][start:start + rn, 2], device="cuda")
    ray_d = torch.as_tensor(extras["ray_d"][start:start + rn], device="cuda")
    return ray_d, float(scene.near) / cam_z, float(scene.far) / cam_z


def ab_phase(models, scene, enc, extras, card):
    """AB_ROUNDS rounds of full views in the order off, on, on, off, one
    encoding, warm from the slice phase's views of both routes; host clock
    ending in the depth map's host copy."""
    import torch

    from uforecon_tpu_torch.pipeline.renderer import SceneRenderer

    models = {k: models[k] for k in ("off", "on")}
    renderer = {k: SceneRenderer(m, "cuda") for k, m in models.items()}
    n_rays = extras["ray_d"].shape[0]

    def view(route):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = renderer[route].render_depth_view(scene, enc, extras, gen)
        dt = time.perf_counter() - t0
        if not np.all(np.isfinite(out["depth"])):
            raise AssertionError(f"knobs {route}: depth not finite")
        return n_rays / dt

    rates = {r: [] for r in models}
    for i in range(AB_ROUNDS):
        for route in ("off", "on", "on", "off"):
            rates[route].append(view(route))
            log(f"[ab] round {i} knobs {route}: {rates[route][-1]:.1f} rays/s; "
                f"after it sm clock, power, temperature: "
                f"{smi('clocks.sm,power.draw,temperature.gpu')}")
    summary = {r: {"median": float(np.median(v)),
                   "iqr": float(np.subtract(*np.percentile(v, [75, 25]))),
                   "n": len(v)} for r, v in rates.items()}
    won = sum(a > b for a, b in zip(rates["on"], rates["off"]))
    log(f"[ab] rays/s: {json.dumps(summary)}; on / off medians "
        f"{summary['on']['median'] / summary['off']['median']:.4f}; pairs won by "
        f"on {won} of {len(rates['on'])} [{card}]")


def cli_run(tag, run_name, base, extra, scan, n_views, wh, card, samples="64+64",
            mesh="1"):
    """``cli.run`` (``base + extra``) as a user runs it, its launches counted
    after each view's render and at its end: every kernel MUST_RUN names
    for the run launched on every view and no other, ``n_views`` views
    rendered, and the printed 'resolved' line names the path taken and
    that ``--mesh_shape`` (``mesh``, as passed) resolved to this card. Returns
    the scan's statistics (with the run's seconds and peak device memory),
    the launches up to the last view's render and those after it."""
    import contextlib
    import io

    import torch

    from uforecon_tpu_torch.cli import run
    from uforecon_tpu_torch.pipeline.renderer import SceneRenderer

    wrappers = launch_counts()
    render_depth_view = SceneRenderer.render_depth_view
    per_view = []

    def counted(self, *args, **kwargs):
        res = render_depth_view(self, *args, **kwargs)
        per_view.append({n: wr.launches for n, wr in wrappers.items()})
        return res

    for wr in wrappers.values():
        wr.launches = 0
    torch.cuda.reset_peak_memory_stats()
    SceneRenderer.render_depth_view = counted
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            stats = run.main(base + extra)[scan]
    finally:
        SceneRenderer.render_depth_view = render_depth_view
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = {n: wr.launches for n, wr in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(per_view) != n_views:
        raise AssertionError(f"{run_name}: cli.run rendered {len(per_view)} views, "
                             f"not {n_views}")
    check_launches(run_name, per_view[-1])
    prev = {n: 0 for n in wrappers}
    for i, snap in enumerate(per_view):
        idle = [n for n in MUST_RUN[run_name] if snap[n] <= prev[n]]
        if idle:
            raise AssertionError(f"{run_name} view {i}: kernels {idle} not launched")
        prev = snap
    path = "merged" if stats["merged"] else "per-stage"
    resolved = (f"resolved: {path} volumes, kernel_precision {stats['kernel_precision']}, ",
                f"--mesh_shape {mesh} -> 1 card")
    if not any(line.startswith(resolved[0]) and line.endswith(resolved[1])
               for line in printed.getvalue().splitlines()):
        raise AssertionError(f"{run_name}: cli.run printed no '{' ... '.join(resolved)}' line")
    log(f"[{tag}] cli.run {' '.join(extra) or 'at its defaults'}, {n_views} views "
        f"{wh[0]}x{wh[1]}, {samples} samples, seeded weights, {path} volumes, "
        f"kernel_precision {stats['kernel_precision']}: {stats['rays_per_sec']:.1f} "
        f"rays/s (the JAX statistic: all rays over the time after view 0's render), "
        f"encode {stats['encode_s']:.3f} s, render {stats['render_s']:.3f} s, "
        f"{seconds:.1f} s in all, peak {peak:.2f} GiB; launches per view "
        f"{[{n: v[n] for n in MUST_RUN[run_name]} for v in per_view]}; printed "
        f"{printed.getvalue().strip().splitlines()} [{card}]")
    return ({**stats, "seconds": seconds, "peak_gib": peak}, per_view[-1],
            {n: total[n] - per_view[-1][n] for n in total})


def pipeline_phase(model, card):
    """The shipped DTU evaluation flow through the port's CLIs, as a user
    runs it: the fixture at 1600x1200 (``script/make_dtu_fixture.py``),
    ``cli.run`` at full width on this model's weights (a state-dict file,
    ``--load_ckpt``), which must launch kernels 1 and 2 on every view and
    write the depth layout; then, on analytic depth maps of the fixture's
    sphere (random weights render no surface), ``cli.tsdf_fusion`` on the
    card at both voxel sizes with the volume held against the same
    integration on the CPU, ``cli.depth_fusion``, ``cli.clean_mesh`` and
    ``cli.dtu_eval`` against points on the sphere, whose accuracy and
    completeness must be within one voxel. Returns the launches counted
    during ``cli.run``."""
    import contextlib
    import io

    import torch

    from uforecon_tpu_torch.cli import clean_mesh, depth_fusion, dtu_eval, tsdf_fusion
    from uforecon_tpu_torch.data.io import write_ply
    from uforecon_tpu_torch.fusion.tsdf import TSDFVolume, scan_bounds, scan_entries
    from uforecon_tpu_torch.script import make_dtu_fixture as fixture

    w, h = PIPELINE_WH
    views = [str(v) for v in PIPELINE_VIEWS]
    times = {}

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root, out, ana, gt = (os.path.join(tmp, d) for d in ("fixture", "out", "sphere", "gt"))
        with contextlib.redirect_stdout(io.StringIO()):
            timed("fixture_s", fixture.main, [root, "--views", *views])
        ckpt = os.path.join(tmp, "weights.pt")
        torch.save(model.state_dict(), ckpt)

        base = ["--extract_geometry", "--set", "0", "--volume_type", "correlation",
                "--volume_reso", "96", "--depth_pos_encoding", "--mvs_depth_guide", "1",
                "--explicit_similarity", "--test_n_view", "3", "--test_ray_num", "800",
                "--test_ref_view", *views, "--root_dir", root, "--test_scan", "scan24",
                "--load_ckpt", ckpt]
        # at its defaults: the JAX package's extraction defaults
        shipped, launches, _ = cli_run("pipeline", "pipeline", base + ["--out_dir", out],
                                       [], "scan24", 3, (w, h), card)
        times["extract_pipeline_s"] = shipped["seconds"]
        if not shipped["merged"] or shipped["kernel_precision"] != "fast":
            raise AssertionError(f"cli.run at its defaults resolved {shipped}")
        # the cards phase's (a): --mesh_shape 2 resolves to this one card
        # (cli_run checks the printed line) and writes the same depth files
        t_mesh = time.perf_counter()
        out_mesh = os.path.join(tmp, "out_mesh2")
        _, launches_mesh, _ = cli_run("cards", "pipeline_mesh2", base + ["--out_dir", out_mesh],
                                      ["--mesh_shape", "2"], "scan24", 3, (w, h), card,
                                      mesh="2")
        for i in range(3):
            got, want = (np.load(os.path.join(d, "depth", "scan24", f"{i:08d}.npy"),
                                 allow_pickle=True).item()["depth"] for d in (out_mesh, out))
            if not np.array_equal(got, want):
                raise AssertionError(f"cli.run --mesh_shape 2 view {i}: depth differs from "
                                     f"--mesh_shape 1's (max {np.abs(got - want).max()})")
        times["cards_cli_s"] = time.perf_counter() - t_mesh
        log(f"[cards] (a) cli.run --mesh_shape 2 on this one card: resolved to 1 card, its "
            f"3 depth maps equal --mesh_shape 1's bit for bit [{card}]")
        exact, launches_exact, _ = cli_run(
            "pipeline", "pipeline_exact", base + ["--out_dir", os.path.join(tmp, "out_exact")],
            ["--volume_merge", "never", "--volume_dtype", "float32",
             "--image_gather_dtype", "float32", "--kernel_precision", "highest"],
            "scan24", 3, (w, h), card)
        times["extract_pipeline_exact_s"] = exact["seconds"]
        if exact["merged"] or exact["kernel_precision"] != "highest":
            raise AssertionError(f"cli.run with the exact flags resolved {exact}")

        gt_points = []
        for i in range(3):
            e = np.load(os.path.join(out, "depth", "scan24", f"{i:08d}.npy"),
                        allow_pickle=True).item()
            if set(e) != {"depth", "extrinsic", "intrinsic"} or e["depth"].shape != (h, w) \
                    or not np.all(np.isfinite(e["depth"])):
                raise AssertionError(f"view {i}: depth entry {sorted(e)} "
                                     f"{np.shape(e['depth'])} is not the extract layout")
            e["depth"] = fixture.sphere_depth(e["extrinsic"], e["intrinsic"], w, h)
            gt_points.append(fixture.sphere_points(e["extrinsic"], e["intrinsic"], w, h))
            os.makedirs(os.path.join(ana, "depth", "scan24"), exist_ok=True)
            np.save(os.path.join(ana, "depth", "scan24", f"{i:08d}.npy"), e)

        # the shipped voxel size last: its mesh is the one cleaned and scored
        entries = scan_entries(ana, "scan24", 3)
        bounds = scan_bounds(entries)
        for vs in PIPELINE_VOXELS[::-1]:
            vols, ms = {}, []
            for dev in ("cuda", "cpu"):
                vol = TSDFVolume(bounds, vs, device=dev)
                for _, e in entries:
                    c2w = np.linalg.inv(e["extrinsic"])
                    timed("integrate", vol.integrate, e["depth"], e["intrinsic"], c2w)
                    if dev == "cuda":
                        ms.append(times["integrate"] * 1e3)
                vols[dev] = vol
            (gt_, gw), (ct, cw) = vols["cuda"].get_volume(), vols["cpu"].get_volume()
            close = (np.abs(gt_ - ct) <= TOL["tsdf"]) & (np.abs(gw - cw) <= TOL["tsdf"])
            verts, faces, _ = timed("marching_s", vols["cuda"].get_mesh)
            timed("tsdf_cli_s", tsdf_fusion.main, [
                "--out_dir", ana, "--n_view", "3", "--voxel_size", str(vs),
                "--test_scan", "scan24"])
            log(f"[pipeline] TSDF at voxel {vs} mm: {gt_.size} voxels "
                f"{tuple(gt_.shape)}, integrate on the card {np.round(ms, 3).tolist()} "
                f"ms per view; card vs CPU: share of voxels within {TOL['tsdf']} "
                f"{close.mean():.7f}, exactly equal {np.mean((gt_ == ct) & (gw == cw)):.7f}; "
                f"marching cubes {times['marching_s']:.2f} s ({len(verts)} vertices, "
                f"{len(faces)} faces); cli.tsdf_fusion {times['tsdf_cli_s']:.2f} s [{card}]")
            if close.mean() < TOL["tsdf_share"]:
                raise AssertionError(f"card and CPU TSDF volumes disagree at voxel {vs}")
            del vols

        timed("depth_fusion_s", depth_fusion.main,
              ["--out_dir", ana, "--n_view", "3", "--test_scan", "scan24"])
        timed("clean_s", clean_mesh.main, [
            "--out_dir", ana, "--root_dir", root, "--n_view", "3",
            "--test_ref_view", *views, "--test_scan", "scan24", "--ray_stride", "4"])
        for f in ("mesh/scan24.ply", "pcd/scan24.ply", "pcd_fusion/scan24.ply",
                  "mesh/final/scan24.ply"):
            if not os.path.exists(os.path.join(ana, f)):
                raise AssertionError(f"the pipeline wrote no {f}")
        os.makedirs(os.path.join(gt, "Points", "stl"))
        write_ply(os.path.join(gt, "Points", "stl", "stl024_total.ply"),
                  np.concatenate(gt_points))
        scores = timed("eval_s", dtu_eval.main, [
            "--mesh_dir", os.path.join(ana, "mesh", "final"), "--dataset_dir", gt,
            "--log_dir", ana, "--scans", "24"])
    if len(scores) != 1:
        raise AssertionError(f"dtu_eval scored {len(scores)} meshes, not 1")
    acc, comp = scores[0][1]["acc"], scores[0][1]["comp"]
    voxel = PIPELINE_VOXELS[0]
    log(f"[pipeline] cleaned sphere mesh (voxel {voxel} mm) against the sphere: "
        f"accuracy {acc:.4f} mm, completeness {comp:.4f} mm (limit: one voxel, "
        f"{voxel} mm); seconds: " + json.dumps(
            {k: round(v, 3) for k, v in times.items() if k != "integrate"})
        + f" [{card}]")
    if not (np.isfinite(acc) and np.isfinite(comp) and acc < voxel and comp < voxel):
        raise AssertionError(f"the sphere mesh scores {acc}, {comp} mm")
    log(f"[pipeline] cli.run rays/s: at its defaults {shipped['rays_per_sec']:.1f}, with "
        f"the exact flags {exact['rays_per_sec']:.1f}; the sphere (analytic depth maps) "
        f"at accuracy {acc:.4f} mm, completeness {comp:.4f} mm [{card}]")
    return ({"pipeline": launches, "pipeline_exact": launches_exact,
             "pipeline_mesh2": launches_mesh}, times["cards_cli_s"])


def general_phase(model, card):
    """The custom-capture flow (GeneralFit, ``--test_general``) through the
    port's CLIs, as a user runs it on a BlendedMVS-style scan: the port's
    fixture (``script/make_general_fixture.py``: 5 views of a sphere at
    768x576, baseline JPEGs and masks, written and read without OpenCV)
    built here, and the host time of ``read_jpeg`` on one of its images;
    ``cli.run --extract_geometry --test_general --dataset blendedmvs
    --use_mask`` at full width on this model's weights (a state-dict file)
    at 3 views at its defaults with ``--extract_similarity --sim_reso 128``
    (fast kernels 1 and 2 on every view; then kernel 7 alone, 32 launches
    for the field), with the exact flags (3xTF32 kernels 1 and 2), and at
    5 views at its defaults (the JAX guard's 7,077,888,000 bytes: per-stage
    volumes; peak memory); then one 65,536-point chunk of the field on the
    card against the CPU's on the card's encoding (``cosine`` tolerance,
    the same -1 cells), the first 256 rays of the scene on the card against
    the CPU (``agree_with_cpu``), and ``cli.tsdf_fusion --dataset general``
    on the 3-view depth maps, which must write the mesh. Returns the
    launches counted per run and the phase's numbers."""
    import contextlib
    import io

    import torch

    from uforecon_tpu_torch.cli import tsdf_fusion
    from uforecon_tpu_torch.config import EXACT, Config
    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
    from uforecon_tpu_torch.data.general_fit import GeneralFit
    from uforecon_tpu_torch.data.image import read_jpeg
    from uforecon_tpu_torch.pipeline.extract import similarity_field_chunk, similarity_grid
    from uforecon_tpu_torch.script import make_general_fixture

    w, h = GENERAL_WH
    scan = GENERAL_SCAN
    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "general")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            make_general_fixture.main([root, scan])
        out["fixture_s"] = time.perf_counter() - t0
        image = os.path.join(root, scan, "blended_images", "00000000_masked.jpg")
        t0 = time.perf_counter()
        pixels = read_jpeg(image)
        out["read_jpeg_s"] = time.perf_counter() - t0
        log(f"[general] fixture (5 views {w}x{h}, JPEG images and masks) written in "
            f"{out['fixture_s']:.2f} s; read_jpeg of one {pixels.shape[1]}x"
            f"{pixels.shape[0]} quality-95 image: {out['read_jpeg_s']:.3f} s on the host "
            f"({os.cpu_count()} cores)")
        ckpt = os.path.join(tmp, "weights.pt")
        torch.save(model.state_dict(), ckpt)

        def general_run(run_name, n_view, out_dir, extra):
            """cli.run --test_general, each view's depth map checked."""
            base = ["--extract_geometry", "--test_general", "--dataset", "blendedmvs",
                    "--use_mask", "--volume_type", "correlation", "--volume_reso", "96",
                    "--depth_pos_encoding", "--mvs_depth_guide", "1",
                    "--explicit_similarity", "--test_n_view", str(n_view),
                    "--test_ref_view", *map(str, range(n_view)), "--test_ray_num", "800",
                    "--root_dir", root, "--out_dir", out_dir, "--test_scan", scan,
                    "--load_ckpt", ckpt]
            stats, rendered, after = cli_run("general", run_name, base, extra, scan,
                                             n_view, (w, h), card)
            for i in range(n_view):
                e = np.load(os.path.join(out_dir, "depth", scan, f"refview{i}.npy"),
                            allow_pickle=True).item()
                if e["depth"].shape != (h, w) or not np.all(np.isfinite(e["depth"])):
                    raise AssertionError(f"{run_name} refview{i}: depth {e['depth'].shape}")
            out[run_name] = {k: v for k, v in stats.items() if k != "rays"}
            launches[run_name] = rendered
            return stats, after

        out3 = os.path.join(tmp, "out3")
        shipped, after = general_run("general", 3, out3, [
            "--extract_similarity", "--sim_reso", str(GENERAL_SIM_RESO)])
        if not shipped["merged"] or shipped["kernel_precision"] != "fast":
            raise AssertionError(f"cli.run --test_general at its defaults resolved {shipped}")
        # the similarity field: kernel 7 alone, one launch per 65,536 points
        launches["general_sim"] = after
        check_launches("general_sim", after)
        if after["grouped_cosine"] != GENERAL_SIM_CHUNKS:
            raise AssertionError(f"the field launched kernel 7 {after['grouped_cosine']} "
                                 f"times, not {GENERAL_SIM_CHUNKS}")
        ply = os.path.join(out3, "similarity", f"{scan}.ply")
        if not os.path.exists(ply):
            raise AssertionError(f"--extract_similarity wrote no {ply}")
        log(f"[general] similarity field {GENERAL_SIM_RESO}^3: {shipped['similarity_s']:.3f} "
            f"s (encode and {GENERAL_SIM_CHUNKS} chunks of 65,536 points), kernel 7 "
            f"launches {after['grouped_cosine']}, mesh {ply} [{card}]")
        exact, _ = general_run("general_exact", 3, os.path.join(tmp, "out_exact"), [
            "--volume_merge", "never", "--volume_dtype", "float32",
            "--image_gather_dtype", "float32", "--kernel_precision", "highest"])
        if exact["merged"] or exact["kernel_precision"] != "highest":
            raise AssertionError(f"cli.run --test_general exact resolved {exact}")
        five, _ = general_run("general_5", 5, os.path.join(tmp, "out5"), [])
        if five["merged"] or five["kernel_precision"] != "fast":
            raise AssertionError(f"cli.run --test_general at 5 views resolved {five}; the "
                                 "JAX guard gives per-stage volumes there")

        # one chunk of the field (the grid's middle one), card vs CPU on the
        # card's encoding, and the scene's first rays card vs CPU
        model_s = model.with_knobs(extract_geometry=True,
                                   **{k: getattr(Config(), k) for k in EXACT})
        ds = GeneralFit(root, scan, n_views=3, test_ref_view=[0, 1, 2],
                        dataset="blendedmvs", use_mask=True)
        sample = ds[0]
        scene, _ = scene_inputs_from_sample(sample, "cuda")
        grid = similarity_grid(GENERAL_SIM_RESO)
        mid = GENERAL_SIM_CHUNKS // 2 * 65536
        pts = torch.as_tensor(grid[mid:mid + 65536])
        with torch.no_grad():
            enc = model_s.encode(scene)
            card_vals = similarity_field_chunk(scene, enc, pts.cuda()).cpu().numpy()
            cpu_vals = similarity_field_chunk(to_cpu(scene), to_cpu(enc), pts).numpy()
        seen = card_vals != -1.0
        err = float(np.abs(card_vals - cpu_vals).max())
        log(f"[general] field chunk {mid // 65536} (65,536 points, {seen.mean():.4f} seen "
            f"by every view): card vs CPU max abs err {err:.3e} (tol {TOL['cosine']}), "
            f"-1 cells equal {np.array_equal(seen, cpu_vals != -1.0)} [{card}]")
        if not err <= TOL["cosine"] or not np.array_equal(seen, cpu_vals != -1.0) \
                or not seen.any():
            raise AssertionError("the card's similarity field disagrees with the CPU's")
        del enc, scene
        out["field_chunk"] = {"max_abs_err": err, "seen_share": float(seen.mean())}
        out["agree"] = agree_with_cpu(model_s, sample, "general")

        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            tsdf_fusion.main(["--out_dir", out3, "--n_view", "3", "--voxel_size", "4",
                              "--test_scan", scan, "--dataset", "general"])
        out["tsdf_s"] = time.perf_counter() - t0
        mesh = os.path.join(out3, "mesh", f"{scan}.ply")
        if not os.path.exists(mesh):
            raise AssertionError(f"cli.tsdf_fusion --dataset general wrote no {mesh}")
        log(f"[general] cli.tsdf_fusion --dataset general on the 3-view depth maps: "
            f"{out['tsdf_s']:.2f} s, {mesh} ({os.path.getsize(mesh)} bytes) [{card}]")
    torch.cuda.empty_cache()
    return launches, out


def configs_phase(card):
    """The JAX package's other model configurations (CONFIGS) on the card.
    Each, a model of its own with seeded weights on the exact path
    (``config.EXACT``), renders one CONFIG_CHUNK-ray chunk of the slice's
    scene, its launches counted (the view transformer's tiny attention and
    the ray head at the configuration's width; the guided feature grid the
    point head at tokens of 72; the default model at 128 + 128 samples the
    point head, and the ray head streamed at SN 256); then
    the same chunk with the same draws on the card's encoding through the
    plain versions on the CPU (rays within 2e-4 on >= 99 %). Then
    ``cli.run --use_dir_srdf --test_sample_coarse 128 --test_sample_fine
    128`` at its defaults on the DTU sphere fixture at 800x640: ray-head
    width 112 at SN 128 and 256 in fast, its rays/s and peak memory.
    Returns the launches of each run and the phase's figures."""
    import contextlib
    import io

    import torch

    from uforecon_tpu_torch.config import EXACT, Config
    from uforecon_tpu_torch.convert import init_weights
    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
    from uforecon_tpu_torch.data.synthetic import dtu_scale_sample
    from uforecon_tpu_torch.models.uforecon import UFORecon
    from uforecon_tpu_torch.script import make_dtu_fixture as fixture

    sample = dtu_scale_sample()
    wrappers = launch_counts()
    launches, figures = {}, {}
    rn = CONFIG_CHUNK
    for name, flags in CONFIGS.items():
        model = UFORecon(Config(**EXACT, **flags))
        init_weights(model, SEED)
        model.to("cuda").requires_grad_(False)
        n_coarse, n_fine = model.cfg.samples
        scene, extras = scene_inputs_from_sample(sample, "cuda")
        idx = np.random.default_rng(SEED).choice(len(extras["ray_d"]), rn, replace=False)
        ray_d = torch.as_tensor(extras["ray_d"][idx], device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        u_c = torch.rand((rn, n_coarse), generator=gen, device="cuda")
        u_f = torch.rand((rn, n_fine), generator=gen, device="cuda")
        with torch.no_grad():
            enc = model.encode(scene)
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.reset_peak_memory_stats()
            out = model.render_chunk(scene, enc, ray_d, u_coarse=u_c, u_fine=u_f)
            torch.cuda.synchronize()
            run = f"config_{name}"
            launches[run] = {k: w.launches for k, w in wrappers.items()}
            check_launches(run, launches[run])
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            t0 = time.perf_counter()
            model.render_chunk(scene, enc, ray_d, u_coarse=u_c, u_fine=u_f)
            torch.cuda.synchronize()
            chunk_ms = (time.perf_counter() - t0) * 1e3
            out_cpu = copy.deepcopy(model).cpu().render_chunk(
                to_cpu(scene), to_cpu(enc), ray_d.cpu(), u_coarse=u_c.cpu(),
                u_fine=u_f.cpu())
        agree = {}
        for phase in ("coarse", "fine"):
            for key in ("depth", "rgb"):
                a = out[phase][key].cpu().numpy()
                if not np.all(np.isfinite(a)):
                    raise AssertionError(f"config {name}: non-finite {phase} {key}")
                ok = np.isclose(a, out_cpu[phase][key].numpy(), rtol=2e-4,
                                atol=2e-4).reshape(rn, -1).all(axis=1)
                agree[f"{phase}_{key}"] = float(ok.mean())
        rt = model.ray_transformer
        figures[name] = {"d_view": rt.d_view, "ray_head_width": rt.d_view + 8,
                         "samples": [n_coarse, n_fine], "chunk_ms": chunk_ms,
                         "peak_gib": peak, "cpu_agree": agree,
                         "volume": ("feature grid" if enc.fea_grid is not None else
                                    "per-stage" if enc.volumes else "none")}
        log(f"[configs] {name} {flags}: d_view {rt.d_view}, ray head width "
            f"{rt.d_view + 8}, {n_coarse}+{n_fine} samples, {figures[name]['volume']} "
            f"volume; one {rn}-ray chunk {chunk_ms:.2f} ms (host clock, warm), peak "
            f"{peak:.2f} GiB; launches {launches[run]}; card vs CPU share of rays "
            f"within rtol=atol=2e-4 {agree} [{card}]")
        if min(agree.values()) < 0.99:
            raise AssertionError(f"config {name}: card and CPU renders disagree: {agree}")
        del model, scene, enc, out, out_cpu
        torch.cuda.empty_cache()

    # the two bf16 policies at the JAX extraction defaults: a chunk each,
    # card against CPU
    for name, flags in (("mixed", dict(encoder_dtype="bfloat16")),
                        ("bf16", dict(compute_dtype="bfloat16"))):
        model = UFORecon(Config(extract_geometry=True, **flags))
        init_weights(model, SEED)
        model.to("cuda").requires_grad_(False)
        run = f"config_{name}"
        t0 = time.perf_counter()
        if name == "mixed":
            agree = agree_with_cpu(model, sample, run, rn=rn, tag="configs")
        else:
            agree = bf16_chunk_card_vs_cpu(model, sample, run, rn, card)
        launches[run] = agree.pop("launches")
        check_launches(run, launches[run])
        figures[name] = {"flags": flags, "cpu_agree": agree,
                         "seconds": time.perf_counter() - t0}
        log(f"[configs] {name} {flags} at the extraction defaults: one {rn}-ray chunk, "
            f"launches { {k: v for k, v in launches[run].items() if v} } [{card}]")
        del model
        torch.cuda.empty_cache()

    # the hardest ray-head shape a flag set gives, through the CLI at its
    # defaults: width 112, 128 + 128 samples
    views = [str(v) for v in PIPELINE_VIEWS]
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "fixture")
        with contextlib.redirect_stdout(io.StringIO()):
            fixture.main([root, "--views", *views])
        base = ["--extract_geometry", "--set", "0", "--depth_pos_encoding",
                "--explicit_similarity", "--test_n_view", "3", "--test_ref_view", *views,
                "--root_dir", root, "--test_scan", "scan24", "--seed", str(SEED),
                "--out_dir", os.path.join(tmp, "out")]
        extra = ["--use_dir_srdf", "--test_sample_coarse", "128", "--test_sample_fine", "128"]
        stats, launches["config_cli"], _ = cli_run("configs", "config_cli", base, extra,
                                                   "scan24", 3, PIPELINE_WH, card,
                                                   samples="128+128")
    if not stats["merged"] or stats["kernel_precision"] != "fast":
        raise AssertionError(f"cli.run --use_dir_srdf resolved {stats}")
    figures["cli_dir_srdf_128"] = {k: stats[k] for k in (
        "rays_per_sec", "encode_s", "render_s", "seconds", "peak_gib")}
    return launches, figures


def views_phase(model, card, before_chunks):
    """DTU's evaluation set 1 (11 views) through the port: the fixture's 11
    views at the DTU render size (``script/make_dtu_fixture.py``,
    each id its own camera); ``cli.run --extract_geometry --set 1`` at its
    defaults at 11 views and at 4 (the guard's per-stage volumes from 4
    views on), which must launch fast kernels 1 and 2 on every view; then,
    after before_chunks() (which main uses to log the scans' seconds), one
    1024-ray chunk of the first view at 6, 8 and 11 views on the card
    against the CPU (``agree_with_cpu``), on the exact path (kernels 1 and 2
    in 3xTF32: >= 0.99 of the rays within 2e-4) and at the JAX extraction
    defaults (fast kernels 1 and 2; per-stage volumes, by the JAX guard:
    held by the bf16 effect's median, max and per-ray rule, and the card's
    fine pass on the CPU's fine samples by the per-ray rule:
    ``agree_with_cpu``'s ``staged``), with the
    launches of the card's chunk; and one 1024-ray chunk at 12 views (set
    1's ids and one more, VIEWS_CHUNK: past the 11 the kernels compile in)
    at the extraction defaults by the same rule. Returns the launches of
    the runs and their figures."""
    import contextlib
    import io

    import torch

    from uforecon_tpu_torch.config import EXACT, Config
    from uforecon_tpu_torch.data.dtu_test import SET1_VIEW_LIST, DtuFitSparse
    from uforecon_tpu_torch.script import make_dtu_fixture as fixture

    w, h = PIPELINE_WH
    shipped = model.with_knobs(extract_geometry=True,
                               **{k: getattr(Config(), k) for k in EXACT})
    launches, figures = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "fixture")
        t0 = time.perf_counter()
        nv_past, rn_past, extra_id = VIEWS_CHUNK
        with contextlib.redirect_stdout(io.StringIO()):
            fixture.main([root, "--views", *map(str, SET1_VIEW_LIST), str(extra_id), "--wh",
                          str(w), str(h)])
        log(f"[views] fixture: the 11 views of DTU's evaluation set 1 and view "
            f"{extra_id} at {w}x{h} in {time.perf_counter() - t0:.1f} s")
        ckpt = os.path.join(tmp, "weights.pt")
        torch.save(model.state_dict(), ckpt)
        for nv in VIEWS_CLI:
            run = "views_cli" if nv == VIEWS_CLI[0] else f"views_cli_{nv}"
            # the 11-view scan at a quarter of the rays (VIEWS_CLI_WH)
            w_r, h_r = VIEWS_CLI_WH.get(nv, (w, h))
            base = ["--img_wh", str(w_r), str(h_r),
                    "--extract_geometry", "--set", "1", "--volume_type", "correlation",
                    "--volume_reso", "96", "--depth_pos_encoding", "--mvs_depth_guide", "1",
                    "--explicit_similarity", "--test_n_view", str(nv), "--test_ray_num",
                    "800", "--root_dir", root, "--test_scan", "scan24", "--load_ckpt", ckpt,
                    "--out_dir", os.path.join(tmp, f"out{nv}")]
            stats, launches[run], _ = cli_run("views", run, base, [], "scan24", nv,
                                              (w_r, h_r), card)
            if stats["merged"] or stats["kernel_precision"] != "fast":
                raise AssertionError(f"cli.run --set 1 at {nv} views resolved {stats}: the "
                                     "JAX guard keeps per-stage volumes above 3 views")
            for i in range(nv):
                e = np.load(os.path.join(tmp, f"out{nv}", "depth", "scan24", f"{i:08d}.npy"),
                            allow_pickle=True).item()
                if e["depth"].shape != (h_r, w_r) or not np.all(np.isfinite(e["depth"])):
                    raise AssertionError(f"cli.run --set 1 at {nv} views: view {i}'s depth "
                                         "map is not finite at the render size")
            figures[run] = {k: stats[k] for k in ("rays_per_sec", "encode_s", "render_s",
                                                  "seconds", "peak_gib", "merged",
                                                  "kernel_precision")}
            figures[run]["point_head_fast_per_view"] = launches[run]["point_head_fast"] / nv
            figures[run]["ray_head_fast_per_view"] = launches[run]["ray_head_fast"] / nv

        before_chunks()
        # set 1's chunks at VIEWS_NV, then one chunk past the compiled-in
        # counts (set 1's 11 ids and one more: the streamed kernel 1) at the
        # extraction defaults
        chunks = [(nv, DtuFitSparse(root, "scan24", n_views=nv, set=1, img_wh=(w, h)),
                   (("exact", CONFIG_CHUNK), ("shipped", CONFIG_CHUNK))) for nv in VIEWS_NV]
        chunks.append((nv_past, DtuFitSparse(root, "scan24", n_views=nv_past, set=0,
                                             test_view_pair=[*SET1_VIEW_LIST, extra_id],
                                             img_wh=(w, h)), (("shipped", rn_past),)))
        for nv, data, routes in chunks:
            sample = data[0]
            for route, rn in routes:
                m = {"exact": model, "shipped": shipped}[route]
                run = f"views_{route}_{nv}"
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                agree = agree_with_cpu(m, sample, run, rn=rn, tag="views", staged=True)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                launches[run] = agree.pop("launches")
                check_launches(run, launches[run])
                figures[run] = {"cpu_agree": agree, "peak_gib": peak,
                                "seconds": time.perf_counter() - t0}
                log(f"[views] {run}: {nv} views, one {rn}-ray chunk: launches "
                    f"{ {k: v for k, v in launches[run].items() if v} }, peak {peak:.2f} "
                    f"GiB (encode, chunk), {figures[run]['seconds']:.1f} s with the CPU's "
                    f"render [{card}]")
            del sample, data
    log("[views] " + json.dumps(figures) + f" [{card}]")
    return launches, figures


def step_profile(cfg, model, state, scene, batch, gen):
    """One training step under torch.profiler: its wall ms (unprofiled, the
    same step's shapes), its device ms and the device's busy share, the
    host and device spans of its forward's encode and render (the rest is
    the loss and the backward), and the operations with the most device
    time. The gradients are dropped: no update."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from uforecon_tpu_torch.pipeline import trainer

    def step():
        with record_function("train_forward_encode"):
            enc = model.encode(scene)
        with record_function("train_forward_render"):
            out = model.render_chunk(scene, enc, batch[0], gen)
            loss, _ = trainer.render_losses(cfg, out, batch[1], batch[2], scene.near,
                                            scene.far)
        loss.backward()
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    step()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
    labels = ("train_forward_encode", "train_forward_render")
    # the labels' ranges appear on both timelines; they are spans, not work
    dev = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and e.name not in labels]
    if not dev:
        raise AssertionError("the profiler recorded no device operation")
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    span = {(e.name, e.device_type == DeviceType.CUDA): e.time_range.elapsed_us() / 1e3
            for e in prof.events() if e.name in labels}
    busy = sum(by_name.values())
    return {"wall_ms": wall_ms, "device_ms": busy, "device_busy_share": busy / wall_ms,
            "device_ops": len(dev),
            "host_ms": {n: span.get((n, False)) for n in labels},
            "device_span_ms": {n: span.get((n, True)) for n in labels},
            "top_ms": {k[:90]: round(v, 3) for k, v in by_name.most_common(12)}}


def training_steps(cfg, model, state, sample, run, steps, card):
    """``steps`` timed 1024-ray training steps of ``model`` (a route of
    state's model) on the card, after one untimed warm-up step. After each
    step's forward and backward, before its update: kernel 1 at the
    current weights against its plain version on fresh inputs (those
    launches and any pack build are not counted), which must reuse the
    pack the step built (the stale-pack guard). Returns the run's
    launches, per-step times, builds and launches, and the peak memory."""
    import torch

    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
    from uforecon_tpu_torch.ops import fused_point_head as fph
    from uforecon_tpu_torch.pipeline import trainer
    from uforecon_tpu_torch.pipeline.fit import _gather_ray_batch

    scene, extras = scene_inputs_from_sample(sample, "cuda")
    h, w = extras["hw"]
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gen_in = torch.Generator(device="cuda").manual_seed(SEED + 3)
    wrappers, packs = launch_counts(), pack_counters()
    nv = scene.source_imgs.shape[0]

    def rays():
        idx = rng.permutation(h * w)[:cfg.train_ray_num]
        return [torch.as_tensor(a, device="cuda") for a in _gather_ray_batch(extras, idx)]

    def pack_check():
        saved = ({n: wr.launches for n, wr in wrappers.items()},
                 {n: wr.pack_builds for n, wr in packs.items()})
        n = 4096
        mask = (torch.rand((nv, n), generator=gen_in, device="cuda") > 0.3).float()
        inp = fph.PointHeadInputs(
            img_feat=torch.randn((nv, n, 32), generator=gen_in, device="cuda"),
            vol_feat=torch.randn((n, 24), generator=gen_in, device="cuda"),
            sim_feat=torch.rand((n, 8), generator=gen_in, device="cuda") * 2 - 1,
            depth_dist=0.3 * torch.randn((nv, n), generator=gen_in, device="cuda"),
            dir_rel=0.1 * torch.randn((nv, n, 3), generator=gen_in, device="cuda"),
            rgb=torch.rand((nv, n, 3), generator=gen_in, device="cuda"), mask=mask)
        params = model.ray_transformer.point_head_params()
        with torch.no_grad():
            got = fph.point_head(inp, params)
            want = fph.point_head_reference(inp, params)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        rebuilt = fph.point_head.pack_builds - saved[1]["point_head"]
        for nm, wr in wrappers.items():
            wr.launches = saved[0][nm]
        for nm, wr in packs.items():
            wr.pack_builds = saved[1][nm]
        return err, rebuilt

    trainer.grad_step(cfg, model, scene, *rays(), gen)       # warm-up
    trainer.apply_step(state.optimizer, 1)
    torch.cuda.synchronize()
    for wr in wrappers.values():
        wr.launches = 0
    for wr in packs.values():
        wr.pack_builds = 0
    torch.cuda.reset_peak_memory_stats()
    times, per_step, builds, checks, losses = [], [], [], [], []
    prev_l = {n: 0 for n in wrappers}
    prev_b = {n: 0 for n in packs}
    for _ in range(steps):
        batch = rays()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = trainer.grad_step(cfg, model, scene, *batch, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if run == "train":
            checks.append(pack_check())
        t2 = time.perf_counter()
        trainer.apply_step(state.optimizer, 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t2 + t1 - t0)
        losses.append(float(logs["train/loss_all"]))
        now = {n: wr.launches for n, wr in wrappers.items()}
        per_step.append({n: now[n] - prev_l[n] for n in MUST_RUN[run]})
        prev_l = now
        nb = {n: wr.pack_builds for n, wr in packs.items()}
        builds.append({n: nb[n] - prev_b[n] for n in packs})
        prev_b = nb
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {n: wr.launches for n, wr in wrappers.items()}
    prof = step_profile(cfg, model, state, scene, rays(), gen) if run == "train" else None
    for n, wr in wrappers.items():
        wr.launches = launches[n]
    log(f"[train] route {run}: {steps} steps of {cfg.train_ray_num} rays, {nv} source "
        f"views {w}x{h}, {cfg.coarse_sample}+{cfg.fine_sample} samples: s/step "
        f"{np.round(times, 4).tolist()} (median {np.median(times):.4f}), peak "
        f"{peak:.2f} GiB, loss {np.round(losses, 5).tolist()}; launches per step "
        f"{per_step}; weight packs built per step {builds} [{card}]")
    check_launches(run, launches)
    for i, step in enumerate(per_step):
        idle = [n for n, c in step.items() if c < 1]
        if idle:
            raise AssertionError(f"{run} step {i}: kernels {idle} not launched")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{run}: loss not finite: {losses}")
    result = {"s_per_step": times, "peak_gib": peak, "launches_per_step": per_step,
              "pack_builds_per_step": builds, "losses": losses}
    if prof is not None:
        log(f"[train] route {run}: one more step under torch.profiler: " + json.dumps(prof)
            + f" [{card}]")
        result["profile"] = prof
    if run == "train":
        log(f"[train] stale-pack guard: after each step, kernel 1 at the weights the "
            f"step used vs its plain version, max abs error "
            f"{[f'{e:.3e}' for e, _ in checks]} (tol {TOL['token']}), packs built by "
            f"the check {[b for _, b in checks]} (must be 0: the step built them)")
        if any(b["point_head"] != 1 or b["ray_head"] != 1 for b in builds):
            raise AssertionError(f"the heads did not build their packs once a step: {builds}")
        if any(e > TOL["token"] or b != 0 for e, b in checks):
            raise AssertionError(f"kernel 1 used a stale pack or disagrees: {checks}")
        result["pack_check_err"] = [e for e, _ in checks]
    return launches, result


def coarse_step_card_vs_cpu(cfg, model, sample, rn, tag, card, reference=None,
                            spread=False):
    """One coarse rn-ray gradient step on the card against the same step on
    the CPU, both fed the card's matcher outputs (frozen, without
    gradients) and the same draws; the gradients are dropped. float32
    training: the loss within 1e-4 relative, each trainable leaf within
    TOL['route_grad_rel'] of its largest gradient (with ``spread``, or 4x
    what a relative 1e-7 change of the weights moves the card's own
    gradient of that leaf, where that is more: measured up to ~3e-4, so
    a leaf reaches past 1e-3 only where the step is that sensitive), a
    leaf whose gradient is zero up to rounding (below 1e-6 of the
    largest; the radiance softmax's last bias shifts every view's logit
    alike) so on both sides.
    A bf16 policy by the bf16 rule over the distribution
    (``tests/test_torch_port_bf16_model.py``): the effect is the card's
    step of ``reference``, the same weights one policy up (the mixed
    policy for ``--compute_dtype bfloat16``, float32 for ``--encoder_dtype
    bfloat16``) on its own matcher's outputs; the card's loss no further
    from the CPU's than twice the effect (or 1e-4 relative), the trainable
    gradient as a whole (each leaf over its largest, those zero up to
    rounding left out) within twice the effect's norm. Returns the
    figures."""
    import torch

    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
    from uforecon_tpu_torch.pipeline import trainer
    from uforecon_tpu_torch.pipeline.fit import _gather_ray_batch

    scene, extras = scene_inputs_from_sample(sample, "cuda")
    h, w = extras["hw"]
    with torch.no_grad():
        enc_m = model.matcher(scene.source_imgs, scene.proj_matrices, scene.depth_values)
    idx = np.random.default_rng(SEED + 2).permutation(h * w)[:rn]
    batch = _gather_ray_batch(extras, idx)
    u_c = torch.rand((rn, cfg.coarse_sample),
                     generator=torch.Generator().manual_seed(SEED)).numpy()
    sides = [("card", "cuda", model, enc_m, scene),
             ("cpu", "cpu", copy.deepcopy(model).cpu(), to_cpu(enc_m), to_cpu(scene))]
    if reference is not None:
        with torch.no_grad():
            enc_r = reference.matcher(scene.source_imgs, scene.proj_matrices,
                                      scene.depth_values)
        sides.append(("effect", "cuda", reference, enc_r, scene))
    elif spread:
        # the step's own sensitivity: the card's step on weights moved by a
        # relative 1e-7 (seeded)
        moved = copy.deepcopy(model)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        with torch.no_grad():
            for p in moved.parameters():
                p.mul_(1.0 + 1e-7 * torch.randn(p.shape, generator=gen, device="cuda"))
        sides.append(("moved", "cuda", moved, enc_m, scene))
    grads, logs = {}, {}
    for side, dev, m, mo, sc in sides:
        m.matcher.forward = lambda *a, _mo=mo, **k: _mo
        rays = [torch.as_tensor(a, device=dev) for a in batch]
        u = torch.as_tensor(u_c, device=dev)
        logs[side] = trainer.grad_step(m.cfg, m, sc, *rays, draws=(u, None),
                                       coarse_only=True)
        grads[side] = {n: p.grad.detach().cpu() for n, p in trainer.trainable_parameters(m)}
        del m.matcher.forward
        for _, p in trainer.trainable_parameters(m):
            p.grad = None
    loss = {k: float(v["train/loss_all"]) for k, v in logs.items()}
    loss_rel = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    if reference is None:
        top = max(g.abs().max().item() for g in grads["cpu"].values())
        zero = {n for n, g in grads["cpu"].items() if g.abs().max().item() < 1e-6 * top}
        zero_ok = all(grads["card"][n].abs().max().item() < 1e-6 * top for n in zero)
        rel = {n: ((grads["card"][n] - g).abs().max() / g.abs().max()).item()
               for n, g in grads["cpu"].items() if n not in zero}
        # a leaf the step's own float32 rounding moves further is held to 4x
        # that movement (tests/torch_train_configs_common.py's rule)
        tol = {n: max(TOL["route_grad_rel"], 4 * (
            (grads["moved"][n] - grads["card"][n]).abs().max()
            / grads["card"][n].abs().max()).item() if spread else 0.0) for n in rel}
        worst = sorted(rel.items(), key=lambda kv: -kv[1] / tol[kv[0]])[:5]
        log(f"[{tag}] coarse {rn}-ray gradient step at {w}x{h}, "
            f"{scene.source_imgs.shape[0]} views, {cfg.coarse_sample} samples, "
            f"card vs CPU: loss {loss['card']:.6f} vs {loss['cpu']:.6f} (rel "
            f"{loss_rel:.2e}, tol 1e-4); {len(rel)} trainable leaves, max abs error over "
            f"each leaf's largest gradient: worst {[(n, e, tol[n]) for n, e in worst]} "
            f"(with each leaf's tolerance: {TOL['route_grad_rel']}, or 4x its movement "
            f"under a 1e-7 change of the weights); zero up to rounding on both sides: "
            f"{sorted(zero)} {zero_ok} [{card}]")
        if not (loss_rel <= 1e-4 and all(e <= tol[n] for n, e in rel.items())
                and zero_ok):
            raise AssertionError(f"{tag}: the training step disagrees between card "
                                 "and CPU")
        return {"loss_rel": loss_rel, "grad_rel_max": max(rel.values()),
                "grad_rel_over_tol_max": max(e / tol[n] for n, e in rel.items())}
    # each leaf over its largest gradient; a leaf whose gradient is zero up
    # to rounding (below 1e-6 of the largest; the radiance softmax's last
    # bias) carries no scale of its own and is left out
    top = max(g.abs().max().item() for g in grads["cpu"].values())
    scale = {n: g.abs().max().item() for n, g in grads["cpu"].items()
             if g.abs().max().item() >= 1e-6 * top}

    def flat(a, b):
        return torch.cat([((grads[a][n] - grads[b][n]) / scale[n]).ravel()
                          for n in sorted(scale)])

    diff, effect = flat("card", "cpu").norm().item(), flat("cpu", "effect").norm().item()
    loss_effect = abs(loss["cpu"] - loss["effect"])
    log(f"[{tag}] coarse {rn}-ray gradient step at {w}x{h}, "
        f"{cfg.encoder_dtype or cfg.compute_dtype} matcher, {cfg.compute_dtype} "
        f"trained half, card vs CPU by "
        f"the bf16 rule: loss {loss['card']:.6f} vs {loss['cpu']:.6f} (one policy up on "
        f"the card {loss['effect']:.6f}); gradient distance {diff:.4e} against the bf16 "
        f"effect's {effect:.4e} (each leaf over its largest; tol 2x) [{card}]")
    if not (abs(loss["card"] - loss["cpu"]) <= max(2 * loss_effect, 1e-4 * abs(loss["cpu"]))
            and diff <= 2 * effect):
        raise AssertionError(f"{tag}: the bf16 training step disagrees between card and "
                             "CPU beyond the bf16 effect")
    return {"loss_rel": loss_rel, "grad_distance": diff, "grad_effect": effect}


def train_cli(model_flags, run_name, tag, card):
    """``cli.run --debug`` with ``model_flags`` on the fixture's DTU training
    layout (3 steps, one validation, a checkpoint), then ``cli.run
    --extract_geometry --load_ckpt`` of that checkpoint with the same
    flags at 320x256, which must give finite depth maps; the training
    run's launches (MUST_RUN[run_name]) and the extraction's
    (MUST_RUN[run_name + '_extract']) are checked."""
    import contextlib
    import io

    import torch

    from uforecon_tpu_torch.cli import run
    from uforecon_tpu_torch.script import make_dtu_fixture as fixture

    w, h = TRAIN_WH
    wrappers = launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        root, logdir = os.path.join(tmp, "fixture"), os.path.join(tmp, "logs")
        with contextlib.redirect_stdout(io.StringIO()):
            paths = fixture.write_train_layout(root)
            fixture.main([root, "--views", "23", "24", "33", "--wh", "800", "600"])
        for wr in wrappers.values():
            wr.launches = 0
        t_cli = time.perf_counter()
        st = run.main(model_flags + [
            "--debug", "--root_dir", root, "--train_list", paths["train"],
            "--val_list", paths["val"], "--pair_file", paths["pair"], "--logdir", logdir])
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t_cli
        launches = {n: wr.launches for n, wr in wrappers.items()}
        check_launches(run_name, launches)
        with open(os.path.join(logdir, "uforecon_tpu", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        val = [r for r in recs if "val/loss_depth_fine" in r]
        ckpt = os.path.join(logdir, "uforecon_tpu", "ckpt", "step_3.pt")
        if not (st.step == 3 and len(val) == 1 and os.path.exists(ckpt)
                and all(np.isfinite(v) for v in val[0].values())):
            raise AssertionError(f"cli.run --debug {model_flags}: step {st.step}, "
                                 f"validation {val}, checkpoint {os.path.exists(ckpt)}")
        for wr in wrappers.values():
            wr.launches = 0
        ex_out = os.path.join(tmp, "out")
        stats = run.main(model_flags + [
            "--extract_geometry", "--root_dir", root, "--out_dir", ex_out,
            "--test_scan", "scan24", "--img_wh", "320", "256", "--load_ckpt", ckpt])["scan24"]
        check_launches(run_name + "_extract",
                       {n: wr.launches for n, wr in wrappers.items()})
        for i in range(3):
            e = np.load(os.path.join(ex_out, "depth", "scan24", f"{i:08d}.npy"),
                        allow_pickle=True).item()
            if e["depth"].shape != (256, 320) or not np.all(np.isfinite(e["depth"])):
                raise AssertionError(f"extract from the trained checkpoint "
                                     f"{model_flags}: view {i}")
        log(f"[train] {tag} cli.run {' '.join(model_flags)} --debug, DTU training "
            f"layout {w}x{h}, 4 source views: 3 steps, validation "
            f"{json.dumps({k: round(v, 5) for k, v in val[0].items()})}, checkpoint "
            f"step_3.pt, {t_cli:.1f} s, launches "
            f"{ {n: launches[n] for n in MUST_RUN[run_name]} }; then cli.run "
            f"--extract_geometry --load_ckpt step_3.pt with the same flags: "
            f"{stats['views']} views 320x256, finite depth maps [{card}]")
        del st
    return launches, {"seconds": t_cli, "val": val[0]}


def training_phase(card):
    """Training at the full width of the JAX training default (module
    docstring, phase 11): (a) card against CPU, (b) timed steps, (c) the
    training CLI and the reload of its checkpoint; (d), learn_sanity, runs
    in a process of its own (``start_learn_sanity``). Returns the
    launches of each of its runs and its numbers."""
    import contextlib
    import io

    import torch

    from uforecon_tpu_torch.config import Config
    from uforecon_tpu_torch.pipeline import trainer
    from uforecon_tpu_torch.pipeline.fit import init_model

    cfg = Config()
    out, launches = {}, {}
    t0 = time.perf_counter()
    sample = train_sample()
    model = init_model(cfg, SEED, "cuda")
    state = trainer.TrainState(model, trainer.make_optimizer(cfg, model))

    # (a) one coarse 256-ray gradient step, card against CPU; both take the
    # matcher's outputs of the card (frozen, without gradients)
    out["card_vs_cpu"] = coarse_step_card_vs_cpu(cfg, model, sample, 256, "train (a)",
                                                 card)
    state.optimizer.zero_grad(set_to_none=True)

    # (b) timed steps: the default route, then route A on the same weights
    launches["train"], out["off"] = training_steps(cfg, model, state, sample, "train",
                                                   TRAIN_STEPS["off"], card)
    model_a = model.with_knobs(fused_point_head="never")
    launches["train_A"], out["A"] = training_steps(cfg, model_a, state, sample, "train_A",
                                                   TRAIN_STEPS["A"], card)
    del model, model_a, state
    torch.cuda.empty_cache()

    # (c) the training CLI on the DTU training layout, then extraction from
    # the checkpoint it wrote
    launches["train_cli"], out["cli"] = train_cli(
        ["--depth_pos_encoding", "--explicit_similarity"], "train_cli", "(c)", card)
    torch.cuda.empty_cache()

    out["seconds"] = time.perf_counter() - t0
    return launches, out


def train_configs_phase(card):
    """(e) of the training phase: each of TRAIN_CONFIGS (the JAX package's
    other model configurations, ``share_cr``, and both bf16 policies), a
    model of its own with seeded weights at the JAX training default:
    one coarse gradient step card against CPU at TRAIN_CFG_A_WH with
    TRAIN_CFG_A_RAYS rays (``coarse_step_card_vs_cpu``; the bf16 policy's
    effect is its weights in the mixed policy), then TRAIN_CFG_STEPS timed
    full 1024-ray steps at 640x512 (``training_steps``: s/step, peak
    memory, the launches JAX's gates imply on every step); then
    ``cli.run --debug`` with TRAIN_CFG_CLI and the extraction from its
    checkpoint with the same flags (``train_cli``). Returns the launches
    of each run and the figures."""
    import torch

    from uforecon_tpu_torch.config import Config
    from uforecon_tpu_torch.models.uforecon import UFORecon
    from uforecon_tpu_torch.pipeline import trainer
    from uforecon_tpu_torch.pipeline.fit import init_model
    from uforecon_tpu_torch.script import learn_sanity

    w, h = TRAIN_WH
    numdepth = Config().numdepth
    sample = learn_sanity.SphereDataset(learn_sanity.build_scene_views(6, h, w), 4,
                                        numdepth)[0]
    wa, ha = TRAIN_CFG_A_WH
    sample_a = learn_sanity.SphereDataset(learn_sanity.build_scene_views(6, ha, wa), 4,
                                          numdepth)[0]
    launches, figures = {}, {}
    for name, flags in TRAIN_CONFIGS.items():
        t0 = time.perf_counter()
        cfg = Config(**flags)
        model = init_model(cfg, SEED, "cuda")
        state = trainer.TrainState(model, trainer.make_optimizer(cfg, model))
        reference = None
        if cfg.encoder_torch_dtype == torch.bfloat16:
            # one policy up: bf16 -> mixed, mixed -> float32
            up = ("encoder_dtype", "bfloat16") if cfg.compute_dtype == "bfloat16" else (
                "encoder_dtype", "float32")
            reference = UFORecon(Config(**{**flags, "compute_dtype": "float32", up[0]: up[1]}))
            reference.load_state_dict(model.state_dict())
            reference.to("cuda")
            trainer.make_optimizer(reference.cfg, reference)
        a = coarse_step_card_vs_cpu(cfg, model, sample_a, TRAIN_CFG_A_RAYS,
                                    f"train (e) {name}", card, reference, spread=True)
        run = f"train_cfg_{name}"
        launches[run], steps = training_steps(cfg, model, state, sample, run,
                                              TRAIN_CFG_STEPS, card)
        figures[name] = {"flags": flags, "card_vs_cpu": a,
                         "s_per_step": steps["s_per_step"], "peak_gib": steps["peak_gib"],
                         "launches_per_step": steps["launches_per_step"],
                         "seconds": time.perf_counter() - t0}
        del model, state, reference
        torch.cuda.empty_cache()
    launches["train_cfg_cli"], figures["cli"] = train_cli(TRAIN_CFG_CLI, "train_cfg_cli",
                                                          "(e)", card)
    torch.cuda.empty_cache()
    log("[train] (e) s/step (median) and peak GiB per configuration: " + json.dumps(
        {n: (float(np.median(f["s_per_step"])), round(f["peak_gib"], 3))
         for n, f in figures.items() if n != "cli"}) + f" [{card}]")
    return launches, figures


def train_sample():
    """The training phase's scene: the learn_sanity sphere at the DTU
    training crop, 5 views."""
    from uforecon_tpu_torch.config import Config
    from uforecon_tpu_torch.script import learn_sanity

    w, h = TRAIN_WH
    return learn_sanity.SphereDataset(learn_sanity.build_scene_views(6, h, w), 4,
                                      Config().numdepth)[0]


def cards_step_inputs(device):
    """One training step's model (seeded, the JAX training default), scene
    and ray batch (TRAIN_WH, 1024 rays), and a seeded generator."""
    import torch

    from uforecon_tpu_torch.config import Config
    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
    from uforecon_tpu_torch.pipeline import trainer
    from uforecon_tpu_torch.pipeline.fit import _gather_ray_batch, init_model

    cfg = Config()
    model = init_model(cfg, SEED, device)
    trainer.make_optimizer(cfg, model)
    scene, extras = scene_inputs_from_sample(train_sample(), device)
    h, w = extras["hw"]
    idx = np.random.default_rng(SEED).permutation(h * w)[:cfg.train_ray_num]
    rays = [torch.as_tensor(a, device=device) for a in _gather_ray_batch(extras, idx)]
    return cfg, model, scene, rays, torch.Generator(device=device).manual_seed(SEED)


def cards_rank(device, weights):
    """One rank of the cards phase (``parallel.sharding.spawn``): the
    slice's 800x640 view at the CLI defaults through
    extract_geometry_for_dataset (this rank's share of its rays; rank 0
    writes the depth map), then this rank's share of one 1024-ray training
    step at the JAX training default, all-reduced. Returns rank 0's depth
    map, step logs and gradients, and every rank's launches and seconds."""
    import torch

    from uforecon_tpu_torch.config import Config
    from uforecon_tpu_torch.data.synthetic import dtu_scale_sample
    from uforecon_tpu_torch.models.uforecon import UFORecon
    from uforecon_tpu_torch.parallel import sharding
    from uforecon_tpu_torch.pipeline import trainer
    from uforecon_tpu_torch.pipeline.extract import extract_geometry_for_dataset

    wrappers = launch_counts()
    model = UFORecon(Config(extract_geometry=True))
    model.load_state_dict(torch.load(weights, map_location="cpu"))
    model.to(device)
    out = {"rank": sharding.rank()}
    with tempfile.TemporaryDirectory() as out_dir:
        for wr in wrappers.values():
            wr.launches = 0
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        stats = extract_geometry_for_dataset(model, [dtu_scale_sample()], out_dir=out_dir,
                                             device=device, seed=SEED, previews=False)
        torch.cuda.synchronize(device)
        out["render_s"] = time.perf_counter() - t0
        out["render_launches"] = {n: wr.launches for n, wr in wrappers.items()}
        out["rays"] = stats["rays"]
        if sharding.rank() == 0:
            out["depth"] = np.load(os.path.join(out_dir, "depth", "scan1", "00000000.npy"),
                                   allow_pickle=True).item()["depth"]
    del model
    cfg, model, scene, rays, gen = cards_step_inputs(device)
    for wr in wrappers.values():
        wr.launches = 0
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    logs = trainer.all_reduce_step(model, trainer.grad_step(cfg, model, scene, *rays, gen))
    torch.cuda.synchronize(device)
    out["step_s"] = time.perf_counter() - t0
    out["step_launches"] = {n: wr.launches for n, wr in wrappers.items()}
    if sharding.rank() == 0:
        out["logs"] = {k: float(v) for k, v in logs.items()}
        out["grads"] = {n: p.grad.cpu().numpy() for n, p in trainer.trainable_parameters(model)
                        if p.grad is not None}
    return out


def cards_run(weights, world, backend, card, reference):
    """``world`` ranks of ``cards_rank`` against ``reference`` (the same
    work on one rank): rank 0's depth map bit for bit, the step's loss
    within rtol 1e-3 and its gradient tree within relative L2 2e-2 (the CPU
    test's rule), every rank's kernels (MUST_RUN cards_render, cards_step).
    Returns the launches of each rank's runs and the figures."""
    from uforecon_tpu_torch.parallel import sharding

    device = "cuda:0" if backend == "gloo" else "cuda"
    ranks = sharding.spawn(cards_rank, world, (weights,), device=device, backend=backend)
    launches = {}
    for r in ranks:
        for run in ("render", "step"):
            launches[f"cards_{run}_{backend}_r{r['rank']}"] = r[f"{run}_launches"]
            check_launches(f"cards_{run}", r[f"{run}_launches"])
    r0 = ranks[0]
    if not np.array_equal(r0["depth"], reference["depth"]):
        raise AssertionError(f"{world} ranks ({backend}): the depth map differs from one "
                             f"rank's (max {np.abs(r0['depth'] - reference['depth']).max()})")
    g, want = r0["grads"], reference["grads"]
    if set(g) != set(want):
        raise AssertionError(f"{world} ranks ({backend}): other gradients than one rank's")
    rel = (sum(float(np.sum((g[n] - want[n]) ** 2)) for n in g)
           / max(sum(float(np.sum(want[n] ** 2)) for n in g), 1e-30)) ** 0.5
    loss, loss_1 = r0["logs"]["train/loss_all"], reference["logs"]["train/loss_all"]
    loss_rel = abs(loss - loss_1) / abs(loss_1)
    res = {"world": world, "backend": backend,
           "render_s": [r["render_s"] for r in ranks],
           "rays_per_sec": r0["rays"] / max(r["render_s"] for r in ranks),
           "s_per_step": [r["step_s"] for r in ranks], "loss_rel": loss_rel,
           "grad_rel_l2": rel}
    log(f"[cards] {world} ranks over {backend} on {device}: the 800x640 view at the CLI "
        f"defaults equals one rank's bit for bit; the 1024-ray step's loss {loss:.6f} "
        f"against {loss_1:.6f} (rel {loss_rel:.2e}), gradient tree rel-L2 {rel:.2e} "
        f"(limits 1e-3, 2e-2); render s per rank {np.round(res['render_s'], 3).tolist()} "
        f"({res['rays_per_sec']:.1f} rays/s over the slowest), step s per rank "
        f"{np.round(res['s_per_step'], 3).tolist()}; launches per rank: render "
        f"{[{n: r['render_launches'][n] for n in MUST_RUN['cards_render']} for r in ranks]}, "
        f"step {[{n: r['step_launches'][n] for n in MUST_RUN['cards_step']} for r in ranks]}"
        f" [{card}]")
    if loss_rel > 1e-3 or rel > 2e-2:
        raise AssertionError(f"{world} ranks ({backend}): the step differs from one rank's: "
                             f"loss rel {loss_rel}, gradient rel-L2 {rel}")
    return launches, res


def cards_phase(model, shipped_depth, card):
    """(b)-(d) of the cards phase: one rank's training step, then
    CARDS_RANKS gloo ranks on this card (which measure correctness only:
    they share the card), and with two cards or more, NCCL ranks across
    them (rays/s and s/step per card count). The one-rank render they are
    held to is the slice phase's shipped route (``shipped_depth``: the
    same view, weights, configuration and seed; the encoding is
    deterministic). Returns the launches of each rank's runs and the
    figures."""
    import torch

    from uforecon_tpu_torch.pipeline import trainer

    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "weights.pt")
        torch.save(model.state_dict(), weights)
        ref = {"depth": shipped_depth}
        cfg, step_model, scene, rays, gen = cards_step_inputs("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = trainer.grad_step(cfg, step_model, scene, *rays, gen)
        torch.cuda.synchronize()
        ref["step_s"] = time.perf_counter() - t0
        ref["logs"] = {k: float(v) for k, v in logs.items()}
        ref["grads"] = {n: p.grad.cpu().numpy()
                        for n, p in trainer.trainable_parameters(step_model)
                        if p.grad is not None}
        del step_model, scene, rays
        torch.cuda.empty_cache()
        out["one"] = {"step_s": ref["step_s"]}
        log(f"[cards] one rank: one 1024-ray step at 640x512 {ref['step_s']:.3f} s (the "
            f"view: the slice phase's shipped route) [{card}]")
        run_launches, out["gloo"] = cards_run(weights, CARDS_RANKS, "gloo", card, ref)
        launches.update(run_launches)
        cards = torch.cuda.device_count()
        if cards >= 2:
            run_launches, out["nccl"] = cards_run(weights, cards, "nccl", card, ref)
            launches.update(run_launches)
        else:
            log(f"[cards] NCCL across cards: not run, this machine has {cards} card")
    return launches, out


# the phases that run in a process of their own, in this order, beside the
# main process's pipeline, general, views and cards phases (each takes the
# card's name and returns the launches of its runs and its figures), with
# their names in the [time] line
SIDE_PHASES = {"configs_phase": "configs", "training_phase": "train (a)-(c)",
               "train_configs_phase": "train (e) configurations"}
# argv root, the JSON file for the results, then the phases' names
PHASES_RUNNER = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke
card = chip_smoke.smi("name,power.limit")
out = {}
for name in sys.argv[3:]:
    t0 = time.perf_counter()
    launches, figures = getattr(chip_smoke, name)(card)
    out[name] = {"launches": launches, "figures": figures,
                 "seconds": time.perf_counter() - t0}
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
"""


def start_phases(tmp):
    """SIDE_PHASES in a process of their own (PHASES_RUNNER)."""
    root = os.path.dirname(os.path.abspath(__file__))
    return start_process([sys.executable, "-c", PHASES_RUNNER, root,
                          os.path.join(tmp, "phases.json"), *SIDE_PHASES], tmp)


def finish_phases(started, card):
    """Waits for SIDE_PHASES, logs what they logged and returns, per
    phase, its launches, figures and seconds; they must have passed."""
    code, out, err, seconds = finish_process(started, timeout=1100)
    for line in out.strip().splitlines():
        log(line)
    if code != 0:
        log(err[-6000:])
        raise AssertionError(f"the phases {list(SIDE_PHASES)} failed in their process "
                             f"(exit {code})")
    log(f"[side] {', '.join(SIDE_PHASES.values())}: in a process beside the pipeline, "
        f"general, views and cards phases, ended within {seconds:.1f} s of its start "
        f"[{card}]")
    with open(os.path.join(os.path.dirname(started[1][0].name), "phases.json")) as f:
        return json.load(f)


# learn_sanity in a process of its own (its launches counted there), so
# that it runs beside the other phases: argv root, logdir, then
# learn_sanity's own arguments
LEARN_SANITY_RUNNER = """
import contextlib, io, json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import chip_smoke
from uforecon_tpu_torch.script import learn_sanity
wrappers = chip_smoke.launch_counts()
for wr in wrappers.values():
    wr.launches = 0
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    code = learn_sanity.main(["--mesh_eval", "--logdir", sys.argv[2], *sys.argv[3:]])
print(json.dumps({"code": code, "result": json.loads(buf.getvalue().strip().splitlines()[-1]),
                  "launches": {n: wr.launches for n, wr in wrappers.items()},
                  "seconds": time.perf_counter() - t0}))
"""


def start_process(cmd, tmp):
    """cmd started from the checkout's root, its output into files in tmp
    (a pipe could fill and stall it); returns what finish_process needs."""
    root = os.path.dirname(os.path.abspath(__file__))
    outs = [open(os.path.join(tmp, name), "w+") for name in ("out.txt", "err.txt")]
    proc = subprocess.Popen(cmd, cwd=root, stdout=outs[0], stderr=outs[1], text=True)
    return proc, outs, time.perf_counter()


def finish_process(started, timeout):
    """Waits for a start_process; returns (exit code, stdout, stderr,
    seconds since its start)."""
    proc, outs, t0 = started
    try:
        code = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    texts = []
    for f in outs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    return code, texts[0], texts[1], time.perf_counter() - t0


def start_learn_sanity(tmp, extra=()):
    """(d) of the training phase: ``script/learn_sanity.py --mesh_eval`` at
    its defaults (120 MVS + 300 render steps, 160x128, 6 views) in a
    process of its own."""
    root = os.path.dirname(os.path.abspath(__file__))
    return start_process([sys.executable, "-c", LEARN_SANITY_RUNNER, root, tmp, *extra], tmp)


def finish_learn_sanity(started, card):
    """learn_sanity's result, which must pass its rule, with the kernels
    it launched (MUST_RUN) and its seconds beside the other work."""
    code, out, err, _ = finish_process(started, timeout=900)
    if code != 0 or not out.strip():
        log(out[-4000:] + err[-4000:])
        raise AssertionError(f"learn_sanity's process failed (exit {code})")
    res = json.loads(out.strip().splitlines()[-1])
    result, launches, seconds = res["result"], res["launches"], res["seconds"]
    log(f"[train] (d) learn_sanity --mesh_eval (120 MVS + 300 render steps, 160x128, 6 "
        f"views): {json.dumps(result)}, exit {res['code']}, {seconds:.1f} s beside the "
        f"other phases and the GPU unit tests (JAX package on a TPU: depth L1 "
        f"0.2201 -> 0.0060 of span, mesh acc 2.80 % / comp 1.81 % of radius) [{card}]")
    check_launches("learn_sanity", launches)
    if res["code"] != 0:
        raise AssertionError(f"learn_sanity failed its rule: {result}")
    return launches, {**result, "seconds": seconds}


def start_tests(tmp):
    """The GPU unit tests of the kernels (GPU_TESTS, no JAX) in a process
    of their own, which reuses the built extension."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-k", "on_gpu", "-q",
           "-p", "no:cacheprovider", *GPU_TESTS]
    return start_process(cmd, tmp)


def finish_tests(started, card):
    """The GPU unit tests must pass."""
    code, out, err, seconds = finish_process(started, timeout=900)
    lines = out.strip().splitlines()
    log(f"[tests] pytest --noconftest -k on_gpu {' '.join(GPU_TESTS)}: "
        f"{lines[-1] if lines else ''} (ended within {seconds:.1f} s of its start) [{card}]")
    if code != 0:
        log(out[-6000:] + err[-2000:])
        raise AssertionError(f"the GPU unit tests failed (exit {code})")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from uforecon_tpu_torch.config import EXACT, Config, merge_guard_bytes
        from uforecon_tpu_torch.convert import init_weights
        from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
        from uforecon_tpu_torch.models.uforecon import UFORecon
        from uforecon_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the uforecon_tpu_torch package is missing beside "
              f"this script ({e})", file=sys.stderr)
        return 1

    card = smi("name,power.limit")
    log(card)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cuda_build.extension()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    # the exact path (the routes of earlier slices); the shipped route is a
    # with_knobs copy on the same weights
    model = UFORecon(Config(**EXACT))
    init_weights(model, SEED)
    model.to("cuda")
    # route B: the ablation without explicit similarity, its own weights
    model_b = UFORecon(Config(explicit_similarity=False, **EXACT))
    init_weights(model_b, SEED)
    model_b.to("cuda")

    # seconds per phase, logged at the end (the run must stay inside its
    # time limit)
    phase_s, t_phase = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = round(now - t_phase[0], 1)
        t_phase[0] = now

    kres = kernel_phase(model, card)
    lap("kernel")
    models, sample, stats, launches, shipped_depth = slice_phase(model, model_b, card)
    log(f"[slice] render rays/s against knobs off in this process (the off run "
        f"is the process's first view): " + json.dumps(
            {r: stats["off"]["render_s"] / stats[r]["render_s"]
             for r in ("on", "A", "B", "v2", "shipped")}) + f" [{card}]")
    launches["grad"] = gradient_phase(models["A"], sample, card)
    launches["probe"] = probe_phase(card)
    scene, extras = scene_inputs_from_sample(sample, "cuda")
    with torch.no_grad():
        enc = model.encode(scene)
        enc_s = models["shipped"].encode(scene)
    merged = enc_s.volumes["merged"]
    log(f"[slice] shipped route: merged volume {tuple(merged.shape)} {merged.dtype}, "
        f"{merged.numel() * merged.element_size()} bytes in the port's unpacked layout; "
        f"the JAX package's guard counts {merge_guard_bytes(models['shipped'].cfg, 3, 640, 800)}"
        f" bytes (its corner-packed layout) against merge_max_bytes "
        f"{models['shipped'].cfg.merge_max_bytes}; the exact route's stage volumes "
        f"{sum(v.numel() * v.element_size() for v in enc.volumes.values())} bytes")
    launches.update(shipped_knob_runs(models["shipped"], scene, enc_s, extras, card))
    ab_phase(models, scene, enc, extras, card)
    del enc, enc_s, merged, scene, extras
    lap("slice, grad, probe, ab")
    # the device timings are done: from here on the configs and training
    # phases (SIDE_PHASES), learn_sanity and the GPU unit tests run, each in
    # a process of its own, beside the pipeline, general, views and cards
    # phases, which share the card and the host with them
    with tempfile.TemporaryDirectory() as side_tmp:
        side = {}
        for name, start in (("phases", start_phases), ("learn_sanity", start_learn_sanity),
                            ("tests", start_tests)):
            os.makedirs(os.path.join(side_tmp, name))
            side[name] = start(os.path.join(side_tmp, name))
        try:
            pipeline_launches, cards_cli_s = pipeline_phase(model, card)
            launches.update(pipeline_launches)
            lap("pipeline")
            general_launches, general = general_phase(model, card)
            launches.update(general_launches)
            lap("general")
            views_launches, views = views_phase(
                model, card, lambda: lap("views: fixture and cli.run"))
            launches.update(views_launches)
            lap("views chunks")
            cards_launches, cards = cards_phase(model, shipped_depth, card)
            launches.update(cards_launches)
            lap("cards (b)-(d)")
            phases = finish_phases(side["phases"], card)
            for res in phases.values():
                launches.update(res["launches"])
            configs = phases["configs_phase"]["figures"]
            train = phases["training_phase"]["figures"]
            train["configs"] = phases["train_configs_phase"]["figures"]
            finish_tests(side["tests"], card)
            launches["learn_sanity"], train["learn_sanity"] = finish_learn_sanity(
                side["learn_sanity"], card)
        except BaseException:
            for proc, _, _ in side.values():   # no process outlives the run
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            raise
    lap("the side processes after the cards phase")
    phase_s["cards (a), in pipeline"] = round(cards_cli_s, 1)
    for name, label in SIDE_PHASES.items():
        phase_s[f"{label}, in a process beside them"] = round(phases[name]["seconds"], 1)

    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches[ROUTE[name]][name],
                        "launches_by_run": {r: launches[r][name] for r in launches},
                        **({"pack_builds_by_run": {r: stats[r]["pack_builds"][name]
                                                   for r in stats}}
                           if name in pack_counters() else {}),
                        **({"precision": "fast"} if name in FAST else {}),
                        **({"units": list(RAY_FAST_UNITS)} if name in (
                            "ray_head_fast", "ray_head_neus_fast") else {}),
                        **kres[name]})
    log("[general] " + json.dumps(general))
    log("[configs] " + json.dumps(configs))
    log("[views] " + json.dumps(views))
    log("[train] " + json.dumps(train))
    log("[cards] " + json.dumps(cards))
    log("[time] seconds per phase after the build: " + json.dumps(phase_s))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
