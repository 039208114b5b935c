"""Where the kernels' time goes: variants of ``csrc/point_head.cuh`` (the
3xTF32 point head), ``csrc/point_head_fast.cuh`` (the fast one),
``csrc/point_head2.cuh``, ``csrc/point_head2_fast.cuh`` (the fast split
point head), ``csrc/ray_head.cu`` (3xTF32, or with ``fast``
its bf16 instantiation), ``csrc/ray_head_fast.cuh`` (the fast ray head at
C 40 .. 112), ``csrc/tiny_attention.cuh`` (forward and backward) and
``csrc/volume_fusion.cu`` timed apart on one GPU.

    python -m uforecon_tpu_torch.script.head_variants ph ph,nogemm phf phf,phf_rad ph2 rh \
        rh,rh_ln rh,fast rhf rhf,rhf_mlp rhf,rhf_probe ph2f ph2f,ph2f_attn ph2f,ph2f_probe \
        ta,S=2 tb tb,tb_stream vf vf,T=128

Each variant is a copy of ``csrc/`` with a few lines replaced, built by
``nvcc`` (all variants at once) into a shared library with the kernels'
plain C interface, and timed with CUDA events (mean of 20 launches, back to
back on the same inputs) and by torch.profiler (the kernels' mean device
time over 20 launches) at the main path's shapes: the point heads at P =
65,536 points and 3 views, the ray head over 1024 rays of 64 and of 128
samples at width 88 (``rh,fast`` and ``rhf``: in ``fast``, against the
fast plain version; ``--ray_width C`` another width on random weights, as
``script/ray_head_times.py`` draws them), the tiny-attention forward at B =
65,536, L = S = 4, 8 heads of D = M = 10 (route A) and 8 (route B), its backward at B =
65,536, 8 heads of D = M = 10, L = S = 4 (route A) and 6 (the training
shape), the volume fusion at P = 65,536 and 3 views in the sampler's
channel-first layout (its 27.5 MB stay in the L2 between launches), on
seeded random weights and inputs (``ph2f`` in ``fast``, against the fast
plain version). A variant is a kernel (``ph``,
``phf``, ``ph2``, ``ph2f``, ``rh``, ``rhf``, ``ta``, ``tb`` or ``vf``)
followed by
comma-separated options:

  NAME=VALUE  a constant of the kernel's source (``CONSTANTS``), e.g.
              ``T=256`` threads a block, ``S=3`` weight-ring slots (for
              ``ta`` and ``tb``: input stages), ``I=64`` items a tile,
              ``G=1`` rays in flight a block of ``rhf``, ``A=1`` its wide
              layout's mlp1 fragments a whole slice ahead (2: half);
  a patch     of ``PATCHES``: ``nogemm`` skips the tensor-core layers;
              ``onemma`` keeps one of the three 3xTF32 products;
              ``nosync`` drops the per-step sync, ``noload`` the weight
              loads; ``ph_*`` / ``phf_*`` / ``ph2_*`` / ``ph2f_*`` /
              ``rh_*`` / ``rhf_*`` / ``ta_*`` / ``tb_*`` skip one phase of a
              kernel; ``phf_probe`` and ``ph2f_probe`` print the fast point
              heads' cycles a tile in each of their phases, ``rhf_probe``
              the fast ray head's cycles a ray (block 0's first thread, its
              barriers included); ``rhf_dsmem`` launches ``rhf`` in
              clusters of two blocks that read k, v, merge and mlp2's B
              fragments from each other's shared memory (the cost of
              splitting the image between two SMs);
  ``fast``    (``rh`` only) runs ``ray_head.cu``'s bf16 instantiation;
              ``tb_stream`` keeps only the backward's copies (no
              arithmetic); ``vf_stream`` keeps the
              fusion's loads and stores with a plain sum in place of its
              products and divisions, ``vf_fastdiv`` takes approximate
              divisions, ``vf_direct`` stores each point's row from
              registers instead of through shared memory.

A variant that skips work gives wrong outputs: its max abs error against
the plain version is printed, not checked. The difference between two
variants' times is what the skipped work costs. One line per variant, then
one JSON line with every time. Needs a CUDA card and ``nvcc`` (one process
a source file, all at once); builds go to
``uforecon_tpu_torch/_build/variants/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import cuda_build

# kernel -> the source that holds it (which the constants and patches name)
SOURCE = {"ph": "point_head.cuh", "phf": "point_head_fast.cuh", "ph2": "point_head2.cuh",
          "ph2f": "point_head2_fast.cuh",
          "rh": "ray_head.cu", "rhf": "ray_head_fast.cuh", "ta": "tiny_attention.cuh",
          "tb": "tiny_attention.cuh", "vf": "volume_fusion.cu"}
# kernel -> the files nvcc compiles into its library (the point heads'
# instances of 2..5 views, of 6..11 views and past 11 are separate files;
# rhf's: rhf_units)
_PH_UNITS = ("point_head.cu", "point_head_views.cu", "point_head_views_9_11.cu",
             "point_head_fast.cu", "point_head_fast_views.cu", "point_head_stream.cu")
UNITS = {"ph": _PH_UNITS, "phf": _PH_UNITS,
         # point_head2.cu sends 'fast' to the fast kernel's entry point
         "ph2": ("point_head2.cu", "point_head2_views.cu", "point_head2_stream.cu",
                 "point_head2_fast.cu", "point_head2_fast_views.cu"),
         "ph2f": ("point_head2_fast.cu", "point_head2_fast_views.cu"),
         "ta": ("tiny_attention.cu", "tiny_attention_bwd2.cu", "tiny_attention_bwd1.cu"),
         "tb": ("tiny_attention.cu", "tiny_attention_bwd2.cu", "tiny_attention_bwd1.cu")}
# the fast split point head's phases by its probe's marks (ph2f_probe)
PH2F_PHASES = ("inputs | pre-similarity MLP", "shared projection", "view q|k|v", "attention",
               "merge", "LayerNorm 1", "mlp1", "mlp2", "LayerNorm 2", "token out, radiance MLP",
               "softmax")
# the fast ray head's phases by its probe's marks (rhf_probe)
RHF_PHASES = ("phase 1: tokens, k", "phase 1: ksum, 2 barriers", "phase 1: v, barrier",
              "phase 1: state", "state out, barrier", "phase 2: tokens", "q, attention",
              "merge, LayerNorm", "mlp1, mlp2", "LayerNorm, density", "barrier, NeuS")
# kernel -> NAME -> (the source's line, its replacement with {} for VALUE)
CONSTANTS = {
    "ph": {"TP": ("constexpr int TP_MAX = 16;", "constexpr int TP_MAX = {};"),
           "T": ("constexpr int kPointThreads = 320;", "constexpr int kPointThreads = {};"),
           "S": ("constexpr int kStages = 2;", "constexpr int kStages = {};"),
           "LB": ("__launch_bounds__(kPointThreads, NV <= 5 ? 2 : 1)",
                  "__launch_bounds__(kPointThreads, {})")},
    "ph2": {"T": ("constexpr int kThreads = 320;", "constexpr int kThreads = {};"),
            "S": ("constexpr int kStages = 2;", "constexpr int kStages = {};"),
            "LB": ("__launch_bounds__(kThreads, NV <= 5 ? 2 : 1)",
                   "__launch_bounds__(kThreads, {})"),
            "SR": ("constexpr int kSmallRows = 1;", "constexpr int kSmallRows = {};")},
    "rh": {"T": ("constexpr int kRayThreads = 512;", "constexpr int kRayThreads = {};"),
           "S": ("constexpr int kStages = 2;", "constexpr int kStages = {};")},
    "rhf": {"G": ("constexpr int kGroups = 2;", "constexpr int kGroups = {};"),
            "A": ("constexpr int kW1Ahead = 2;", "constexpr int kW1Ahead = {};")},
    "ta": {"T": ("constexpr int kFwdThreads = 128;", "constexpr int kFwdThreads = {};"),
           "I": ("constexpr int kFwdItems = 128;", "constexpr int kFwdItems = {};"),
           "S": ("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = {};")},
    "tb": {"T": ("constexpr int kBwdThreads = 128;", "constexpr int kBwdThreads = {};"),
           "I": ("constexpr int kBwdItems = 128;", "constexpr int kBwdItems = {};"),
           "S": ("constexpr int kBwdStages = 2;", "constexpr int kBwdStages = {};"),
           "LB": ("__launch_bounds__(kBwdThreads, 3)", "__launch_bounds__(kBwdThreads, {})")},
    "vf": {"T": ("constexpr int kThreads = 64;", "constexpr int kThreads = {};")},
}


def _skip(line):
    """(line, the line made dead)."""
    stripped = line.lstrip()
    return line, line[:len(line) - len(stripped)] + "if (0) " + stripped


def _empty_loop(line, bound):
    """(line, the loop made to run no iteration)."""
    return line, line.replace(f"< {bound};", f"< 0 * {bound};")


# the backward's three arithmetic phases: phi of q and k, the (point, l,
# h) items, the (point, s, h) items
_TB_PHI = [("tiny_attention.cuh", *_empty_loop(
    "    for (int j = tid; j < tile * (rq + rk) / 4; j += blockDim.x) {", "tile * (rq + rk) / 4"))]
_TB_ITEMS = [("tiny_attention.cuh", *_empty_loop(
    "  for (int idx = threadIdx.x; idx < n * LH; idx += blockDim.x) {", "n * LH"))]
_TB_SOURCES = [("tiny_attention.cuh", *_empty_loop(
    "  for (int idx = threadIdx.x; idx < n * SH; idx += blockDim.x) {", "n * SH"))]

# patch -> [(file, old, new)]
PATCHES = {
    "nogemm": [("tc_gemm.cuh", '  static_assert(kStages >= 2, "the ring needs two slots or more");',
                '  static_assert(kStages >= 2, "the ring needs two slots or more");\n'
                '  if (threadIdx.x < 100000) return;')],
    "onemma": [("tc_gemm.cuh", "            mma(acc[j], alo, bh0, bh1);\n"
                "            mma(acc[j], ahi, bl0, bl1);\n", "")],
    "nosync": [("tc_gemm.cuh", "      cp_async_wait<kStages - 2>();\n", ""),
               ("tc_gemm.cuh", "      // s - 1, whose slot the prefetch below refills\n"
                "      __syncthreads();\n", "")],
    "noload": [("tc_gemm.cuh", "      if (s + kStages - 1 < steps) load(s + kStages - 1);",
                "      if (s + kStages - 1 < steps && s < 0) load(s + kStages - 1);")],
    "ph_sim": [("point_head.cuh", *_skip("  block_linear<4>(s_in, SIN, SIN,")),
               ("point_head.cuh", *_skip("  block_linear<4>(s_h1, SH, SH,")),
               ("point_head.cuh", *_skip("  block_linear<4>(s_h2, SH, SH,"))],
    "ph_rad": [("point_head.cuh", *_skip("  block_linear<4>(z, CR, CR,")),
               ("point_head.cuh", *_skip("  block_linear<4>(h1, R1, R1,")),
               ("point_head.cuh", *_skip("  block_linear<4>(h2, R2, R2,"))],
    "phf_sim": [("point_head_fast.cuh", "    if (gw == 0) {\n      warp_linear<kFma>(s_in,",
                 "    if (gw < 0) {\n      warp_linear<kFma>(s_in,")],
    "phf_rad": [("point_head_fast.cuh", "    if (gw < MT) {", "    if (gw < 0 * MT) {")],
    "phf_ln": [("point_head_fast.cuh", *_skip("    group_layernorm<C, T>(Vb, LD, GR, gt, F + I::N1S")),
               ("point_head_fast.cuh", *_skip("    group_layernorm<C, T>(Vb, LD, GR, gt, F + I::N2S"))],
    "phf_attn": [("point_head_fast.cuh", *_empty_loop(
        "    for (int it = gt; it < TP * L * NH; it += kGroupThreads) {", "TP * L * NH"))],
    "phf_probe": [("point_head_fast.cuh", '#pragma once\n\n#include "point_head.cuh"',
                   '#pragma once\n#define UFO_PHF_PROBE\n#include "point_head.cuh"')],
    "phf_gemm": [("point_head_fast.cuh", "  constexpr int NTILES = N / 8, K = K1 + K2;",
                  "  constexpr int NTILES = N / 8, K = 0 * (K1 + K2);")],
    "ph_attn": [("point_head.cuh", *_empty_loop(
        "  for (int t = tid; t < TP * L * NH; t += blockDim.x) {", "TP * L * NH"))],
    "ph_ln": [("point_head.cuh", *_skip("  tc::layernorm<C>(Kb, LD, R, W + O_N1S")),
              ("point_head.cuh", *_skip("  tc::layernorm<C>(Kb, LD, R, W + O_N2S"))],
    "ph_pe": [("point_head.cuh", *_empty_loop(
        "  for (int i = tid; i < NV * TP * CT; i += blockDim.x) {", "NV * TP * CT"))],
    "ph_softmax": [("point_head.cuh", *_empty_loop(
        "  for (int p = tid; p < TP; p += blockDim.x) {", "TP"))],
    "ph2_sim": [("point_head2.cuh", *_skip("  block_linear<kSmallRows>(s_in, SIN, SIN,")),
                ("point_head2.cuh", *_skip("  block_linear<kSmallRows>(s_h1, SHID, SHID,")),
                ("point_head2.cuh", *_skip("  block_linear<kSmallRows>(s_h2, SHID, SHID,"))],
    "ph2_shared": [("point_head2.cuh", *_skip("  tc::gemm<kStages, NT_SQK>(S, LS, GS,")),
                   ("point_head2.cuh", *_skip("  tc::gemm<kStages, NT_SV>(S, LS, GS,")),
                   ("point_head2.cuh", *_skip("  tc::gemm<kStages, NT_ST>(S, LS, GS,"))],
    "ph2_in": [("point_head2.cuh", *_empty_loop(
        "  for (int i = tid; i < RV * XR; i += blockDim.x) {", "RV * XR"))],
    "ph2_pass": [("point_head2.cuh", *_empty_loop(
        "  for (int i = tid; i < R * C2_4; i += blockDim.x) {", "R * C2_4"))],
    "ph2_qkv": [("point_head2.cuh", *_skip("  tc::gemm<kStages, NT_VQK>(X + RT * LX, LX, GV,")),
                ("point_head2.cuh", *_skip("  tc::gemm<kStages, NT_VV>(X + RT * LX, LX, GV,"))],
    "ph2_merge": [("point_head2.cuh", *_skip(
        "  tc::gemm<kStages, NT_C>(QK, LQK, C, nullptr, 0, 0, W + O_WM,"))],
    "ph2_mlp": [("point_head2.cuh", *_skip("  tc::gemm<kStages, NT_C2>(X, LX, GV, Vb, LV, C,")),
                ("point_head2.cuh", *_skip(
                    "  tc::gemm<kStages, NT_C>(QK, LQK, C2, nullptr, 0, 0, W + O_W2,"))],
    "ph2_attn": [("point_head2.cuh", *_empty_loop(
        "  for (int t = tid; t < TP * L * NH; t += blockDim.x) {", "TP * L * NH"))],
    "ph2_ln": [("point_head2.cuh", *_skip("  tc::layernorm<C>(Vb, LV, R, W + O_N1S")),
               ("point_head2.cuh", *_skip("  tc::layernorm<C>(Vb, LV, R, W + O_N2S"))],
    "ph2_rad": [("point_head2.cuh", *_skip("  tc::gemm<kStages, NT_R>(X + RT * LX, LX, XK,")),
                ("point_head2.cuh", *_skip("  block_linear<kSmallRows>(z, LZ, R1,")),
                ("point_head2.cuh", *_skip("  block_linear<kSmallRows>(h2, R2, R2,"))],
    "ph2_softmax": [("point_head2.cuh", *_empty_loop(
        "  for (int p = tid; p < TP; p += blockDim.x) {", "TP"))],
    "ph2f_sim": [("point_head2_fast.cuh", *_skip("      warp_linear<false>(s_in, SIN, SIN,")),
                 ("point_head2_fast.cuh", *_skip("      warp_linear<false>(s_h1, SHID, SHID,")),
                 ("point_head2_fast.cuh", *_skip("      warp_linear<false>(s_h2, SHID, SHID,"))],
    "ph2f_pe": [("point_head2_fast.cuh", *_empty_loop(
        "      for (int i = lt; i < NV * TP * XR; i += kLT) {", "NV * TP * XR"))],
    "ph2f_shared": [("point_head2_fast.cuh", *_skip(
        "    gemm<1, kW, NSH, I::KG, GS, XS, true, 0, XS, true>("))],
    "ph2f_qkv": [("point_head2_fast.cuh", *_skip(
        "    gemm<MT, kW, 3 * C, I::KV, GV, XS, true, 0, XS, true>("))],
    "ph2f_attn": [("point_head2_fast.cuh", *_empty_loop(
        "    for (int it = gt; it < RW * NH; it += kGT) {", "RW * NH"))],
    "ph2f_merge": [("point_head2_fast.cuh", *_skip(
        "    gemm<MT, kW, C, I::KC, C, LD, false, 0, LD, false>("))],
    "ph2f_ln": [("point_head2_fast.cuh", *_skip(
        "    group_layernorm<C, T>(Vb, LD, GR, gt, F + I::N1S, F + I::N1B,")),
                ("point_head2_fast.cuh", *_skip(
        "    group_layernorm<C, T>(Vb, LD, GR, gt, F + I::N2S, F + I::N2B,"))],
    "ph2f_mlp": [("point_head2_fast.cuh", *_skip(
        "    gemm<MT, kW, C2, I::KW1, GV, XS, true, C, KM, true>(")),
                 ("point_head2_fast.cuh", *_skip(
        "    gemm<MT, kW, C, I::KC2, C2, KY, true, 0, KY, true>("))],
    "ph2f_rad": [("point_head2_fast.cuh", "    if (gw < MT) {", "    if (gw < 0 * MT) {")],
    "ph2f_softmax": [("point_head2_fast.cuh", *_empty_loop(
        "    for (int p = gt; p < TP; p += kGT) {", "TP"))],
    "ph2f_probe": [("point_head2_fast.cuh", '#pragma once\n\n#include "point_head2.cuh"',
                    '#pragma once\n#define UFO_PH2F_PROBE\n#include "point_head2.cuh"')],
    "ta_phi": [("tiny_attention.cuh", *_empty_loop(
        "    for (int j = tid; j < tile * rk / 4; j += blockDim.x) {", "tile * rk / 4"))],
    "ta_attend": [("tiny_attention.cuh", *_empty_loop(
        "  for (int idx = threadIdx.x; idx < n * t.l * H; idx += blockDim.x) {",
        "n * t.l * H"))],
    "tb_phi": _TB_PHI, "tb_items": _TB_ITEMS, "tb_sources": _TB_SOURCES,
    "tb_stream": _TB_PHI + _TB_ITEMS + _TB_SOURCES,
    "vf_stream": [("volume_fusion.cu",
                   "        for (int v = 0; v < NV; ++v) acc = __fadd_rn(acc, "
                   "__fmul_rn(x[v][s][f], ws[v]));",
                   "        for (int v = 0; v < NV; ++v) acc += x[v][s][f];"),
                  ("volume_fusion.cu", "        o[s * F + f] = __fdiv_rn(acc, den);",
                   "        o[s * F + f] = acc + den;")],
    "vf_fastdiv": [("volume_fusion.cu", "        o[s * F + f] = __fdiv_rn(acc, den);",
                    "        o[s * F + f] = __fdividef(acc, den);")],
    "vf_direct": [("volume_fusion.cu",
                   "      dst[j] = make_float4(o[4 * j], o[4 * j + 1], o[4 * j + 2], "
                   "o[4 * j + 3]);",
                   "      reinterpret_cast<float4*>(out + p * (S * F))[j] = "
                   "make_float4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);"),
                  ("volume_fusion.cu", *_empty_loop(
                      "  for (int i = threadIdx.x; i < n * (S * F / 4); i += kThreads) "
                      "run[i] = rows[i];", "n * (S * F / 4)"))],
    "rh_kv": [("ray_head.cu", *_empty_loop(
        "    for (int e = tid; e < NH * DK * DK; e += blockDim.x) {", "NH * DK * DK"))],
    "rh_attn": [("ray_head.cu", *_empty_loop(
        "    for (int e = tid; e < rows * NH; e += blockDim.x) {", "rows * NH"))],
    "rh_ln": [("ray_head.cu", *_skip("    tc::layernorm_n<CMAX>(B, LD, rows, C, W + L.o_n1s")),
              ("ray_head.cu", *_skip("    tc::layernorm_n<CMAX>(B, LD, rows, C, W + L.o_n2s"))],
    "rh_density": [("ray_head.cu", *_skip("    block_linear<4, kFast>(X, LD, C, W + L.o_dw0")),
                   ("ray_head.cu", *_skip("    block_linear<4, kFast>(A, D0, D0,"))],
    "rhf_probe": [("ray_head_fast.cuh", "#pragma once\n\n#include <cstdint>",
                   "#pragma once\n#define UFO_RHF_PROBE\n#include <cstdint>")],
    "rhf_state": [("ray_head_fast.cuh", *_empty_loop(
        "        for (int s = 0; s < rows; ++s) {", "rows"))],
    "rhf_kv": [("ray_head_fast.cuh", *_skip(
        "        warp_mma<NT, KS, KC, 0, C>(kf, xa, wrow + I::QKV + C * KC);")),
               ("ray_head_fast.cuh", *_skip(
        "        warp_mma<NT, KS, KC, 0, C>(acc, xa, wrow + I::QKV + 2 * C * KC);"))],
    "rhf_attn": [("ray_head_fast.cuh", *_empty_loop(
        "        for (int m = 0; m < DK; ++m) {", "DK"))],
    "rhf_mlp": [("ray_head_fast.cuh", *_empty_loop(
        "      for (int c16 = 0; c16 < KS2; ++c16) {", "KS2"))],
    "rhf_ln": [("ray_head_fast.cuh", *_skip("      warp_layernorm<C>(scr, F + I::N1S, F + I::N1B);")),
               ("ray_head_fast.cuh", *_skip("      warp_layernorm<C>(scr, F + I::N2S, F + I::N2B);"))],
    # the cluster design's cost (two blocks on neighbouring SMs, each
    # reading half its B fragments from the other's shared memory) at a
    # width whose image fits one SM: clusters of two, and k, v, merge and
    # mlp2 (about half the image's bytes) read from the peer's copy over
    # distributed shared memory; the block's first and last steps a
    # cluster-wide barrier
    "rhf_dsmem": [
        ("ray_head_fast.cuh", "#include <type_traits>",
         "#include <type_traits>\n#include <cooperative_groups.h>"),
        ("ray_head_fast.cuh", "    weights_in = true;\n  };\n",
         "    weights_in = true;\n  };\n"
         "  namespace cg = cooperative_groups;\n"
         "  cg::cluster_group cluster = cg::this_cluster();\n"
         "  wait_weights();\n"
         "  cluster.sync();\n"
         "  const uint16_t* Wp = cluster.map_shared_rank(Ws, (int)cluster.block_rank() ^ 1);\n"
         "  const uint16_t* wprow = Wp + g * KC + 2 * t;\n"
         "  const uint16_t* w2prow = Wp + I::W2 + g * KC2 + 2 * t;\n"),
        ("ray_head_fast.cuh", "(kf, xa, wrow + I::QKV + C * KC);",
         "(kf, xa, wprow + I::QKV + C * KC);"),
        ("ray_head_fast.cuh", "(acc, xa, wrow + I::QKV + 2 * C * KC);",
         "(acc, xa, wprow + I::QKV + 2 * C * KC);"),
        ("ray_head_fast.cuh", "(acc, aa, wrow + I::WM);", "(acc, aa, wprow + I::WM);"),
        ("ray_head_fast.cuh", "(m2, ha, w2row + 16 * c16);", "(m2, ha, w2prow + 16 * c16);"),
        ("ray_head_fast.cuh", "    RHF_MARK(10);\n  }\n}\n",
         "    RHF_MARK(10);\n  }\n  cluster.sync();\n}\n"),
        ("ray_head_fast.cuh",
         "  ray_head_fast_kernel<C, kNeus><<<pairs < sms ? pairs : sms, kThreads, smem, stream>>>(\n"
         "      y, reinterpret_cast<const uint16_t*>(w), srdf, rn, sn, nz);\n",
         "  cudaLaunchConfig_t cfg = {};\n"
         "  cudaLaunchAttribute attr[1];\n"
         "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
         "  attr[0].val.clusterDim.x = 2;\n"
         "  attr[0].val.clusterDim.y = 1;\n"
         "  attr[0].val.clusterDim.z = 1;\n"
         "  cfg.blockDim = dim3(kThreads);\n"
         "  cfg.dynamicSmemBytes = smem;\n"
         "  cfg.stream = stream;\n"
         "  cfg.attrs = attr;\n"
         "  cfg.numAttrs = 1;\n"
         "  int clusters = 0;\n"
         "  cfg.gridDim = dim3(2);\n"
         "  e = cudaOccupancyMaxActiveClusters(&clusters, ray_head_fast_kernel<C, kNeus>, &cfg);\n"
         "  if (e != cudaSuccess) return (int)e;\n"
         "  const int want = (pairs + 1) / 2;\n"
         "  cfg.gridDim = dim3(2 * (want < clusters ? want : clusters));\n"
         "  e = cudaLaunchKernelEx(&cfg, ray_head_fast_kernel<C, kNeus>, y,\n"
         "                         reinterpret_cast<const uint16_t*>(w), srdf, rn, sn, nz);\n"
         "  if (e != cudaSuccess) return (int)e;\n")],
    "rhf_density": [("ray_head_fast.cuh", *_empty_loop(
        "        for (int k = 0; k < C; k += 8) {", "C"))],
}


def replacements(variant: str):
    """The kernel of a variant and its [(file, old, new)] replacements;
    raises on an option it does not know."""
    kernel, *options = variant.split(",")
    if kernel not in SOURCE:
        raise ValueError(f"variant {variant!r}: the kernel is one of {sorted(SOURCE)}")
    out = []
    for opt in options:
        if opt == "fast" and kernel == "rh":
            continue   # an argument of the launch, not a change of the source
        if opt in PATCHES:
            out += PATCHES[opt]
        elif "=" in opt and opt.split("=")[0] in CONSTANTS.get(kernel, {}):
            name, value = opt.split("=")
            old, new = CONSTANTS[kernel][name]
            out.append((SOURCE[kernel], old, new.format(int(value))))
        else:
            raise ValueError(f"variant {variant!r}: unknown option {opt!r}")
    return kernel, out


def rhf_units(width: int):
    """The files of an ``rhf`` variant's library timed at ``width``: the
    entry points (with the C 88 instances), that width's unit, and
    ``rhf_stubs.cu`` (``RHF_STUBS``: the other widths' launches, refused),
    so that a variant compiles one or two widths, not ten."""
    return ("ray_head_fast.cu", *([] if width == 88 else [f"ray_head_fast_{width}.cu"]),
            "rhf_stubs.cu")


# rhf_stubs.cu: every width's launch and probe but the one timed, refused
RHF_STUBS = """#include "ray_head_fast.cuh"
namespace ufo {{
namespace rhf {{
{}
}}  // namespace rhf
}}  // namespace ufo
"""
_RHF_STUB = ("int launch_c{0}(const float*, const float*, float*, int, int, bool, NeusOut, "
             "cudaStream_t) {{ return (int)cudaErrorNotSupported; }}\n"
             "int probe_c{0}(unsigned long long*) {{ return (int)cudaErrorNotSupported; }}")


def _build(variant: str, root: Path, ray_width: int = 88):
    """Starts nvcc on a patched copy of csrc/, one process a source file,
    then the link; returns (process, library)."""
    kernel, subs = replacements(variant)
    d = root / variant.replace(",", "_").replace("=", "")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d)
    for name, old, new in subs:
        text = (d / name).read_text()
        if text.count(old) != 1:
            raise ValueError(f"variant {variant!r}: {old!r} is not once in {name}")
        (d / name).write_text(text.replace(old, new))
    lib = d / "lib.so"
    nvcc = ["nvcc", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "--expt-relaxed-constexpr", "-Xcompiler", "-fPIC"]
    units = [d / u for u in (rhf_units(ray_width) if kernel == "rhf"
                             else UNITS.get(kernel, (SOURCE[kernel],)))]
    if kernel == "rhf":
        (d / "rhf_stubs.cu").write_text(RHF_STUBS.format("\n".join(
            _RHF_STUB.format(c) for c in range(40, 113, 8)
            if c not in (88, ray_width))))
    compile_all = " ".join(
        f"{shlex.join([*nvcc, '-c', str(u), '-o', str(u) + '.o'])} & pids+=($!);" for u in units)
    script = (f"pids=(); {compile_all} for p in ${{pids[@]}}; do wait $p || exit 1; done; "
              + shlex.join([*nvcc, "-shared", "-o", str(lib), *[str(u) + ".o" for u in units]]))
    return subprocess.Popen(["bash", "-c", script], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _device_ms(fn, reps: int = 20) -> float:
    """Mean device time of the port's kernels (``ufo::``) over reps
    launches, from torch.profiler: unlike the CUDA events around a run of
    launches it leaves out the gaps where the card waits for the host,
    which a kernel of ~10 us can show."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and "ufo::" in e.name]
    return sum(us) / len(us) / 1e3 if us else float("nan")


def _ray_params(c: int, gen):
    """Random ray-head weights of width ``c``, drawn as
    ``script/ray_head_times.py`` draws them."""
    from ..ops import fused_ray_head as frh

    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device="cuda") * scale
    w = lambda o, i: randn(o, i, scale=i ** -0.5)
    return frh.RayHeadParams(
        wq=w(c, c), wk=w(c, c), wv=w(c, c), wmerge=w(c, c),
        norm1_scale=1 + randn(c, scale=0.1), norm1_bias=randn(c, scale=0.1),
        w1=w(2 * c, 2 * c), w2=w(c, 2 * c), norm2_scale=1 + randn(c, scale=0.1),
        norm2_bias=randn(c, scale=0.1), dens_w=(w(32, c), w(16, 32), w(1, 16)),
        dens_b=(randn(32, scale=0.1), randn(16, scale=0.1), randn(1, scale=0.1)))


def _cases(seed: int, kernels, ray_width: int = 88):
    """The main path's inputs and weights for these kernels, and the plain
    versions' outputs (the ray heads at ``ray_width``: the default model's
    weights at 88, random ones at another width)."""
    from ..config import Config
    from ..convert import init_weights
    from ..models.uforecon import UFORecon
    from ..ops import fused_point_head as fph
    from ..ops import fused_point_head2 as fph2
    from ..ops import fused_ray_head as frh
    from ..ops import fused_volume_fusion as fvf
    from ..ops import tiny_attention as fta

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    nv, p = 3, 65536
    cases = {}
    with torch.no_grad():
        if {"ph", "phf", "ph2", "ph2f", "rh", "rhf"} & set(kernels):
            model = UFORecon(Config())
            init_weights(model, seed)
            rt = model.ray_transformer.to(dev)
            mask = (rand(nv, p) > 0.3).float()
            inp = fph.PointHeadInputs(
                img_feat=randn(nv, p, 32), vol_feat=randn(p, 24), sim_feat=rand(p, 8) * 2 - 1,
                depth_dist=randn(nv, p, scale=0.3), dir_rel=randn(nv, p, 3, scale=0.1),
                rgb=rand(nv, p, 3), mask=mask)
            ph, rh = rt.point_head_params(), rt.ray_head_params()
            if ray_width != 88:
                rh = _ray_params(ray_width, torch.Generator(device=dev).manual_seed(
                    seed + ray_width))
            ph_ref = fph.point_head_reference(inp, ph)
            ys = {sn: randn(1024, sn, ray_width) for sn in (64, 128)}
            rh_fast = {sn: frh.ray_head_reference(y, rh, precision="fast")
                       for sn, y in ys.items()}
            cases.update(inp=inp, ys=ys, ray_width=ray_width, ph=(fph.pack_weights(ph), ph_ref),
                         phf=(fph.pack_weights(ph, "fast"),
                              fph.point_head_reference(inp, ph, precision="fast")),
                         ph2=(fph2.pack_weights2(ph), ph_ref),
                         ph2f=(fph2.fast_image2(ph),
                               fph2.point_head2_reference(inp, ph, precision="fast")),
                         rh=(frh.pack_weights(rh),
                             {sn: frh.ray_head_reference(y, rh) for sn, y in ys.items()}),
                         rh_fast=(frh.plane_pack(rh, "fast"), rh_fast),
                         rhf=(frh.fast_image(rh), rh_fast))
        if "ta" in kernels:
            qkv = {d: tuple(randn(p, 4, 8, d) for _ in range(3)) for d in (10, 8)}
            cases["ta"] = {d: (x, fta.tiny_linear_attention_reference(*x))
                           for d, x in qkv.items()}
        if "tb" in kernels:
            grads = {l_: tuple(randn(p, l_, 8, 10) for _ in range(4)) for l_ in (4, 6)}
            cases["tb"] = {l_: (x, fta.tiny_linear_attention_backward_reference(*x))
                           for l_, x in grads.items()}
        if "vf" in kernels:
            fws = []
            for _ in range(3):
                fw = randn(nv, 9, p)
                fw[:, 8] = rand(nv, p)
                fws.append(fw.permute(0, 2, 1))   # the sampler's channel-first view
            cases["vf"] = (fws, fvf.volume_fusion_reference(fws))
    return cases


def _bind(kernel, lib):
    """The kernel's C entry point with its argument types."""
    c = ctypes
    if kernel in ("ph", "phf", "ph2"):   # (11 pointers, cv, nv, p, fast, stream)
        fn = getattr(lib, "ufo_point_head2" if kernel == "ph2" else "ufo_point_head")
        types = [c.c_void_p] * 11 + [c.c_int] * 4
    elif kernel == "ph2f":        # (10 pointers, cv, nv, p, stream)
        fn, types = lib.ufo_point_head2_fast, [c.c_void_p] * 10 + [c.c_int] * 3
    elif kernel == "rh":          # ufo_ray_head(y, w, srdf, rn, sn, c, fast, stream)
        fn, types = lib.ufo_ray_head, [c.c_void_p] * 3 + [c.c_int] * 4
    elif kernel == "rhf":         # ufo_ray_head_fast(y, w, srdf, rn, sn, c, stream)
        fn, types = lib.ufo_ray_head_fast, [c.c_void_p] * 3 + [c.c_int] * 3
    elif kernel == "ta":          # ufo_tiny_attention_fwd(q, k, v, o, b, l, s, h, d, m, stream)
        fn, types = lib.ufo_tiny_attention_fwd, [c.c_void_p] * 4 + [c.c_int] * 6
    elif kernel == "tb":          # ufo_tiny_attention_bwd(q, k, v, g, dq, dk, dv, b, l, s, h, d, m, stream)
        fn, types = lib.ufo_tiny_attention_bwd, [c.c_void_p] * 7 + [c.c_int] * 6
    else:                         # ufo_volume_fusion(fw[3], sv, sp, sc, out, nv, p, stream)
        fn, types = lib.ufo_volume_fusion, ([c.c_void_p] + [c.c_longlong] * 3
                                            + [c.c_void_p] + [c.c_int] * 2)
    fn.argtypes, fn.restype = types + [c.c_void_p], c.c_int
    return fn


def _runs(kernel, fn, cases, stream, fast=False):
    """suffix -> (launch, max abs error against the plain version); fast:
    ``rh``'s bf16 instantiation."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    i = ctypes.c_int
    if kernel in ("ph", "phf", "ph2", "ph2f"):
        inp = cases["inp"]
        w, ref = cases[kernel]
        nv, p = inp.img_feat.shape[:2]
        tok, rad = torch.empty(p, 80, device="cuda"), torch.empty(p, 3, device="cuda")
        # no scratch: 3 views take a compiled-in instance
        call = ([*map(ptr, (*inp, w, tok, rad)), i(inp.vol_feat.shape[1]), i(nv), i(p), stream]
                if kernel == "ph2f" else
                [*map(ptr, (*inp, w, tok, rad)), None, i(inp.vol_feat.shape[1]), i(nv), i(p),
                 i(int(kernel == "phf")), stream])
        return {"": (lambda: fn(*call),
                     lambda: max((tok - ref[0]).abs().max().item(),
                                 (rad - ref[1]).abs().max().item()))}
    if kernel == "vf":
        fws, ref = cases["vf"]
        out = torch.empty_like(ref)
        arr = (ctypes.c_void_p * 3)(*[fw.data_ptr() for fw in fws])
        call = [arr, *map(ctypes.c_longlong, fws[0].stride()), ptr(out),
                *map(i, fws[0].shape[:2]), stream]
        return {" NV 3": (lambda: fn(*call), lambda: (out - ref).abs().max().item())}
    runs = {}
    if kernel in ("rh", "rhf"):
        w, ref = cases["rh_fast" if fast else kernel]
        for sn, y in cases["ys"].items():
            srdf = torch.empty(1024, sn, device="cuda")
            call = [ptr(y), ptr(w), ptr(srdf), i(1024), i(sn), i(cases["ray_width"]),
                    *([] if kernel == "rhf" else [i(int(fast))]), stream]
            runs[f" SN {sn}"] = (lambda c=call: fn(*c),
                                 lambda s=srdf, r=ref[sn]: (s - r).abs().max().item())
        return runs
    if kernel == "tb":
        for l_, ((q, k, v, g), ref) in cases["tb"].items():
            outs = [torch.empty_like(t) for t in (q, k, v)]
            call = [*map(ptr, (q, k, v, g, *outs)),
                    *map(i, (q.shape[0], l_, l_, q.shape[2], q.shape[3], v.shape[3])), stream]
            runs[f" L {l_}"] = (lambda c=call: fn(*c),
                                lambda o=outs, r=ref: max((a - b).abs().max().item()
                                                          for a, b in zip(o, r)))
        return runs
    for d, ((q, k, v), ref) in cases["ta"].items():
        o = torch.empty_like(q)
        call = [*map(ptr, (q, k, v, o)), *map(i, (*q.shape[:2], k.shape[1], q.shape[2], d, d)),
                stream]
        runs[f" D {d}"] = (lambda c=call: fn(*c),
                           lambda o=o, r=ref: (o - r).abs().max().item())
    return runs


def _rhf_probe(lib, c):
    """The fast ray head's probe counters (``rhf_probe``) of the instances
    at width ``c``, as a list."""
    probe = (ctypes.c_ulonglong * 16)()
    if lib.ufo_ray_head_fast_probe(c, probe) != 0:
        raise SystemExit("the fast ray head's probe could not be read")
    return list(probe)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+",
                    help="e.g. ph, ph,nogemm, phf, phf,phf_rad, ph2, rh,S=2, ta,I=512, "
                         "tb,tb_stream, vf,T=128")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ray_width", type=int, default=88,
                    help="the ray heads' token width (rh, rhf; 40 .. 112 in steps of 8)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("head_variants needs a CUDA card")
    root = cuda_build.BUILD_DIR / "variants"
    root.mkdir(parents=True, exist_ok=True)
    builds = {v: _build(v, root, args.ray_width) for v in args.variants}
    fns, libs = {}, {}
    for v, (proc, lib) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {v}: nvcc failed\n{log}")
        libs[v] = ctypes.CDLL(str(lib))
        fns[v] = _bind(v.split(",")[0], libs[v])
    cases = _cases(args.seed, {v.split(",")[0] for v in args.variants}, args.ray_width)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"card": card, "ms": {}, "device_ms": {}, "max_abs_err": {}}
    for v, fn in fns.items():
        probe = "rhf_probe" in v.split(",")
        for suffix, (launch, err) in _runs(v.split(",")[0], fn, cases, stream,
                                           "fast" in v.split(",")).items():
            before = _rhf_probe(libs[v], args.ray_width) if probe else None
            if launch() != 0:
                raise SystemExit(f"variant {v}{suffix}: launch refused")
            torch.cuda.synchronize()
            e = err()
            ms, dms = _time_ms(launch), _device_ms(launch)
            out["ms"][v + suffix], out["device_ms"][v + suffix] = ms, dms
            out["max_abs_err"][v + suffix] = e
            print(f"{v}{suffix}: {ms:.4f} ms (device {dms:.4f}), max abs err {e:.3e}",
                  flush=True)
            if probe:
                # block 0's first thread over this case's launches: its rays
                # and phase-2 tiles, its cycles a ray in each phase
                d = [a - b for a, b in zip(_rhf_probe(libs[v], args.ray_width), before)]
                rays = max(d[15], 1)
                out.setdefault("probe_cycles", {})[v + suffix] = {
                    "rays": d[15], "tiles": d[14],
                    "per_ray": dict(zip(RHF_PHASES, (d[i] / rays for i in range(11))))}
                print(f"{v}{suffix}: cycles a ray by phase (block 0, {d[15]} rays, {d[14]} "
                      f"phase-2 tiles): " + "; ".join(f"{n} {d[i] / rays:.0f}"
                                                     for i, n in enumerate(RHF_PHASES)),
                      flush=True)
        if "phf_probe" in v.split(","):
            probe = (ctypes.c_ulonglong * 16)()
            if libs[v].ufo_point_head_fast_probe(probe) != 0:
                raise SystemExit(f"variant {v}: the probe could not be read")
            tiles = max(probe[15], 1)
            out.setdefault("probe_cycles", {})[v] = [probe[i] / tiles for i in range(11)]
            print(f"{v}: cycles a tile by phase (block 0, {tiles} tiles): "
                  + " ".join(f"{probe[i] / tiles:.0f}" for i in range(11)), flush=True)
        if "ph2f_probe" in v.split(","):
            probe = (ctypes.c_ulonglong * 16)()
            if libs[v].ufo_point_head2_fast_probe(probe) != 0:
                raise SystemExit(f"variant {v}: the probe could not be read")
            tiles = max(probe[15], 1)
            out.setdefault("probe_cycles", {})[v] = dict(
                zip(PH2F_PHASES, (probe[i] / tiles for i in range(len(PH2F_PHASES)))))
            print(f"{v}: cycles a tile by phase (block 0, {tiles} tiles): " + "; ".join(
                f"{n} {probe[i] / tiles:.0f}" for i, n in enumerate(PH2F_PHASES)), flush=True)

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
