"""Where the head kernels' time goes: variants of ``csrc/point_head.cu``
and ``csrc/ray_head.cu`` timed apart on one GPU.

    python -m uforecon_tpu_torch.script.head_variants ph ph,nogemm rh rh,rh_ln

Each variant is a copy of ``csrc/`` with a few lines replaced, built by
``nvcc`` (all variants at once) into a shared library with the kernels'
plain C interface, and timed with CUDA events (mean of 20 launches) at the
main path's shapes: the point head at P = 65,536 points and 3 views, the
ray head over 1024 rays of 64 and of 128 samples at width 88, on seeded
random weights and inputs. A variant is a kernel (``ph`` or ``rh``)
followed by comma-separated options:

  NAME=VALUE  a constant of the kernel's source (``CONSTANTS``), e.g.
              ``T=256`` threads a block, ``S=3`` weight-ring slots;
  a patch     of ``PATCHES``: ``nogemm`` skips the tensor-core layers;
              ``onemma`` keeps one of the three 3xTF32 products;
              ``nosync`` drops the per-step sync, ``noload`` the weight
              loads; ``ph_*`` / ``rh_*`` skip one phase of a kernel.

A variant that skips work gives wrong outputs: its max abs error against
the plain version is printed, not checked. The difference between two
variants' times is what the skipped work costs. One line per variant, then
one JSON line with every time. Needs a CUDA card and ``nvcc``; builds go to
``uforecon_tpu_torch/_build/variants/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import cuda_build

SOURCE = {"ph": "point_head.cu", "rh": "ray_head.cu"}
# kernel -> NAME -> (the source's line, its replacement with {} for VALUE)
CONSTANTS = {
    "ph": {"TP": ("constexpr int TP = 16;", "constexpr int TP = {};"),
           "T": ("constexpr int kPointThreads = 320;", "constexpr int kPointThreads = {};"),
           "S": ("constexpr int kStages = 2;", "constexpr int kStages = {};"),
           "LB": ("__launch_bounds__(kPointThreads, 2)", "__launch_bounds__(kPointThreads, {})")},
    "rh": {"T": ("constexpr int kRayThreads = 512;", "constexpr int kRayThreads = {};"),
           "S": ("constexpr int kStages = 2;", "constexpr int kStages = {};")},
}


def _skip(line):
    """(line, the line made dead)."""
    stripped = line.lstrip()
    return line, line[:len(line) - len(stripped)] + "if (0) " + stripped


def _empty_loop(line, bound):
    """(line, the loop made to run no iteration)."""
    return line, line.replace(f"< {bound};", f"< 0 * {bound};")


# patch -> [(file, old, new)]
PATCHES = {
    "nogemm": [("tc_gemm.cuh", '  static_assert(kStages >= 2, "the ring needs two slots or more");',
                '  static_assert(kStages >= 2, "the ring needs two slots or more");\n'
                '  if (threadIdx.x < 100000) return;')],
    "onemma": [("tc_gemm.cuh", "          mma(acc[j], alo, bh0, bh1);\n"
                "          mma(acc[j], ahi, bl0, bl1);\n", "")],
    "nosync": [("tc_gemm.cuh", "      cp_async_wait<kStages - 2>();\n", ""),
               ("tc_gemm.cuh", "      // s - 1, whose slot the prefetch below refills\n"
                "      __syncthreads();\n", "")],
    "noload": [("tc_gemm.cuh", "      if (s + kStages - 1 < steps) load(s + kStages - 1);",
                "      if (s + kStages - 1 < steps && s < 0) load(s + kStages - 1);")],
    "ph_sim": [("point_head.cu", *_skip("  block_linear<4>(s_in, SIN, SIN,")),
               ("point_head.cu", *_skip("  block_linear<4>(s_h1, SH, SH,")),
               ("point_head.cu", *_skip("  block_linear<4>(s_h2, SH, SH,"))],
    "ph_rad": [("point_head.cu", *_skip("  block_linear<4>(z, CR, CR,")),
               ("point_head.cu", *_skip("  block_linear<4>(h1, R1, R1,")),
               ("point_head.cu", *_skip("  block_linear<4>(h2, R2, R2,"))],
    "ph_attn": [("point_head.cu", *_empty_loop(
        "  for (int t = tid; t < R * NH; t += blockDim.x) {", "R * NH"))],
    "ph_ln": [("point_head.cu", *_skip("  tc::layernorm<C>(Kb, LD, R, W + O_N1S")),
              ("point_head.cu", *_skip("  tc::layernorm<C>(Kb, LD, R, W + O_N2S"))],
    "ph_pe": [("point_head.cu", *_empty_loop(
        "  for (int i = tid; i < NV * TP * CT; i += blockDim.x) {", "NV * TP * CT"))],
    "ph_softmax": [("point_head.cu", *_empty_loop(
        "  for (int p = tid; p < TP; p += blockDim.x) {", "TP"))],
    "rh_kv": [("ray_head.cu", *_empty_loop(
        "  for (int t = tid; t < NH * DK * DK; t += blockDim.x) {", "NH * DK * DK"))],
    "rh_attn": [("ray_head.cu", *_empty_loop(
        "  for (int t = tid; t < SN * NH; t += blockDim.x) {", "SN * NH"))],
    "rh_ln": [("ray_head.cu", *_skip("  tc::layernorm<C>(B, LD, SN, W + Wd::O_N1S")),
              ("ray_head.cu", *_skip("  tc::layernorm<C>(B, LD, SN, W + Wd::O_N2S"))],
    "rh_density": [("ray_head.cu", *_skip("  block_linear<4>(X, LD, C, W + Wd::O_DW0")),
                   ("ray_head.cu", *_skip("  block_linear<4>(A, D0, D0,"))],
}


def replacements(variant: str):
    """The kernel of a variant and its [(file, old, new)] replacements;
    raises on an option it does not know."""
    kernel, *options = variant.split(",")
    if kernel not in SOURCE:
        raise ValueError(f"variant {variant!r}: the kernel is ph or rh")
    out = []
    for opt in options:
        if opt in PATCHES:
            out += PATCHES[opt]
        elif "=" in opt and opt.split("=")[0] in CONSTANTS[kernel]:
            name, value = opt.split("=")
            old, new = CONSTANTS[kernel][name]
            out.append((SOURCE[kernel], old, new.format(int(value))))
        else:
            raise ValueError(f"variant {variant!r}: unknown option {opt!r}")
    return kernel, out


def _build(variant: str, root: Path):
    """Starts nvcc on a patched copy of csrc/; returns (process, library)."""
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
    cmd = ["nvcc", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "--expt-relaxed-constexpr", "-shared", "-Xcompiler", "-fPIC", "-o",
           str(lib), str(d / SOURCE[kernel])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


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


def _cases(seed: int):
    """The main path's inputs and weights, and the plain versions' outputs."""
    from ..config import Config
    from ..convert import init_weights
    from ..models.uforecon import UFORecon
    from ..ops import fused_point_head as fph
    from ..ops import fused_ray_head as frh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    model = UFORecon(Config())
    init_weights(model, seed)
    rt = model.ray_transformer.to(dev)
    nv, p = 3, 65536
    mask = (rand(nv, p) > 0.3).float()
    inp = fph.PointHeadInputs(
        img_feat=randn(nv, p, 32), vol_feat=randn(p, 24), sim_feat=rand(p, 8) * 2 - 1,
        depth_dist=randn(nv, p, scale=0.3), dir_rel=randn(nv, p, 3, scale=0.1),
        rgb=rand(nv, p, 3), mask=mask)
    ph, rh = rt.point_head_params(), rt.ray_head_params()
    ys = {sn: randn(1024, sn, 88) for sn in (64, 128)}
    with torch.no_grad():
        ph_ref = fph.point_head_reference(inp, ph)
        rh_ref = {sn: frh.ray_head_reference(y, rh) for sn, y in ys.items()}
    return inp, fph.pack_weights(ph), ph_ref, ys, frh.pack_weights(rh), rh_ref


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", help="e.g. ph, ph,nogemm, rh,S=2")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("head_variants needs a CUDA card")
    root = cuda_build.BUILD_DIR / "variants"
    root.mkdir(parents=True, exist_ok=True)
    builds = {v: _build(v, root) for v in args.variants}
    libs = {}
    for v, (proc, lib) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {v}: nvcc failed\n{log}")
        libs[v] = lib = ctypes.CDLL(str(lib))
        if v.startswith("ph"):    # ufo_point_head(10 pointers, nv, p, stream)
            fn, types = lib.ufo_point_head, [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
        else:                     # ufo_ray_head(y, w, srdf, rn, sn, c, stream)
            fn, types = lib.ufo_ray_head, [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        fn.argtypes, fn.restype = types + [ctypes.c_void_p], ctypes.c_int
    inp, w_ph, ph_ref, ys, w_rh, rh_ref = _cases(args.seed)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    nv, p = inp.img_feat.shape[:2]
    out = {"card": torch.cuda.get_device_name(0), "ms": {}, "max_abs_err": {}}
    for v, lib in libs.items():
        if v.startswith("ph"):
            tok, rad = torch.empty(p, 80, device="cuda"), torch.empty(p, 3, device="cuda")
            call = [*map(ptr, (*inp, w_ph, tok, rad)), ctypes.c_int(nv), ctypes.c_int(p), stream]
            runs = {"": (lambda: lib.ufo_point_head(*call),
                         lambda: max((tok - ph_ref[0]).abs().max().item(),
                                     (rad - ph_ref[1]).abs().max().item()))}
        else:
            runs = {}
            for sn, y in ys.items():
                srdf = torch.empty(1024, sn, device="cuda")
                call = [ptr(y), ptr(w_rh), ptr(srdf), ctypes.c_int(1024), ctypes.c_int(sn),
                        ctypes.c_int(88), stream]
                runs[f" SN {sn}"] = (lambda c=call: lib.ufo_ray_head(*c),
                                     lambda s=srdf, r=rh_ref[sn]: (s - r).abs().max().item())
        for suffix, (launch, err) in runs.items():
            if launch() != 0:
                raise SystemExit(f"variant {v}{suffix}: launch refused")
            torch.cuda.synchronize()
            e = err()
            ms = _time_ms(launch)
            out["ms"][v + suffix], out["max_abs_err"][v + suffix] = ms, e
            print(f"{v}{suffix}: {ms:.4f} ms, max abs err {e:.3e}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
