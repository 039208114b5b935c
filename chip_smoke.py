#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card, the CUDA toolkit
(``nvcc``), ``ninja`` and no network. In order it:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the port's CUDA kernels from ``uforecon_tpu_torch/csrc``;
  3. kernel phase: each kernel against its plain PyTorch version on the
     card at main-path shapes, with max abs errors and CUDA-event times
     (median of several runs) of kernel and plain version;
  4. slice phase: ``extract_geometry_for_dataset`` on one DTU-scale view
     (800x640, 3 views, 192 hypotheses, 64 + 64 samples, seeded random
     weights), checking the depth map written to disk, that both kernels
     were launched by that run, and that a small ray chunk of the same
     scene agrees with the plain versions run on the CPU;
  5. prints a JSON line of per-kernel results, then the final
     ``{"ok": true, "device": {...}}`` line.
Any failure exits non-zero without printing a result; without a CUDA card
it exits 1 at once.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
# f32 with another summation order; measured on an H100 at 2.4e-6 (token),
# 1.8e-7 (radiance) and 1.9e-6 (srdf), so these keep a 10x margin
TOL = {"token": 2e-5, "radiance": 2e-6, "srdf": 2e-5}
PORT = "uforecon_tpu_torch"
# the JAX reference package, never imported here: the port's name without
# its suffix
JAX_PACKAGE = PORT.removesuffix("_torch")
# kernel -> (its source, the Pallas function it replaces)
KERNEL_SOURCES = {
    "point_head": (f"{PORT}/csrc/point_head.cu",
                   f"{JAX_PACKAGE}/ops/fused_point_head.py:207"),
    "ray_head": (f"{PORT}/csrc/ray_head.cu",
                 f"{JAX_PACKAGE}/ops/fused_ray_head.py:134"),
}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
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


def look_at(eye):
    eye = np.asarray(eye, np.float64)
    z = -eye / np.linalg.norm(eye)
    x = np.cross(z, [0.0, 1.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    e = np.eye(4)
    e[:3, :3] = np.stack([x, y, z])
    e[:3, 3] = -e[:3, :3] @ eye
    return e


def dtu_scale_sample(w=800, h=640, n_views=3, n_depth=192, seed=SEED):
    """One reference-format test sample at DTU scale: 800x640, cameras
    ~660 mm from the object, depth hypotheses from 425 mm at 2.5 x 1.06 mm,
    near/far 425/900 mm, the scene scaled so a 300 mm radius is 1."""
    from uforecon_tpu_torch.ops import camera

    rng = np.random.default_rng(seed)
    radius_mm = 300.0
    f = 1446.0
    k4 = np.eye(4)
    k4[:3, :3] = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
    norm = camera.ndc_normalize_matrix(w, h)
    e_mm, e_s, poses = [], [], []
    for i in range(n_views):
        ang = 0.15 * i
        e = look_at([660.0 * np.sin(ang), 30.0 * i, -660.0 * np.cos(ang)])
        es = e.copy()
        es[:3, 3] /= radius_mm
        e_mm.append(e)
        e_s.append(es)
        poses.append(norm @ k4 @ es)
    e_mm, e_s, poses = (np.stack(a).astype(np.float32) for a in (e_mm, e_s, poses))
    poses_inv = np.stack([np.linalg.inv(p) for p in poses]).astype(np.float32)
    proj = {}
    base = np.zeros((n_views, 2, 4, 4), np.float32)
    base[:, 0] = e_mm
    base[:, 1] = k4
    base[:, 1, :2] /= 4.0
    for s, mult in (("stage1", 1.0), ("stage2", 2.0), ("stage3", 4.0)):
        p = base.copy()
        p[:, 1, :2] *= mult
        proj[s] = p
    hp = camera.homo_pixel_grid(w, h)
    ray_o, ray_d = camera.build_rays(poses_inv[0], hp)
    cam_d = np.linalg.inv(k4[:3, :3]) @ hp[:3]
    cam_ray_d = (cam_d / np.linalg.norm(cam_d, axis=0)).T.astype(np.float32)
    imgs = rng.random((n_views, h, w, 3)).astype(np.float32)
    near, far = 425.0 / radius_mm, 900.0 / radius_mm
    return {
        "source_imgs": imgs, "ref_img": imgs[0], "w2cs": e_s,
        "intrinsics": np.tile(k4[None, :3, :3], (n_views, 1, 1)).astype(np.float32),
        "near_fars": np.tile([[near, far]], (n_views, 1)).astype(np.float32),
        "proj_matrices": proj,
        "depth_values_org_scale": (425.0 + np.arange(n_depth) * 2.5 * 1.06).astype(np.float32),
        "scale_mat": np.diag([radius_mm, radius_mm, radius_mm, 1.0]).astype(np.float32),
        "scale_factor": np.float32(1.0 / radius_mm),
        "ref_pose_inv": poses_inv[0], "source_poses": poses,
        "source_poses_inv": poses_inv, "ray_o": ray_o, "ray_d": ray_d.T.copy(),
        "cam_ray_d": cam_ray_d, "meta": "dtu-scan1-00000000", "start_idx": 0,
    }


def kernel_phase(model, card):
    """Each kernel vs its plain version on the card at main-path shapes."""
    import torch

    from uforecon_tpu_torch.ops import fused_point_head as fph
    from uforecon_tpu_torch.ops import fused_ray_head as frh

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    rt = model.ray_transformer
    results = {}

    # point head: 1024 rays x 64 samples, 3 views; ~30% of (view, point)
    # pairs masked and the first 256 points masked in every view
    nv, p = 3, 1024 * 64
    mask = (torch.rand((nv, p), generator=gen, device=dev) > 0.3).float()
    mask[:, :256] = 0.0
    inp = fph.PointHeadInputs(
        img_feat=randn(nv, p, 32), vol_feat=randn(p, 24),
        sim_feat=torch.rand((p, 8), generator=gen, device=dev) * 2 - 1,
        depth_dist=randn(nv, p, scale=0.3), dir_rel=randn(nv, p, 3, scale=0.1),
        rgb=torch.rand((nv, p, 3), generator=gen, device=dev), mask=mask)
    params = rt.point_head_params()
    with torch.no_grad():
        tok, rad = fph.point_head(inp, params)
        tok_ref, rad_ref = fph.point_head_reference(inp, params)
        torch.cuda.synchronize()
        err_t = (tok - tok_ref).abs().max().item()
        err_r = (rad - rad_ref).abs().max().item()
        masked_mean = inp.rgb[:, :256].mean(0)
        err_masked = (rad[:256] - masked_mean).abs().max().item()
        ms = time_ms(lambda: fph.point_head(inp, params))
        plain_ms = time_ms(lambda: fph.point_head_reference(inp, params))
    log(f"[kernel] point_head P={p} NV={nv}: max|token err| {err_t:.3e} "
        f"(tol {TOL['token']}), max|radiance err| {err_r:.3e} "
        f"(tol {TOL['radiance']}), all-masked points vs mean rgb "
        f"{err_masked:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"[{card}]")
    if not (err_t <= TOL["token"] and err_r <= TOL["radiance"]
            and err_masked <= TOL["radiance"]):
        raise AssertionError("point_head kernel disagrees with its plain version")
    results["point_head"] = {"max_abs_err": max(err_t, err_r), "ms": ms,
                             "plain_ms": plain_ms, "token_err": err_t,
                             "radiance_err": err_r}

    rparams = rt.ray_head_params()
    errs, ms_by, plain_by = [], {}, {}
    for sn in (64, 128):
        y = randn(1024, sn, 88)
        with torch.no_grad():
            s = frh.ray_head(y, rparams)
            s_ref = frh.ray_head_reference(y, rparams)
            torch.cuda.synchronize()
            err = (s - s_ref).abs().max().item()
            ms_by[sn] = time_ms(lambda: frh.ray_head(y, rparams))
            plain_by[sn] = time_ms(lambda: frh.ray_head_reference(y, rparams))
        log(f"[kernel] ray_head (1024, {sn}, 88): max|srdf err| {err:.3e} "
            f"(tol {TOL['srdf']}); kernel {ms_by[sn]:.3f} ms, plain "
            f"{plain_by[sn]:.3f} ms [{card}]")
        if not err <= TOL["srdf"]:
            raise AssertionError(f"ray_head kernel disagrees at SN={sn}")
        errs.append(err)
    # one render chunk launches the ray head once at each SN
    results["ray_head"] = {"max_abs_err": max(errs),
                           "ms": ms_by[64] + ms_by[128],
                           "plain_ms": plain_by[64] + plain_by[128],
                           "ms_by_sn": ms_by, "plain_ms_by_sn": plain_by}
    return results


def slice_phase(model, card):
    """The main path: extract_geometry_for_dataset on one full view."""
    import copy

    import torch

    from uforecon_tpu_torch.data.convert import scene_inputs_from_sample
    from uforecon_tpu_torch.ops.fused_point_head import point_head
    from uforecon_tpu_torch.ops.fused_ray_head import ray_head
    from uforecon_tpu_torch.pipeline.extract import extract_geometry_for_dataset

    sample = dtu_scale_sample()
    with tempfile.TemporaryDirectory() as out_dir:
        point_head.launches = 0
        ray_head.launches = 0
        torch.cuda.reset_peak_memory_stats()
        stats = extract_geometry_for_dataset(model, [sample], out_dir=out_dir,
                                             device="cuda", seed=SEED,
                                             previews=False)
        launches = {"point_head": point_head.launches,
                    "ray_head": ray_head.launches}
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        saved = np.load(os.path.join(out_dir, "depth", "scan1", "00000000.npy"),
                        allow_pickle=True).item()
    depth = saved["depth"]
    log(f"[slice] 1 view 800x640, 3 views, 64+64 samples: encode "
        f"{stats['encode_s']:.3f} s, render {stats['render_s']:.3f} s, "
        f"{stats['rays_per_sec']:.1f} rays/s, peak {peak_gb:.2f} GiB [{card}]")
    log(f"[slice] launches during the run: {launches}")
    if depth.shape != (640, 800) or not np.all(np.isfinite(depth)):
        raise AssertionError(f"depth map {depth.shape}, finite "
                             f"{np.isfinite(depth).mean():.4f}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    log(f"[slice] depth map (640, 800) finite, range "
        f"[{depth.min():.1f}, {depth.max():.1f}] mm")

    # the same scene, one small ray chunk: kernels on the card vs the plain
    # versions on the CPU, with the same draws
    scene, extras = scene_inputs_from_sample(sample, "cuda")
    enc = model.encode(scene)
    rn, sn = 256, model.cfg.coarse_sample
    idx = np.random.default_rng(SEED).choice(len(extras["ray_d"]), rn, replace=False)
    ray_d = torch.as_tensor(extras["ray_d"][idx], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    u_c = torch.rand((rn, sn), generator=gen, device="cuda")
    u_f = torch.rand((rn, model.cfg.fine_sample), generator=gen, device="cuda")
    out_gpu = model.render_chunk(scene, enc, ray_d, u_coarse=u_c, u_fine=u_f)

    def cpu(x):
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[cpu(v) for v in x])
        return x.cpu()

    model_cpu = copy.deepcopy(model).cpu()
    out_cpu = model_cpu.render_chunk(cpu(scene), cpu(enc), ray_d.cpu(),
                                     u_coarse=u_c.cpu(), u_fine=u_f.cpu())
    agree = {}
    for phase in ("coarse", "fine"):
        for key in ("depth", "rgb"):
            a = out_gpu[phase][key].cpu().numpy()
            b = out_cpu[phase][key].numpy()
            ok = np.isclose(a, b, rtol=2e-4, atol=2e-4).reshape(rn, -1).all(axis=1)
            agree[f"{phase}_{key}"] = float(ok.mean())
    log(f"[slice] {rn}-ray chunk, card kernels vs CPU plain versions: share "
        f"of rays within rtol=atol=2e-4: {agree}")
    if min(agree.values()) < 0.99:
        raise AssertionError(f"card and CPU renders disagree: {agree}")
    return stats, launches


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
        from uforecon_tpu_torch.config import Config
        from uforecon_tpu_torch.convert import init_weights
        from uforecon_tpu_torch.models.uforecon import UFORecon
        from uforecon_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the uforecon_tpu_torch package is missing beside "
              f"this script ({e})", file=sys.stderr)
        return 1

    card = card_line()
    log(card)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cuda_build.extension()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    model = UFORecon(Config())
    init_weights(model, SEED)
    model.to("cuda")

    kres = kernel_phase(model, card)
    stats, launches = slice_phase(model, card)

    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        **kres[name]})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
