"""End-to-end learning check on a synthetic textured sphere, through the port.

    python -m uforecon_tpu_torch.script.learn_sanity [--mvs_steps 120] \\
        [--render_steps 300] [--dtype bfloat16] [--mesh_eval] [--resume] \\
        [--logdir DIR] [--device cpu]

A copy of the repository's ``script/learn_sanity.py`` on the port, with
the same scene, settings and pass rule:
  1. raytrace a textured sphere from a ring of cameras (consistent
     multi-view rgb and ground-truth depth, in the reference sample format);
  2. pretrain the cascade matcher on the ground-truth depth
     (``pipeline/fit.pretrain_mvs``);
  3. train the render side (``pipeline/fit.fit``: matcher frozen, rgb and
     depth losses);
  4. render the reference view of sample 0 and take its depth L1 against
     the analytic depth, in units of the depth span, before and after (3).
It passes when the trained L1 is below 0.6x the untrained one; with
``--mesh_eval`` also when the TSDF mesh of every view's rendered depth
(``fusion/tsdf.py``, its largest component, ``postproc/clean_mesh.py``)
lies within 10 % of the radius of the sphere, both ways (accuracy and
completeness). It prints one JSON line and exits 0 on a pass.
After training, the renders take the trainer's kernel precision (``high``),
as the JAX package's process does; ``--resume`` skips training and scores
the latest checkpoint under ``--logdir`` at the extract default (``fast``).
Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from ..config import Config
from ..convert import load_state
from ..data.convert import scene_inputs_from_sample
from ..device import resolve_device
from ..models.uforecon import UFORecon
from ..ops import camera
from ..pipeline.checkpoint import CheckpointManager, load_eval_variables
from ..pipeline.fit import fit, pretrain_mvs
from ..pipeline.renderer import SceneRenderer

SPHERE_R = 0.9
CAM_R = 4.0
NEAR, FAR = CAM_R - 1.2, CAM_R + 1.2


def _look_at(eye):
    eye = np.asarray(eye, np.float64)
    z = -eye / np.linalg.norm(eye)
    x = np.cross(z, [0.0, 1.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    e = np.eye(4)
    e[:3, :3] = np.stack([x, y, z])
    e[:3, 3] = -e[:3, :3] @ eye
    return e.astype(np.float32)


def _sphere_trace(ray_o, ray_d):
    """Ray parameter t of the first sphere hit; 0 where the ray misses."""
    o = np.broadcast_to(np.asarray(ray_o, np.float64), ray_d.shape)
    d = np.asarray(ray_d, np.float64)
    a = np.sum(d * d, -1)
    b = 2.0 * np.sum(o * d, -1)
    c = np.sum(o * o, -1) - SPHERE_R ** 2
    disc = b * b - 4 * a * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
    hit &= t > 0
    return np.where(hit, t, 0.0).astype(np.float32), hit


def _shade(points, hit):
    n = points / SPHERE_R
    u = np.arctan2(n[..., 0], n[..., 2])
    v = np.arccos(np.clip(n[..., 1], -1, 1))
    tex = 0.5 + 0.22 * np.sin(9 * u) * np.sin(8 * v) + 0.18 * np.sin(23 * u + 17 * v)
    light = np.clip(n @ np.array([0.35, -0.5, -0.79]), 0.15, 1.0)
    img = np.empty(points.shape[:-1] + (3,), np.float32)
    img[..., 0] = np.where(hit, tex * light, 0.08)
    img[..., 1] = np.where(hit, (1.0 - tex) * light, 0.10)
    img[..., 2] = np.where(hit, (0.4 + 0.3 * np.sin(5 * u)) * light, 0.12)
    return np.clip(img, 0, 1)


def build_scene_views(n_total, h, w):
    """Raytrace every camera of the ring once; per-view dicts."""
    f = float(w)
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    k4 = np.eye(4, dtype=np.float32)
    k4[:3, :3] = k
    norm = camera.ndc_normalize_matrix(w, h)
    hp = camera.homo_pixel_grid(w, h)
    views = []
    for i in range(n_total):
        ang = 2 * np.pi * i / n_total
        eye = np.array([CAM_R * np.sin(ang), 0.35 * np.sin(2.1 * i + 0.5),
                        -CAM_R * np.cos(ang)])
        eye *= CAM_R / np.linalg.norm(eye)
        e = _look_at(eye)
        pose_ndc = (norm @ k4 @ e).astype(np.float32)
        ray_o, ray_d = camera.build_rays(np.linalg.inv(pose_ndc), hp)
        ray_d = np.asarray(ray_d.T, np.float32).reshape(h, w, 3)
        t, hit = _sphere_trace(ray_o, ray_d)
        pts = np.asarray(ray_o)[None, None] + t[..., None] * ray_d
        img = _shade(pts, hit)
        # camera-frame z-depth for the MVS supervision
        pts_cam = pts @ e[:3, :3].T + e[:3, 3]
        zdepth = np.where(hit, pts_cam[..., 2], 0.0).astype(np.float32)
        cam_d = np.linalg.inv(k) @ np.asarray(hp)[:3]
        cam_ray_d = (cam_d / np.linalg.norm(cam_d, axis=0)).T.astype(np.float32)
        views.append(dict(E=e, pose_ndc=pose_ndc, K=k,
                          ray_o=np.asarray(ray_o, np.float32),
                          ray_d=ray_d.reshape(-1, 3), img=img,
                          t_depth=t, zdepth=zdepth, cam_ray_d=cam_ray_d))
    return views


def make_sample(views, ref, srcs, ndepth):
    """A sample in the reference format, start_idx 1."""
    vs = [views[i] for i in [ref] + list(srcs)]
    poses = np.stack([v["pose_ndc"] for v in vs])
    extrs = np.stack([v["E"] for v in vs])
    k = vs[0]["K"]
    n_src = len(srcs)
    base = np.zeros((n_src, 2, 4, 4), np.float32)
    for i in range(n_src):
        base[i, 0] = extrs[1 + i]
        ks = np.eye(4, dtype=np.float32)
        ks[:3, :3] = k
        ks[:2] /= 4
        base[i, 1] = ks
    proj = {}
    for s, mult in [(1, 1.0), (2, 2.0), (3, 4.0)]:
        p = base.copy()
        p[:, 1, :2] *= mult
        proj[f"stage{s}"] = p
    return {
        "source_imgs": np.stack([v["img"] for v in vs[1:]]),
        "ref_img": vs[0]["img"],
        "w2cs": extrs,
        "intrinsics": np.tile(k[None], (len(vs), 1, 1)),
        "near_fars": np.tile(np.array([[NEAR, FAR]], np.float32), (len(vs), 1)),
        "proj_matrices": proj,
        "depth_values_org_scale": np.linspace(NEAR, FAR, ndepth).astype(np.float32),
        "depths_h": np.stack([v["t_depth"] for v in vs]),
        "depths_mm": np.stack([v["zdepth"] for v in vs]),
        "scale_mat": np.eye(4, dtype=np.float32),
        "scale_factor": np.float32(1.0),
        "ref_pose": poses[0],
        "ref_pose_inv": np.linalg.inv(poses[0]),
        "source_poses": poses[1:],
        "source_poses_inv": np.stack([np.linalg.inv(p) for p in poses[1:]]),
        "ray_o": vs[0]["ray_o"],
        "ray_d": vs[0]["ray_d"],
        "cam_ray_d": vs[0]["cam_ray_d"],
        "meta": f"sanity-sphere-{ref:08d}",
        "start_idx": 1,
    }


class SphereDataset:
    """Sample i: view i as the reference, the next n_src views as sources."""

    def __init__(self, views, n_src, ndepth):
        self.views = views
        self.n_src = n_src
        self.ndepth = ndepth

    def __len__(self):
        return len(self.views)

    def __getitem__(self, i):
        n = len(self.views)
        return make_sample(self.views, i, [(i + 1 + k) % n for k in range(self.n_src)],
                           self.ndepth)


def make_renderer(model: UFORecon, device, precision: str = "auto") -> SceneRenderer:
    """A renderer of the extract path (test sample counts) on the same
    weights, its head kernels at ``precision``. After training, the caller
    passes the trainer's resolved mode: the JAX package's process keeps the
    mode its training kernels traced under (``high``), where a fresh
    extract model's ``auto`` would give ``fast``."""
    return SceneRenderer(model.with_knobs(extract_geometry=True,
                                          kernel_precision=precision),
                         device, chunk=1024)


def _render_depth(renderer: SceneRenderer, sample, seed: int):
    scene, extras = scene_inputs_from_sample(sample, renderer.device)
    with torch.no_grad():
        enc = renderer.model.encode(scene)
    n = extras["ray_d"].shape[0]
    gen = torch.Generator(device=renderer.device).manual_seed(seed)
    return renderer.render_rays(scene, enc, extras["ray_d"], np.full(n, NEAR, np.float32),
                                np.full(n, FAR, np.float32), gen), extras


def render_depth_error(renderer: SceneRenderer, sample, seed: int = 0) -> float:
    """The rendered reference view's masked depth L1 against the analytic
    depth, in units of the depth span."""
    out, _ = _render_depth(renderer, sample, seed)
    gt = sample["depths_h"][0].reshape(-1)
    m = gt > 0
    return float(np.abs(out["depth"][m] - gt[m]).mean() / (FAR - NEAR))


def mesh_eval(renderer: SceneRenderer, ds) -> dict:
    """Fuse every view's rendered depth into a TSDF mesh; score its
    vertices against the sphere both ways (the DTU accuracy /
    completeness split)."""
    from scipy.spatial import cKDTree

    from ..fusion.tsdf import TSDFVolume
    from ..postproc.clean_mesh import _compact, face_connected_components

    m = 1.12 * SPHERE_R
    vol = TSDFVolume(np.array([[-m, m], [-m, m], [-m, m]]), voxel_size=2 * m / 128,
                     margin=5, device=renderer.device)
    for i in range(len(ds)):
        sample = ds[i]
        out, extras = _render_depth(renderer, sample, i)
        h, w = sample["ref_img"].shape[:2]
        # ray parameter t -> camera z-depth: z = t * (R_cam_z . ray_d_world)
        dz = extras["ray_d"] @ sample["w2cs"][0][2, :3]
        zdepth = (out["depth"] * dz).reshape(h, w)
        # rays the model marked empty, and background rays next to the
        # silhouette (confident but untrained depth), are masked, as the
        # reference's masked path does
        zdepth = np.where(out["opacity"].reshape(h, w) > 0.5, zdepth, 0.0)
        zdepth = np.where(sample["depths_h"][0] > 0, zdepth, 0.0)
        c2w = np.linalg.inv(sample["w2cs"][0]).astype(np.float32)
        vol.integrate(zdepth.astype(np.float32), sample["intrinsics"][0].astype(np.float32),
                      c2w)
    verts, faces, _ = vol.get_mesh()
    if len(verts) == 0:
        return {"mesh_verts": 0, "mesh_pass": False}
    # the dominant connected component (clean_mesh.py:249-267's analog):
    # background rays with confident but untrained depth leave islands
    comp = face_connected_components(np.asarray(faces))
    verts, faces = _compact(verts, np.asarray(faces)[comp == np.bincount(comp).argmax()])
    d_acc = np.abs(np.linalg.norm(verts, axis=1) - SPHERE_R)
    dirs = np.random.default_rng(0).standard_normal((2000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    d_comp, _ = cKDTree(verts).query(dirs * SPHERE_R)
    return {
        "mesh_verts": int(len(verts)),
        "mesh_acc_mean": round(float(d_acc.mean()), 4),
        "mesh_comp_mean": round(float(d_comp.mean()), 4),
        "mesh_pass": bool(d_acc.mean() < 0.1 * SPHERE_R and d_comp.mean() < 0.1 * SPHERE_R),
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("uforecon_tpu_torch.script.learn_sanity")
    ap.add_argument("--h", type=int, default=128)
    ap.add_argument("--w", type=int, default=160)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--n_src", type=int, default=3)
    ap.add_argument("--ndepth", type=int, default=64)
    ap.add_argument("--mvs_steps", type=int, default=120)
    ap.add_argument("--render_steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="compute_dtype: the bfloat16 row trains the volume head "
                         "and the ray transformer in bf16 (the matcher follows), "
                         "and this gates its learning end to end")
    ap.add_argument("--logdir", type=str,
                    default=os.path.join(tempfile.gettempdir(), "learn_sanity"))
    ap.add_argument("--mesh_eval", action="store_true",
                    help="also TSDF-fuse all views and score the mesh against "
                         "the analytic sphere")
    ap.add_argument("--resume", action="store_true",
                    help="skip training; score the latest checkpoint under logdir")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def build_config(args: argparse.Namespace) -> Config:
    """The script's training configuration (the JAX script's)."""
    return Config(ndepths=(24, 16, 8), numdepth=args.ndepth, coarse_sample=32,
                  fine_sample=32, test_sample_coarse=32, test_sample_fine=32,
                  train_ray_num=512, train_n_view=args.n_src + 1, uforecon_lr=args.lr,
                  compute_dtype=args.dtype, logdir=args.logdir, exp_name="sanity",
                  max_epochs=1)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = build_config(args)

    print(f"raytracing {args.views} views at {args.w}x{args.h}...", flush=True)
    ds = SphereDataset(build_scene_views(args.views, args.h, args.w), args.n_src,
                       args.ndepth)

    if args.resume:
        mgr = CheckpointManager(os.path.join(args.logdir, cfg.exp_name, "ckpt"))
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint to resume from in {mgr.dir}")
        model = UFORecon(cfg)
        load_state(model, load_eval_variables(mgr.path(step)))
        model.to(device)
        print(f"restored step {step}", flush=True)
        renderer = make_renderer(model, device)
        result = {"resumed_step": int(step),
                  "depth_l1": round(render_depth_error(renderer, ds[0]), 4),
                  "kernel_precision": renderer.model.kernel_precision}
        if args.mesh_eval:
            result.update(mesh_eval(renderer, ds))
        print(json.dumps(result))
        return 0 if result.get("mesh_pass", True) else 1

    print("stage 1: MVS pretraining...", flush=True)
    state = pretrain_mvs(cfg, train_ds=ds, max_steps=args.mvs_steps, log_every=20,
                         n_workers=2, device=device)
    renderer = make_renderer(state.model, device, state.model.kernel_precision)
    err0 = render_depth_error(renderer, ds[0])
    print(f"depth L1 (pre render-training): {err0:.4f} of depth span", flush=True)

    print("stage 2: render-head training...", flush=True)
    fit(cfg, train_ds=ds, val_ds=[ds[0]], model=state.model, max_steps=args.render_steps,
        val_every=args.render_steps, log_every=25, n_workers=2, device=device)
    err1 = render_depth_error(renderer, ds[0])
    result = {
        "depth_l1_before": round(err0, 4),
        "depth_l1_after": round(err1, 4),
        "improvement": round(err0 / max(err1, 1e-9), 2),
        "pass": bool(err1 < err0 * 0.6),
        "kernel_precision": renderer.model.kernel_precision,
    }
    if args.mesh_eval:
        result.update(mesh_eval(renderer, ds))
    print(json.dumps(result))
    return 0 if result["pass"] and result.get("mesh_pass", True) else 1


if __name__ == "__main__":
    sys.exit(main())
