"""Full-image rendering on one device: encode once, render ray chunks.

Counterpart of the JAX package's ``pipeline/renderer.py`` (chunk loop
``:72-108``, ``render_depth_view`` / ``finalize_depth_view`` ``:242-300``),
without the device mesh and the brick planner. Rays are padded (edge
rows) to a multiple of the chunk, rendered chunk by chunk in a Python
loop, and cut back.

Each chunk's uniform draws come from a ``torch.Generator``, or from the
caller (``draws``: one ``(u_coarse, u_fine)`` pair per chunk), so that a
test can feed the JAX package's key schedule.

The chunk follows the JAX rule (``uforecon_tpu/pipeline/renderer.py:35-45``:
512 rays on the merged-volume path, else 1024, raised to ``test_ray_num``
rounded up to 256), keyed off the path the encoding took (its volumes),
where the JAX package reads the config's request.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DEFAULT, resolve_device
from ..models.uforecon import EncoderOutputs, SceneInputs, UFORecon


def chunk_size(test_ray_num: int, merged: bool) -> int:
    """Rays per render chunk: 512 on the merged-volume path, else 1024,
    raised to ``test_ray_num`` rounded up to 256."""
    return max(512 if merged else 1024, int(np.ceil(test_ray_num / 256)) * 256)


class SceneRenderer:
    """Holds the model, its device (the card unless the caller asks for the
    CPU) and the ray-chunk size (``chunk``, or ``chunk_size`` of the
    encoding's path)."""

    def __init__(self, model: UFORecon, device=DEFAULT, chunk: Optional[int] = None):
        self.model = model
        self.device = resolve_device(device)
        self.chunk = chunk

    def chunk_for(self, enc: EncoderOutputs) -> int:
        """The chunk of a render of ``enc``."""
        return self.chunk or chunk_size(self.model.cfg.test_ray_num,
                                        "merged" in enc.volumes)

    @torch.no_grad()
    def render_rays(self, scene: SceneInputs, enc: EncoderOutputs,
                    ray_d: np.ndarray, near: np.ndarray, far: np.ndarray,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
                    coarse_only: bool = False) -> Dict[str, np.ndarray]:
        """Fine-pass rgb (N, 3), depth (N,) and opacity (N,) of N rays
        (the coarse pass's with ``coarse_only``). ``draws``, if given, holds
        each chunk's (u_coarse (chunk, n_coarse), u_fine (chunk, n_fine))."""
        n = ray_d.shape[0]
        chunk = self.chunk_for(enc)
        pad = (-n) % chunk
        n_chunks = (n + pad) // chunk
        if draws is not None and len(draws) != n_chunks:
            raise ValueError(f"{len(draws)} chunks of draws for {n_chunks} chunks")

        def dev(a):
            a = np.asarray(a, np.float32)
            if pad:
                a = np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1), mode="edge")
            return torch.as_tensor(a, device=self.device)

        rd, nr, fr = dev(ray_d), dev(near), dev(far)
        outs = {"rgb": [], "depth": [], "opacity": []}
        for i in range(n_chunks):
            sl = slice(i * chunk, (i + 1) * chunk)
            u_c = u_f = None
            if draws is not None:
                u_c, u_f = (torch.as_tensor(np.asarray(u, np.float32), device=self.device)
                            for u in draws[i])
            out = self.model.render_chunk(scene, enc, rd[sl], generator,
                                          near_per_ray=nr[sl], far_per_ray=fr[sl],
                                          u_coarse=u_c, u_fine=u_f,
                                          coarse_only=coarse_only)
            for k in outs:
                outs[k].append(out["fine"][k])
        return {k: torch.cat(v)[:n].cpu().numpy() for k, v in outs.items()}

    def render_depth_view(self, scene: SceneInputs, enc: EncoderOutputs,
                          extras: Dict,
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None
                          ) -> Dict[str, np.ndarray]:
        """Depth map + rgb of one full view (extract_geometry path), the
        coarse pass's under ``cfg.test_coarse_only``.

        Per-ray near/far are divided by the camera-frame ray z (ray
        distance -> z-depth bounds); the rendered ray distance is turned
        back into z-depth and scaled to millimetres by scale_mat[0, 0]
        (reference model.py:814-826)."""
        ray_d = np.asarray(extras["ray_d"])
        cam_rd = np.asarray(extras["cam_ray_d"])
        n = ray_d.shape[0]
        near = np.full(n, float(scene.near), np.float32) / cam_rd[:, 2]
        far = np.full(n, float(scene.far), np.float32) / cam_rd[:, 2]
        out = self.render_rays(scene, enc, ray_d, near, far, generator, draws,
                               coarse_only=self.model.cfg.test_coarse_only)
        h, w = extras["hw"]
        depth_mm = out["depth"] * cam_rd[:, 2] * extras["scale_mat"][0, 0]
        return {
            "depth": depth_mm.reshape(h, w),
            "rgb": out["rgb"].reshape(h, w, 3),
            "opacity": out["opacity"].reshape(h, w),
        }
