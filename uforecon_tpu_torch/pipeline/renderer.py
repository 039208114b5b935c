"""Full-image rendering: encode once, render ray chunks, on one card or
split along the ray axis over the ranks of a process group.

Counterpart of the JAX package's ``pipeline/renderer.py`` (chunk loop
``:72-108``, the ray-axis ``shard_map`` ``:110-121``, padding ``:138-143``,
``render_depth_view`` / ``finalize_depth_view`` ``:242-300``), without the
brick planner. Rays are padded (edge rows) to a multiple of the chunk
times the ranks (``parallel/sharding.py``; one rank outside a process
group), each rank renders its contiguous share of the chunks in a Python
loop, and rank 0 gathers the rays and cuts them back; the other ranks get
None. Each rank encodes the scene itself (JAX replicates the encoding):
no collective runs inside a render.

Each chunk's uniform draws come from a ``torch.Generator``, or from the
caller (``draws``: one ``(u_coarse, u_fine)`` pair per chunk of the whole
padded ray set; a rank takes its own), so that a test can feed the JAX
package's key schedule (JAX's device ``d`` draws its chunk ``j`` from
``jax.random.split(key, chunks_per_device)[j]``). With the generator,
every rank draws what one rank does (``ops/sampling.chunk_draws`` of
every chunk that holds a ray, in turn) and keeps its chunks' draws, so
views rendered on N ranks equal their renders on one for the same seed,
and the generator leaves each view where one rank's render leaves it.

The chunk follows the JAX rule (``uforecon_tpu/pipeline/renderer.py:35-45``:
512 rays on the merged-volume path, else 1024, raised to ``test_ray_num``
rounded up to 256), keyed off the path the encoding took (its volumes),
where the JAX package reads the config's request.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DEFAULT, resolve_device
from ..models.uforecon import EncoderOutputs, SceneInputs, UFORecon
from ..ops.sampling import chunk_draws
from ..parallel import sharding


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

    def _draws(self, generator: Optional[torch.Generator], chunk: int, n: int,
               first: int, last: int, coarse_only: bool) -> Iterator[Tuple]:
        """Yield the draws of chunks ``first..last-1`` of ``n`` rays padded
        to whole chunks. Every chunk that holds a ray takes ``chunk_draws``
        from ``generator`` in turn, on every rank (another rank's chunks
        are dropped as they are drawn), so that each chunk's draws and the
        generator's end state are one rank's; a chunk of padding alone
        takes 0.5 (its outputs are cut)."""
        samples = self.model.cfg.samples
        for i in range(max(last, -(-n // chunk))):
            if i * chunk < n:
                u = chunk_draws(chunk, samples, generator, self.device, coarse_only)
            else:
                u = tuple(None if v is None else torch.full_like(v, 0.5) for v in u)
            if first <= i < last:
                yield u

    @torch.no_grad()
    def render_rays(self, scene: SceneInputs, enc: EncoderOutputs,
                    ray_d: np.ndarray, near: np.ndarray, far: np.ndarray,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
                    coarse_only: bool = False) -> Optional[Dict[str, np.ndarray]]:
        """Fine-pass rgb (N, 3), depth (N,) and opacity (N,) of N rays
        (the coarse pass's with ``coarse_only``); on ranks other than 0 of
        a process group, None. ``draws``, if given, holds each chunk's
        (u_coarse (chunk, n_coarse), u_fine (chunk, n_fine)), for every
        chunk of the rays padded to a multiple of chunk x ranks."""
        n = ray_d.shape[0]
        chunk = self.chunk_for(enc)
        world, rank = sharding.world_size(), sharding.rank()
        pad = (-n) % (chunk * world)
        n_chunks = (n + pad) // chunk
        if draws is not None and len(draws) != n_chunks:
            raise ValueError(f"{len(draws)} chunks of draws for {n_chunks} chunks")
        first, last = sharding.shard_bounds(n_chunks, rank, world)

        def dev(a):
            a, _ = sharding.pad_to_multiple(np.asarray(a, np.float32), chunk * world)
            return torch.as_tensor(a[first * chunk:last * chunk], device=self.device)

        if draws is None:
            draws = self._draws(generator, chunk, n, first, last, coarse_only)
        else:
            draws = (tuple(torch.as_tensor(np.asarray(u, np.float32), device=self.device)
                           for u in d) for d in draws[first:last])
        rd, nr, fr = dev(ray_d), dev(near), dev(far)
        outs = {"rgb": [], "depth": [], "opacity": []}
        for i, (u_c, u_f) in enumerate(draws):
            sl = slice(i * chunk, (i + 1) * chunk)
            out = self.model.render_chunk(scene, enc, rd[sl], generator,
                                          near_per_ray=nr[sl], far_per_ray=fr[sl],
                                          u_coarse=u_c, u_fine=u_f,
                                          coarse_only=coarse_only)
            for k in outs:
                outs[k].append(out["fine"][k])
        gathered = sharding.gather_rows([torch.cat(v) for v in outs.values()])
        if gathered is None:
            return None
        return {k: v[:n].numpy() for k, v in zip(outs, gathered)}

    def render_depth_view(self, scene: SceneInputs, enc: EncoderOutputs,
                          extras: Dict,
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None
                          ) -> Optional[Dict[str, np.ndarray]]:
        """Depth map + rgb of one full view (extract_geometry path), the
        coarse pass's under ``cfg.test_coarse_only``; None on ranks other
        than 0.

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
        if out is None:
            return None
        h, w = extras["hw"]
        depth_mm = out["depth"] * cam_rd[:, 2] * extras["scale_mat"][0, 0]
        return {
            "depth": depth_mm.reshape(h, w),
            "rgb": out["rgb"].reshape(h, w, 3),
            "opacity": out["opacity"].reshape(h, w),
        }
