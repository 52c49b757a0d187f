"""What the ReSTIR DI and GI megakernels share: tiles, reprojection,
frame-shared neighbour offsets, the surface record and the launch helpers.

A tile is ``pick_ray_lanes(B)`` consecutive pixels: ``C / TILE_BLOCK``
blocks of ``TILE_BLOCK`` threads of K4 and K7, without a cluster; of K3, K5
and K6 one block of C threads, or split over a cluster of blocks of
``TILE_BLOCK`` threads where the frame's tiles are too few to fill the card
(``tile_clustered``, ``tile_launch``, ``csrc/tile.cuh``);
``tile_history_index`` is where a tile reads the previous frame's buffers,
``spatial_offsets`` the frame's neighbour offsets, and ``hit_surface`` the
surface record of ``csrc/shading.cuh::surface`` in PyTorch.
``tile_walk_records`` hands K3-K8 the scene's wide BVH, refusing a tree
whose stacks would not fit in one of their blocks.  ``camera_matrices`` is
the (2, 4, 4) camera tensor the kernels read: the frame loops make it, and
the previous proj @ view, once a call, so that the frames launch without a
blocking copy to the card between them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fypraytracer_tpu_torch.core import rng
from fypraytracer_tpu_torch.core.camera import Camera, generate_rays
from fypraytracer_tpu_torch.ops import kernels
from fypraytracer_tpu_torch.ops.hit import hit_payload
from fypraytracer_tpu_torch.ops.traverse import stack_depth, wide_records
from fypraytracer_tpu_torch.render.integrators import fetch_albedo
from fypraytracer_tpu_torch.scene.types import Scene


def pick_ray_lanes(num_pixels: int) -> int:
    """Pixels per tile (megakernel.py:2550-2554): 512 when it divides."""
    for c in (512, 256, 128):
        if num_pixels % c == 0:
            return c
    raise ValueError(f"pixel count {num_pixels} not divisible by 128")


# threads a block of K4, and of K3, K5 and K6 whose tiles are split
# (csrc/tile.cuh::kTileBlock)
TILE_BLOCK = 128
# shared memory a block may hold on sm_90, and what K3's, K5's and K6's blocks
# hold beside their stacks (csrc/tile.cuh::kTileStaticSmem; K4 is held to the
# same room)
BLOCK_SMEM = 232448
TILE_STATIC_SMEM = 8


def stack_fits(threads: int) -> int:
    """The stack entries each thread of a K3-K8 block of ``threads`` gets
    in the block's shared memory."""
    return (BLOCK_SMEM - TILE_STATIC_SMEM) // (8 * threads)


def tile_clustered(num_pixels: int, multiprocessors: int, stack_need: int = 0) -> bool:
    """Whether K3, K5 and K6 split each tile of a frame over a cluster of
    blocks of ``TILE_BLOCK`` threads, rather than run it as one block of C
    threads: where the frame's tiles, one block each, would keep at most
    half of the card's ``multiprocessors`` busy, or where a block of C
    threads cannot hold the tree's stacks.  Timed on an H100 (132
    multiprocessors; PERF.md Findings), both launches in turns at 32, 50,
    72, 98 and 128 tiles of 512: split is faster at 32 tiles on both
    scenes (K5 by 1.1-1.25x, K6 by 1.08-1.19x); one block a tile is as fast
    or faster from 50 tiles on the Cornell box but only from about 98 on
    the 200k-triangle stress scene (split 1.05-1.19x faster at 50 and 72).
    Of the single thresholds, half the multiprocessors (66 tiles) loses
    least over those frames; a threshold that followed the tree would lose
    nothing there, and two scenes are too few to fit one."""
    C = pick_ray_lanes(num_pixels)
    return 2 * (num_pixels // C) <= multiprocessors or stack_need > stack_fits(C)


@functools.lru_cache(maxsize=None)
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_launch(num_pixels: int, clustered: bool) -> dict:
    """How K3, K5 and K6 launch a frame (``csrc/tile.cuh::tile_config``):
    tiles of ``C`` pixels, blocks of ``threads`` (``TILE_BLOCK`` split, C
    not), ``cluster`` blocks to a tile, ``grid`` blocks; K4 launches the
    split grid without the cluster.  Block b's thread i is
    pixel b·threads + i, tile (b // cluster) and lane
    (b % cluster)·threads + i."""
    C = pick_ray_lanes(num_pixels)
    threads = TILE_BLOCK if clustered else C
    return dict(C=C, threads=threads, cluster=C // threads, grid=num_pixels // threads, clustered=clustered)


def pick_tile_launch(scene: Scene, num_pixels: int, device) -> dict:
    """``tile_launch`` of a frame on ``device``, split or not as
    ``tile_clustered`` picks for the card and the scene's tree."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    need = 0 if scene.wide is None else scene.wide.stack_need
    return tile_launch(num_pixels, tile_clustered(num_pixels, _multiprocessors(index), need))


def tile_walk_records(name: str, scene: Scene, threads: int):
    """The scene's wide BVH for K3-K8 (``wide_records``), refused with
    the reason where the stacks of one of their blocks of ``threads``
    (``stack_need`` entries of 8 bytes a thread) would not fit in its
    shared memory."""
    fits = stack_fits(threads)
    if scene.wide is not None and scene.wide.stack_need > fits:
        raise ValueError(f"{name}: the wide BVH needs a stack of {scene.wide.stack_need} entries a thread, and "
                         f"a block of {threads} threads holds {fits} in its {BLOCK_SMEM} bytes of shared memory")
    return wide_records(scene)


def spatial_offsets(frame: int, n: int, radius: float, stream: int) -> list[tuple[int, int]]:
    """The frame's ``n`` neighbour offsets (dx, dy), shared by every pixel,
    drawn from ``path_key(0xD1CE, frame, 0, stream)``: stream 7002 for DI
    (megakernel_restir.py:753-762), 8002 for GI (megakernel_restir_gi.py:
    1521-1529)."""
    key = rng.path_key(torch.tensor([0xD1CE]), int(frame), 0, stream=stream)
    out = []
    for _ in range(n):
        key, (ux, uy) = rng.uniforms(key, 2)
        dx = int(((ux * 2.0 - 1.0) * radius).to(torch.int32))
        dy = int(((uy * 2.0 - 1.0) * radius).to(torch.int32))
        out.append((dx, dy))
    return out


def tile_history_index(camera: Camera, ppv, pos, shade):
    """Where each pixel reads the previous frame's per-pixel buffers, and the
    pixel it reprojects to: ``(q, prev_pix)``, both (B,) int64.

    Each shading pixel reprojects its hit point ``pos`` (B, 3) through the
    previous proj @ view ``ppv`` (an array or a tensor); a tile of C pixels
    reads at ONE offset, rint of the mean offset of its shading pixels
    (summed as integers), clamped to [0, B - C] (megakernel_restir.py:
    327-399, megakernel_restir_gi.py:1095-1129).  A pixel has its own
    history only where ``q == prev_pix``."""
    w, h = camera.width, camera.height
    B = w * h
    C = pick_ray_lanes(B)
    dev = pos.device
    pv = torch.as_tensor(ppv, dtype=torch.float32, device=dev)

    def prow(r):
        return pv[r, 0] * pos[:, 0] + pv[r, 1] * pos[:, 1] + pv[r, 2] * pos[:, 2] + pv[r, 3]

    cx, cy, cw = prow(0), prow(1), prow(3)
    wok = torch.abs(cw) >= 1e-20
    inv_w = 1.0 / torch.where(wok, cw, 1.0)
    u = torch.where(wok, cx * inv_w, 0.0) * 0.5 + 0.5
    v = torch.where(wok, cy * inv_w, 0.0) * 0.5 + 0.5
    ppx = torch.clamp((u * w).to(torch.int32), 0, w - 1)
    ppy = torch.clamp(((1.0 - v) * h).to(torch.int32), 0, h - 1)
    prev_pix = (ppx + ppy * w).to(torch.int64)

    pix = torch.arange(B, device=dev)
    tot = torch.where(shade, prev_pix - pix, 0).reshape(-1, C).sum(1)
    cnt = shade.reshape(-1, C).sum(1)
    off = torch.round(tot.to(torch.float32) / torch.clamp_min(cnt.to(torch.float32), 1.0))
    sc = torch.clamp(torch.arange(B // C, device=dev) * C + off.to(torch.int64), 0, B - C)
    return (sc[:, None] + torch.arange(C, device=dev)[None, :]).reshape(B), prev_pix


def hit_surface(scene: Scene, origins, directions, tri, bounce: bool = False):
    """The frame kernels' surface record (``csrc/shading.cuh::surface``) of
    rays hitting triangles ``tri`` (-1: miss): ``hit``, ``t`` (-1 on a miss),
    ``pos``, ``n``, ``alb``, ``rough``, ``metal`` and ``em`` (emission), zero
    where a ray missed, as the kernels' zeroed record.  A textured albedo is
    fetched from the primary level, or the bounce level where ``bounce``."""
    pay = hit_payload(scene.geometry, origins, directions, tri)
    hit = tri >= 0
    mat = torch.clamp_min(pay["mat"], 0).long()
    mats = scene.materials

    def on_hit(x):
        return torch.where(hit if x.dim() == 1 else hit[:, None], x, 0.0)

    return dict(hit=hit, t=pay["t"], pos=on_hit(pay["position"]), n=on_hit(pay["normal"]),
                alb=on_hit(fetch_albedo(scene, pay["mat"], pay["uv"], bounce=bounce)), rough=on_hit(mats.roughness[mat]),
                metal=on_hit(mats.metallic[mat]), em=on_hit(mats.emission()[mat]))


def camera_rays(camera: Camera, device):
    return generate_rays(camera.inv_projection, camera.inv_view, camera.width, camera.height,
                         device=device)


def camera_matrices(camera: Camera, device) -> torch.Tensor:
    """``[inv_projection, inv_view]`` as the (2, 4, 4) float32 tensor on
    ``device`` that the kernels read."""
    return torch.as_tensor(np.stack([camera.inv_projection, camera.inv_view]), dtype=torch.float32,
                           device=device)


def wide_args(wide):
    """The wide BVH's arguments of a kernel's C interface."""
    P = kernels.ptr
    return P(wide.nodes), P(wide.tris), P(wide.overflow), stack_depth(wide)
