"""Perspective camera (host NumPy) and ray generation on tensors.

A frozen copy of the path tracer's published camera: glm right-handed
``perspectiveFov`` with [-1, 1] clip depth and ``lookAt`` with world up
(0,1,0), and ``generate_rays``, the camera rays on the device from the two
inverse matrices, every step rounded once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpubench.reference.mathutils import dot3, sqrt_rn


def perspective_fov(vfov_deg: float, width: float, height: float, near: float, far: float) -> np.ndarray:
    """glm::perspectiveFov (RH, -1..1 depth), row-major 4x4 (Camera.cpp:125)."""
    rad = np.deg2rad(vfov_deg)
    h = np.cos(0.5 * rad) / np.sin(0.5 * rad)
    w = h * height / width
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def look_at(eye: np.ndarray, center: np.ndarray, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """glm::lookAt (RH), row-major 4x4 (Camera.cpp:132)."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


@dataclasses.dataclass
class Camera:
    """Host-side camera: its matrices and their inverses."""

    position: np.ndarray
    forward: np.ndarray
    vfov_deg: float = 45.0
    near: float = 0.1
    far: float = 100.0
    width: int = 256
    height: int = 256

    def __post_init__(self):
        self.position = np.asarray(self.position, np.float32)
        self.forward = np.asarray(self.forward, np.float32)
        self.forward = self.forward / np.linalg.norm(self.forward)
        self._update()

    def _update(self):
        self.projection = perspective_fov(self.vfov_deg, self.width, self.height, self.near, self.far)
        self.view = look_at(self.position, self.position + self.forward)
        self.inv_projection = np.linalg.inv(self.projection).astype(np.float32)
        self.inv_view = np.linalg.inv(self.view).astype(np.float32)


def generate_rays(inv_projection, inv_view, width: int, height: int, device=None, pixel_x=None,
                  pixel_y=None):
    """Camera rays, (H*W, 3) origins and directions for the full pixel grid,
    or for the pixels ``(pixel_x, pixel_y)`` (integer tensors of one shape,
    row-major ids ``x + y*W`` of any subset) with their
    shape + (3,), each the same bits as the full grid's ray of that pixel.

    Per pixel: ``coord = (x/W, y/H)*2 - 1``; ``target = invProj @
    (cx,cy,1,1)``; ``dir = (invView @ (normalize(target.xyz / target.w),
    0)).xyz``.  Row 0 maps to NDC y = +1 (top of screen), so images are
    top-down.

    Every step rounds once, as the published kernels' camera ray does: the
    divisions by W and H divide by a tensor (PyTorch multiplies a CUDA
    tensor by the reciprocal of a Python scalar divisor, which is not exact
    unless W or H is a power of two), and the norm's root is taken in
    float64 and rounded once (``sqrt_rn``; PyTorch's float32 root on the
    CPU is not correctly rounded for every input).

    ``inv_projection``/``inv_view`` are (4, 4) arrays or tensors; the rays
    are made on ``device`` (default: where ``inv_projection`` lies).
    """
    ip = torch.as_tensor(inv_projection, dtype=torch.float32, device=device)
    iv = torch.as_tensor(inv_view, dtype=torch.float32, device=ip.device)

    if pixel_x is None:
        pix = torch.arange(width * height, device=ip.device)
        pixel_x, pixel_y = pix % width, pix // width
    px = torch.as_tensor(pixel_x, device=ip.device).to(torch.float32)
    py = torch.as_tensor(pixel_y, device=ip.device).to(torch.float32)
    cx = (px / torch.full_like(px, width)) * 2.0 - 1.0
    cy = 1.0 - (py / torch.full_like(py, height)) * 2.0

    tx = ip[0, 0] * cx + ip[0, 1] * cy + ip[0, 2] + ip[0, 3]
    ty = ip[1, 0] * cx + ip[1, 1] * cy + ip[1, 2] + ip[1, 3]
    tz = ip[2, 0] * cx + ip[2, 1] * cy + ip[2, 2] + ip[2, 3]
    tw = ip[3, 0] * cx + ip[3, 1] * cy + ip[3, 2] + ip[3, 3]
    t = torch.stack([tx, ty, tz], dim=-1) / tw[..., None]
    d = t / sqrt_rn(torch.clamp_min(dot3(t, t), 1e-20))

    wx = iv[0, 0] * d[..., 0] + iv[0, 1] * d[..., 1] + iv[0, 2] * d[..., 2]
    wy = iv[1, 0] * d[..., 0] + iv[1, 1] * d[..., 1] + iv[1, 2] * d[..., 2]
    wz = iv[2, 0] * d[..., 0] + iv[2, 1] * d[..., 1] + iv[2, 2] * d[..., 2]
    directions = torch.stack([wx, wy, wz], dim=-1)
    origins = iv[:3, 3].expand_as(directions)
    return origins, directions
