"""The plain reference's scene arrays: triangle soup, materials, light tree.

Host arrays are NumPy; ``RefScene.to(device, dtype)`` puts every float
array on ``device`` in ``dtype`` (float32 for the reference, a lower
precision for its control) and every index array as int32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

Array = Any


def _leaf(x, device, dtype):
    t = torch.as_tensor(np.ascontiguousarray(x), device=device)
    return t.to(dtype) if t.is_floating_point() else t


def _to(obj, device, dtype, meta=()):
    kw = {f.name: getattr(obj, f.name) if f.name in meta else _leaf(getattr(obj, f.name), device, dtype)
          for f in dataclasses.fields(obj)}
    return type(obj)(**kw)


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    albedo: Array          # (M, 3)
    roughness: Array       # (M,)
    metallic: Array        # (M,)
    emission_color: Array  # (M, 3)
    emission_power: Array  # (M,)

    def emission(self):
        return self.emission_color * self.emission_power[..., None]


@dataclasses.dataclass(frozen=True)
class Geometry:
    positions: Array   # (V, 3)
    normals: Array     # (V, 3)
    uvs: Array         # (V, 2)
    tri_v: Array       # (T, 3) i32
    tri_mat: Array     # (T,)   i32


@dataclasses.dataclass(frozen=True)
class LightTreeArrays:
    """Flat light tree in preorder with child and parent links."""

    energy: Array
    axis: Array
    theta_o: Array
    theta_e: Array
    box_lo: Array
    box_hi: Array
    left: Array
    right: Array
    tri: Array
    parent: Array
    leaf_of_tri: Array
    max_depth: int = 1

    @functools.cached_property
    def cone_trig(self):
        """(cos θ_o, sin θ_o, cos θ_e, sin θ_e) per node: taken in NumPy
        float32 on the host, then placed and typed as ``theta_o`` is."""
        def host(x):
            return np.asarray(x.float().cpu() if isinstance(x, torch.Tensor) else x, np.float32)

        to, te = host(self.theta_o), host(self.theta_e)
        like = self.theta_o if isinstance(self.theta_o, torch.Tensor) else torch.zeros(0)
        return tuple(torch.as_tensor(f(a), device=like.device).to(like.dtype)
                     for f, a in ((np.cos, to), (np.sin, to), (np.cos, te), (np.sin, te)))


@dataclasses.dataclass(frozen=True)
class RefScene:
    geometry: Geometry
    materials: MaterialTable
    light_tree: LightTreeArrays

    def to(self, device, dtype=torch.float32) -> "RefScene":
        return RefScene(geometry=_to(self.geometry, device, dtype),
                        materials=_to(self.materials, device, dtype),
                        light_tree=_to(self.light_tree, device, dtype, meta=("max_depth",)))
