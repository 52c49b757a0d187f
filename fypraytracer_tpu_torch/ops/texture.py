"""Texture sampling from the packed atlas, on tensors.

The torch counterpart of ``fypraytracer_tpu/ops/texture.py`` (:17-59):
``Texture::SampleBilinear`` / ``SampleNearest`` (Texture.cu:94-139) over
the atlas layout (``scene/types.py::TextureAtlas``), one (K, H, W, 3)
gather source.  UVs wrap with floor-mod (``torch.remainder``, as JAX's
``u % 1.0``); the bilinear fetch is two lerps, x first, and therefore
differentiable by autograd with respect to the UVs and the texels.

The megakernels read other levels than the wavefront (JAX
``render/megakernel.py:379-419``): the primary level is mip 0 box-filtered
down to at most ``KERNEL_TEX_PAGE`` a side, the bounce level the atlas's
``bounce_pages``.  ``kernel_atlas`` returns those levels as an atlas, so
that a kernel's plain version is the wavefront over
``dataclasses.replace(scene, textures=kernel_atlas(scene.textures))``;
``make_kernel_tex`` lays them out for the CUDA fetch (``csrc/shading.cuh::
fetch_bilinear``), one float4 a texel, as ``Scene.tex``, which the scene
builders make with the scene.  The JAX package's MXU table layout
(``_tex_table``) exists for the TPU's one-hot matmul and is not carried
over.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fypraytracer_tpu_torch.scene.build import _box_downsample
from fypraytracer_tpu_torch.scene.types import KernelTex, Scene, TextureAtlas

# megakernel.py:383: the side of the kernels' primary level
KERNEL_TEX_PAGE = 256


def _level(atlas: TextureAtlas, bounce: bool):
    """Mip level per the TextureAtlas policy: primary fetches read mip 0,
    bounce-hit fetches read the prefiltered bounce level."""
    if bounce and atlas.bounce_pages is not None:
        return atlas.bounce_pages
    return atlas.pages


def sample_bilinear(atlas: TextureAtlas, tex_id, u, v, bounce: bool = False):
    """Bilinear sample; ``tex_id`` (B,) int (clipped to valid), ``u``/``v``
    (B,) (wrapped).  Returns (B, 3) RGB."""
    pages = _level(atlas, bounce)
    k, h, w = pages.shape[0], pages.shape[1], pages.shape[2]
    tid = torch.clamp(tex_id, 0, k - 1).long()

    fx = torch.remainder(u, 1.0) * (w - 1)
    fy = torch.remainder(v, 1.0) * (h - 1)
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]

    x0, x1, y0, y1 = x0.long(), x1.long(), y0.long(), y1.long()
    c00 = pages[tid, y0, x0]
    c10 = pages[tid, y0, x1]
    c01 = pages[tid, y1, x0]
    c11 = pages[tid, y1, x1]
    top = c00 * (1.0 - ax) + c10 * ax
    bot = c01 * (1.0 - ax) + c11 * ax
    return top * (1.0 - ay) + bot * ay


def sample_nearest(atlas: TextureAtlas, tex_id, u, v):
    """Nearest-neighbor sample (Texture.cu:94-112)."""
    pages = atlas.pages
    k, h, w = pages.shape[0], pages.shape[1], pages.shape[2]
    tid = torch.clamp(tex_id, 0, k - 1).long()
    x = torch.clamp((torch.remainder(u, 1.0) * w).to(torch.int32), 0, w - 1).long()
    y = torch.clamp((torch.remainder(v, 1.0) * h).to(torch.int32), 0, h - 1).long()
    return pages[tid, y, x]


def scene_is_textured(scene: Scene) -> bool:
    """True when any material actually references an atlas page
    (megakernel.py:2544-2547).  Reads the material table on the host."""
    return _maps_albedo(scene.materials)


def _maps_albedo(materials) -> bool:
    amap = materials.albedo_map
    amap = amap.cpu() if isinstance(amap, torch.Tensor) else torch.as_tensor(np.asarray(amap))
    return bool((amap >= 0).any())


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float32)


def kernel_atlas(atlas: TextureAtlas, kernel_page: int = KERNEL_TEX_PAGE) -> TextureAtlas:
    """The megakernels' two levels as an atlas, on the atlas's device:
    ``pages`` is mip 0 box-filtered (``scene/build.py::_box_downsample``)
    down to at most ``kernel_page`` a side, ``bounce_pages`` the atlas's
    bounce level, or those pages where it has none (``prepare_texture_tables``,
    megakernel.py:402-419).  Where mip 0 already fits, its tensor is
    returned as it is."""
    dev = atlas.pages.device if isinstance(atlas.pages, torch.Tensor) else torch.device("cpu")
    k, h, w = atlas.pages.shape[:3]
    ph, pw = min(h, kernel_page), min(w, kernel_page)
    pages = atlas.pages
    if (ph, pw) != (h, w):
        host = _host(pages)
        pages = torch.as_tensor(np.stack([_box_downsample(p, ph, pw) for p in host]), device=dev)
    pages = torch.as_tensor(pages, dtype=torch.float32, device=dev)
    bounce = pages if atlas.bounce_pages is None else torch.as_tensor(
        atlas.bounce_pages, dtype=torch.float32, device=dev)
    return dataclasses.replace(atlas, pages=pages, bounce_pages=bounce)


def _float4(pages: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(pages.to(torch.float32), (0, 1)).contiguous()


def make_kernel_tex(materials, atlas: TextureAtlas) -> KernelTex | None:
    """A scene's ``Scene.tex``: None when no material maps an albedo (the
    untextured kernels run), else the ``kernel_atlas`` levels padded to
    float4, on the atlas's device.  Reads the material table on the host;
    the scene builders call it once, as they build ``Scene.wide``."""
    if not _maps_albedo(materials):
        return None
    ka = kernel_atlas(atlas)
    return KernelTex(prim=_float4(ka.pages), bounce=_float4(ka.bounce_pages))


def with_textures(scene: Scene, atlas: TextureAtlas) -> Scene:
    """``scene`` with its atlas replaced and its kernel levels
    (``Scene.tex``) built anew from it."""
    return dataclasses.replace(scene, textures=atlas, tex=make_kernel_tex(scene.materials, atlas))


def check_scene_tex(scene: Scene) -> None:
    """Raise unless ``Scene.tex`` is present exactly when a material maps an
    albedo: a textured scene without it would run the untextured kernels
    and the flat albedo.  The renderers call it once, when they are made
    (it reads the material table on the host)."""
    if scene_is_textured(scene) != (scene.tex is not None):
        raise ValueError("Scene.tex does not match the material table's albedo maps: build the scene with "
                         "SceneBuilder.compile or scene_from_arrays, or replace its atlas with with_textures")


def with_kernel_atlas(scene: Scene) -> Scene:
    """``scene`` reading the megakernels' levels (``Scene.tex``): what their
    plain versions render, so that a kernel and its plain version compute
    one function.  An untextured scene is returned as it is."""
    if scene.tex is None:
        return scene
    atlas = dataclasses.replace(scene.textures, pages=scene.tex.prim[..., :3], bounce_pages=scene.tex.bounce[..., :3])
    return dataclasses.replace(scene, textures=atlas)


def tex_args(tex: KernelTex | None) -> tuple:
    """A launch's texture arguments (``Scene.tex``): the textured flag, the
    two levels, K, (hp, wp) and (hb, wb); null levels and zero sizes when
    untextured."""
    if tex is None:
        return (0, None, None, 0, 0, 0, 0, 0)
    from fypraytracer_tpu_torch.ops import kernels

    k, hp, wp = tex.prim.shape[:3]
    _, hb, wb = tex.bounce.shape[:3]
    return (1, kernels.ptr(tex.prim), kernels.ptr(tex.bounce), k, hp, wp, hb, wb)
