"""Benchmark metrics — the reference's measurement protocol, formalized.

MSE/PSNR semantics match ``MisUtils::ComputeMSE``/``ComputePSNR``
(MisUtils.cpp:118-157): per-channel RGB squared error in 8-bit space,
computed post-tonemap; PSNR = 10·log10(255²/MSE).  Rays per frame are
counted as BASELINE.md defines them.

A copy of ``fypraytracer_tpu/utils/metrics.py`` (NumPy only).
"""

from __future__ import annotations

import numpy as np


def mse_8bit(a: np.ndarray, b: np.ndarray) -> float:
    """8-bit RGB MSE (MisUtils.cpp:118-148). Inputs uint8 (H, W, 3)."""
    if a.shape != b.shape:
        raise ValueError(f"image dims differ: {a.shape} vs {b.shape}")
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(np.mean(d * d))


def psnr(mse: float) -> float:
    """10·log10(255²/MSE) dB (MisUtils.cpp:150-157)."""
    if mse <= 0.0:
        return float("inf")
    return float(10.0 * np.log10(255.0 ** 2 / mse))


def rays_per_frame(width: int, height: int, samples: int, bounces: int,
                   shadow_rays_per_bounce: int = 0, visibility_rays: int = 0) -> int:
    """W·H·samples·(1 + bounces + shadow rays + visibility rays) (BASELINE.md
    definition: primary + bounce + shadow rays per path).  ReSTIR GI adds its
    reconnections' visibility rays a path: N (the spatial neighbours) with
    per-neighbour visibility, 1 with ``final_vis``."""
    return width * height * samples * (1 + bounces + shadow_rays_per_bounce * bounces
                                       + visibility_rays)

