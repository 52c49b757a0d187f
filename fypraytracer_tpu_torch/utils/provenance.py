"""Run provenance — timestamped, parameter-encoding output names.

The reference's benchmark database IS its output filenames: every saved
render encodes technique, sample/bounce or ReSTIR parameters, average
frame time, total render minutes, MSE/PSNR and a timestamp
(WalnutApp.cpp:780-876, MisUtils::GetTimestampedFilename
MisUtils.cpp:97-116).  We reproduce that protocol and additionally emit a
structured JSON sidecar.

A copy of ``fypraytracer_tpu/utils/provenance.py`` on the port's
``config``.
"""

from __future__ import annotations

import datetime
import json

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique

_TECH_NAMES = {
    SamplingTechnique.BRUTE_FORCE: "BruteForce",
    SamplingTechnique.UNIFORM: "UniformSampling",
    SamplingTechnique.COSINE: "CosineWeighted",
    SamplingTechnique.GGX: "GGXSampling",
    SamplingTechnique.BRDF: "BRDFSampling",
    SamplingTechnique.LIGHT_SOURCE: "LightSourceSampling",
    SamplingTechnique.NEE_MIS: "NEE_MIS",
    SamplingTechnique.RESTIR_DI: "ReSTIR_DI",
    SamplingTechnique.RESTIR_GI: "ReSTIR_GI",
}


def timestamp() -> str:
    """``YYYY-MM-DD_HH-MM-SS`` (MisUtils.cpp:97-116)."""
    return datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")


def run_name(settings: RenderSettings, avg_frame_ms: float | None = None,
             total_minutes: float | None = None, mse: float | None = None,
             psnr: float | None = None, stamp: str | None = None) -> str:
    """Parameter-encoding base filename (WalnutApp.cpp:787-876 protocol)."""
    t = settings.technique
    parts = [_TECH_NAMES.get(t, str(int(t)))]
    if t in (SamplingTechnique.RESTIR_DI, SamplingTechnique.RESTIR_GI):
        parts.append(f"cand{settings.light_candidates}")
        parts.append(f"hist{settings.temporal_history_limit}")
        parts.append(f"nbr{settings.spatial_neighbors}r{settings.spatial_radius}")
    else:
        parts.append(f"spp{settings.samples}")
        parts.append(f"b{settings.bounces}")
    if avg_frame_ms is not None:
        parts.append(f"{avg_frame_ms:.2f}ms")
    if total_minutes is not None:
        parts.append(f"{total_minutes:.1f}min")
    if mse is not None:
        parts.append(f"MSE{mse:.4f}")
    if psnr is not None:
        parts.append(f"PSNR{psnr:.2f}dB")
    parts.append(stamp or timestamp())
    return "_".join(parts)


def write_sidecar(path: str, settings: RenderSettings, **metrics) -> None:
    """Structured provenance next to the image (new vs reference)."""
    rec = {"settings": {k: (v.name if hasattr(v, "name") else v)
                        for k, v in settings.__dict__.items()},
           **metrics}
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)
