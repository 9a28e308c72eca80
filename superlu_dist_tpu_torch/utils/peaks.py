"""Per-card, per-GEMM-tier peak-FLOP tables: the MFU denominator.

Port of the JAX package's ``utils/peaks.py``, with its names and
semantics, for the cards this package runs on:

* ``SLU_TPU_PEAK_GFLOPS`` (registered knob) overrides everything — the
  operator's calibrated figure wins (source ``"env"``);
* a known card looks its peak up in ``GPU_PEAK_GFLOPS``, per GEMM tier
  (``ops/dense.GEMM_PREC_LADDER``) and for float64 (source
  ``"table:<card name>"``).  The figures are NVIDIA's H100 data-sheet
  dense (no sparsity) peaks — vendor figures, not measurements;
* anything else (the CPU, an unknown card) CALIBRATES: one cached
  micro-GEMM per tier through the factor path's own ``ops.dense.gemm``,
  timed at steady state (source ``"measured:<device>"``).

Every consumer reports the source beside the percentage, so an MFU
number can always be traced to its denominator.  ``table_peak_gflops``
is the pure table lookup, for rows recorded on another machine.
"""

from __future__ import annotations

import functools

from superlu_dist_tpu_torch.utils.options import env_float

#: NVIDIA H100 data-sheet dense peaks in GFLOP/s, per card (matched by
#: substring against ``torch.cuda.get_device_name``, first hit wins) and
#: per GEMM tier: ``bf16`` the BF16 tensor cores, ``default`` TF32 tensor
#: cores, ``f32`` / ``highest`` IEEE FP32, ``float64`` the FP64 tensor
#: cores.  "H100 80GB HBM3" is the SXM5 card's name, "H100 PCIe" the PCIe
#: card's.
GPU_PEAK_GFLOPS = {
    "h100 80gb hbm3": {"bf16": 989_400.0, "default": 494_700.0,
                       "f32": 67_000.0, "highest": 67_000.0,
                       "float64": 67_000.0},
    "h100 pcie": {"bf16": 756_000.0, "default": 378_000.0,
                  "f32": 51_000.0, "highest": 51_000.0, "float64": 51_000.0},
}

#: where the table's figures come from (printed in a peak's source)
TABLE_SOURCE = "NVIDIA H100 data sheet, dense"


def table_peak_gflops(device_kind: str, gemm_precision: str) -> float | None:
    """Tabulated peak of one card name and GEMM tier (or "float64"), or
    None when the name matches no card.  Pure table lookup."""
    kind = (device_kind or "").lower()
    for key, tiers in GPU_PEAK_GFLOPS.items():
        if key in kind:
            return tiers.get(gemm_precision, tiers["highest"])
    return None


@functools.lru_cache(maxsize=None)
def _calibrate_gflops(tier: str, device: str) -> float:
    """Measured matmul rate of ``device`` at one GEMM tier: a timed
    512³ float32 GEMM through ``ops.dense.gemm``, best of three after a
    warm-up.  Cached per (tier, device)."""
    import time

    import torch

    from superlu_dist_tpu_torch.ops.dense import gemm

    n = 512
    dev = torch.device(device)
    a = torch.ones((n, n), dtype=torch.float32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    gemm(a, a, tier)
    sync()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        gemm(a, a, tier)
        sync()
        best = min(best, time.perf_counter() - t0)
    return 2.0 * n ** 3 / max(best, 1e-9) / 1e9


def detect_peak_gflops(gemm_precision: str,
                       backend: str | None = None) -> tuple[float, str]:
    """The MFU denominator of this process: ``(gflops, source)``, source
    "env", "table:<card name>" or "measured:<device>".
    ``SLU_TPU_PEAK_GFLOPS`` wins when set; a known card reads the table;
    everything else calibrates.  ``backend`` is a device ("cuda", "cpu";
    None: the card — the CPU only when the caller asks for it)."""
    override = env_float("SLU_TPU_PEAK_GFLOPS")
    if override > 0:
        return float(override), "env"
    import torch
    if backend is None:
        backend = "cuda"
    if torch.device(backend).type == "cuda":
        kind = torch.cuda.get_device_name(torch.device(backend))
        peak = table_peak_gflops(kind, gemm_precision)
        if peak is not None:
            return peak, f"table:{kind} ({TABLE_SOURCE})"
    return _calibrate_gflops(gemm_precision, backend), f"measured:{backend}"


def mfu_pct(gflops: float, gemm_precision: str,
            backend: str | None = None) -> tuple[float, float, str]:
    """(mfu_pct, peak_gflops, source) for an achieved rate — rounded to
    4 decimals so small-but-real utilizations never print as 0.0."""
    peak, source = detect_peak_gflops(gemm_precision, backend=backend)
    return round(100.0 * gflops / max(peak, 1e-9), 4), peak, source
