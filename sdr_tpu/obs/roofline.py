"""Roofline accounting: device peak table and the demod chain's model.

The north star requires the FFT and LLR stages at their HBM/FLOP
roofline (BASELINE.json); the reference has no performance reporting of
any kind (SURVEY.md §6). This module holds the published peaks of the
accelerators the program is measured on, keyed by JAX's
``device_kind``, and the analytic byte/FLOP model of the receive chain,
so a measured time is judged against physics.

A device missing from the table is an error: there is no default peak.
"""

from __future__ import annotations

import dataclasses

from sdr_tpu.core.config import Modulation


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    """Published dense peaks of one accelerator at its full power limit."""

    name: str
    hbm_bytes_per_s: float
    bf16_flops: float
    tf32_flops: float
    f32_flops: float
    power_limit_w: float
    source: str


_H100_SXM = ChipPeaks(
    name="NVIDIA H100 SXM",
    hbm_bytes_per_s=3.35e12,
    bf16_flops=989e12,
    tf32_flops=495e12,
    f32_flops=67e12,
    power_limit_w=700.0,
    source="NVIDIA H100 Tensor Core GPU data sheet (SXM, dense)",
)

#: ``jax.devices()[0].device_kind`` → published peaks.
PEAKS: dict[str, ChipPeaks] = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def chip_peaks(device_kind: str) -> ChipPeaks:
    """Peaks for a ``device_kind``; raises KeyError for a device the
    table does not hold."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


@dataclasses.dataclass
class RooflineReport:
    bytes_per_sample: float
    flops_per_sample: float
    bound: str                    # "memory" | "compute"
    sol_samples_per_s: float      # speed of light on the published peaks
    achieved_samples_per_s: float | None = None

    @property
    def efficiency(self) -> float | None:
        if self.achieved_samples_per_s is None:
            return None
        return self.achieved_samples_per_s / self.sol_samples_per_s


def demod_roofline(
    n_fft: int,
    cp_len: int,
    mod: Modulation,
    peaks: ChipPeaks,
    write_llrs: bool = False,
    measured_samples_per_s: float | None = None,
) -> RooflineReport:
    """Roofline for CP-strip → FFT → equalize → LLR, per input sample.

    Models the XLA composition: the planar input read, the stripped
    symbol and the FFT output each written and read back once
    (complex64), and the optional LLR write; the per-link channel plane
    amortizes away over symbols. A "sample" is one complex time sample
    entering the chain (CP included) — the bench's accounting. FLOPs: radix-2 FFT
    (5·N·log2 N) plus the equalize/LLR tail, which runs at the f32
    (non-tensor-core) rate.
    """
    sym = n_fft + cp_len
    bps = mod.bits_per_symbol
    in_bytes = sym * 2 * 4  # planar f32 re + im
    llr_bytes = n_fft * bps * 4
    b = in_bytes + 4 * n_fft * 8 + (llr_bytes if write_llrs else 0)
    bytes_per_sample = b / sym

    f = 5.0 * n_fft * (n_fft.bit_length() - 1)
    f += n_fft * (10 + 4 * mod.levels_per_axis)
    flops_per_sample = f / sym

    t_mem = bytes_per_sample / peaks.hbm_bytes_per_s
    t_cmp = flops_per_sample / peaks.f32_flops
    return RooflineReport(
        bytes_per_sample=bytes_per_sample,
        flops_per_sample=flops_per_sample,
        bound="memory" if t_mem >= t_cmp else "compute",
        sol_samples_per_s=1.0 / max(t_mem, t_cmp),
        achieved_samples_per_s=measured_samples_per_s,
    )
