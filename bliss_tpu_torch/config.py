"""Analysis configuration.

The same frozen dataclass as ``bliss_tpu/config.py`` (same fields, defaults
and validation), so one set of field values selects the same modes in both
packages. ``for_gpu()`` is the port's main path and carries exactly
``for_tpu()``'s values. ``check_supported`` names the ROADMAP item that will
bring each configuration this package does not run yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    # Compute dtype for the DSP pipeline ("float32" on the main path;
    # "float64" is the reference's strict parity mode).
    dtype: str = "float32"

    # Amplitude: "table" (gather), "poly" (Chebyshev, gather-free) or
    # "iterative" (the reference's 301 float32 passes).
    amplitude_mode: str = "table"

    # Frequency spectra: "matmul" (RDFT as a matmul) or "fft".
    spectrum_mode: str = "matmul"

    # Tempo window energies: "parseval", "parseval_framed", "fft" or
    # "fft_strict" (the reference's float32 accumulation order).
    tempo_energy_mode: str = "parseval"

    # Butterworth IIR: "blocked" (dense block recurrence) or "scan".
    iir_mode: str = "blocked"
    iir_block: int = 256

    # Replicate the reference's sequential float32 accumulation order.
    strict_accumulation: bool = False

    # Where the tempo envelope finish runs: "device" (working dtype),
    # "device_exact" (beat-exact; float64 on the GPU) or "host".
    tempo_finish: str = "device"

    # Use the fused sample-stats kernel.
    fused_kernel: bool = False

    # Fused-kernel FIR mode of the TPU kernels ("split" or "exact"). The
    # GPU kernel runs the FIR in float64 either way.
    fused_conv: str = "split"

    # STFT precision of the TPU kernels ("precise" or "fast"). The GPU
    # kernel computes the spectrum in full float32 either way.
    stft_conv: str = "precise"

    # Single-pass mode: one kernel computes amplitude + tempo + STFT power
    # (kernels/fused_all.py). Requires fused_kernel.
    single_pass: bool = False

    # Tempo filterbank: 1 band with the reference's 17-tap filter is parity
    # mode; None means "unset", resolved in __post_init__.
    nb_bands: int | None = None
    band_taps: int | None = None

    # Multi-band filterbank design: "firwin", "reference5" or "reference36".
    filterbank: str = "firwin"

    def __post_init__(self):
        if self.tempo_finish not in ("device", "device_exact", "host"):
            raise ValueError(
                f"unknown tempo_finish {self.tempo_finish!r}: use 'device', "
                "'device_exact', or 'host'"
            )
        if self.stft_conv not in ("precise", "fast"):
            raise ValueError(
                f"unknown stft_conv {self.stft_conv!r}: use 'precise' or "
                "'fast'"
            )
        if self.single_pass and self.fused_conv != "split":
            raise ValueError(
                "single_pass implements only the bf16-split FIR; use the "
                "two-kernel path (single_pass=False) with fused_conv='exact'"
            )
        shapes = {"reference5": (5, 17), "reference36": (36, 33)}
        if self.filterbank in shapes:
            nb, taps = shapes[self.filterbank]
            if self.nb_bands not in (None, nb) or self.band_taps not in (
                None,
                taps,
            ):
                raise ValueError(
                    f"filterbank={self.filterbank!r} is a fixed "
                    f"{nb}x{taps} design; leave nb_bands/band_taps unset "
                    "(None) or set them to match"
                )
            object.__setattr__(self, "nb_bands", nb)
            object.__setattr__(self, "band_taps", taps)
        elif self.filterbank == "firwin":
            if self.nb_bands is None:
                object.__setattr__(self, "nb_bands", 1)
            if self.band_taps is None:
                object.__setattr__(self, "band_taps", 17)
        else:
            raise ValueError(f"unknown filterbank {self.filterbank!r}")

    # Sequence padding multiple for batched analysis. Must be a multiple of
    # 1024 (stereo frequency frames of 512 per channel).
    pad_multiple: int = 1024

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def for_gpu() -> "AnalysisConfig":
        """The port's main path, with exactly the field values of the JAX
        package's ``for_tpu()``: the single-pass fused kernel (CUDA here)
        and the beat-exact envelope finish (native float64 here)."""
        return AnalysisConfig(
            dtype="float32",
            amplitude_mode="poly",
            tempo_finish="device_exact",
            fused_kernel=True,
            single_pass=True,
        )


def check_supported(cfg: AnalysisConfig) -> None:
    """Raise NotImplementedError for a configuration the port does not run
    yet, naming the ROADMAP item that brings it."""
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype={cfg.dtype!r} (the float64 parity config) is ROADMAP "
            "item M7; the port runs float32"
        )
    if not cfg.fused_kernel:
        raise NotImplementedError(
            "fused_kernel=False (the XLA-path modes) is ROADMAP item M7"
        )
    if not cfg.single_pass:
        raise NotImplementedError(
            "single_pass=False (the two-kernel configs, kernels K2 and K3) "
            "is ROADMAP item M9"
        )
    if cfg.tempo_finish != "device_exact":
        item = "M9" if cfg.tempo_finish == "host" else "M7"
        raise NotImplementedError(
            f"tempo_finish={cfg.tempo_finish!r} is ROADMAP item {item}; the "
            "port runs 'device_exact'"
        )
    if cfg.band_taps > 129:
        raise NotImplementedError(
            "band_taps > 129 exceeds the fused kernel's history (ROADMAP M7)"
        )
