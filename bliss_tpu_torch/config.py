"""Analysis configuration.

The same frozen dataclass as ``bliss_tpu/config.py`` (same fields, defaults
and validation), so one set of field values selects the same modes in both
packages. ``for_gpu()`` is the port's main path and carries exactly
``for_tpu()``'s values. ``check_supported`` refuses a mode name neither
package knows, and ``uses_kernels`` routes a config to the CUDA kernels or
to the XLA-path stage.
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
    # GPU kernels run the FIR in float64 either way.
    fused_conv: str = "split"

    # STFT precision of the TPU kernels ("precise" or "fast"). The GPU
    # kernels compute the spectrum in full float32 either way.
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
    def for_parity() -> "AnalysisConfig":
        """Strict parity with the reference's golden values, with exactly
        the field values of the JAX package's ``for_parity()``: float64,
        the 301 float32 smoothing passes, the float32 accumulation orders,
        on the XLA-path stage."""
        return AnalysisConfig(
            dtype="float64",
            amplitude_mode="iterative",
            tempo_energy_mode="fft_strict",
            strict_accumulation=True,
        )

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

    @staticmethod
    def for_gpu_hybrid() -> "AnalysisConfig":
        """The two-kernel hybrid config, with exactly the field values of the
        JAX package's ``for_tpu_hybrid()``: the sample-stats (K2) and
        spectrum (K3) kernels on the device, then the float64 NumPy/SciPy
        envelope finish on the host."""
        return AnalysisConfig(
            dtype="float32",
            amplitude_mode="poly",
            tempo_finish="host",
            fused_kernel=True,
        )


MODES = {
    "dtype": ("float32", "float64"),
    "amplitude_mode": ("table", "poly", "iterative"),
    "spectrum_mode": ("matmul", "fft"),
    "tempo_energy_mode": ("parseval", "parseval_framed", "fft", "fft_strict"),
    "iir_mode": ("blocked", "scan"),
    "fused_conv": ("split", "exact"),
}


def uses_kernels(cfg: AnalysisConfig) -> bool:
    """Whether a config takes the CUDA kernels' device stage (K1, or K2 and
    K3): the fused kernel, float32 and at most 129 taps, as ``bliss_tpu``'s
    ``_use_fused`` routes (``bliss_tpu/features/analyze.py:93-103``). Every
    other config takes the XLA-path stage (``features/amplitude.py``,
    ``frequency.py`` and ``tempo.band_energies``). ``bliss_tpu`` also needs
    L >= 65536 for its TPU kernel's tiles; the port's kernels take any L
    that is a multiple of 1024, so the length does not route here."""
    return cfg.fused_kernel and cfg.dtype == "float32" and cfg.band_taps <= 129


def check_supported(cfg: AnalysisConfig) -> None:
    """Raise ValueError for a mode name ``bliss_tpu`` does not know either
    (it raises when it meets one at analysis time; the port raises before
    any decode). Every config ``bliss_tpu`` runs is run here, whole and
    streamed (``features/streaming.analyze_song_streaming``), and over a
    device mesh (``parallel.analyze_sharded``)."""
    for field, names in MODES.items():
        if getattr(cfg, field) not in names:
            raise ValueError(
                f"unknown {field} {getattr(cfg, field)!r}: use one of {names}"
            )
