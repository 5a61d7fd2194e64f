"""User-facing API of the port (counterpart of ``bliss_tpu/api.py``).

Mirrors the surface of the reference's Python bindings — ``bl_song``'s
dict-style Mapping access, decode/analyze methods and context-manager usage
(reference: python/bliss/bl_song.py), the module-level ``distance`` /
``cosine_similarity`` that accept filenames or loaded songs
(reference: python/bliss/distance.py:5-77), and the C-level entry points
``bl_analyze`` / ``bl_distance_file`` / ``bl_cosine_similarity_file``
(reference: src/analyze.c). Error signaling uses exceptions instead of the
reference's in-band BL_UNEXPECTED floats; thin ``*_file`` wrappers keep the
legacy status-code behavior for drop-in use.

``analyze_pcm`` analyzes decoded PCM and ``analyze_features`` a PCM batch;
both, and ``Song.extended_analysis``, give the 45 extended features
(``features/extended.py``) when asked. ``Song.amplitude_analysis``,
``frequency_analysis`` and ``envelope_analysis`` run one analyzer of the
XLA-path stage (``features/amplitude.py``, ``frequency.py``,
``tempo.envelope_scores``) under any config, as ``bliss_tpu``'s do.
Every entry point that analyzes runs on ``device``: the GPU unless the
caller asks for the CPU (``device="cpu"``); it raises RuntimeError when no
GPU is present. The main path's config is ``AnalysisConfig.for_gpu()``;
the hybrid ``AnalysisConfig.for_gpu_hybrid()`` finishes on the host.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Iterator

import numpy as np
import torch

from bliss_tpu_torch import constants as C
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.features.analyze import (
    analyze_batch,
    analyze_batch_ext,
    analyze_batch_hybrid,
    force_and_class,
)
from bliss_tpu_torch.features import streaming
from bliss_tpu_torch.features.types import EXTENDED_FEATURE_NAMES, PCMBatch, resolve_device
from bliss_tpu_torch.io import DecodedAudio, DecodeError, decode as _decode
from bliss_tpu_torch.sim.distance import cosine_similarity as _cosine_similarity
from bliss_tpu_torch.sim.distance import distance as _distance

# Songs longer than this (interleaved samples, ~3 min) analyze via the
# chunked streaming path — re-exported from the pipeline (the single
# definition) so Song.analyze and analyze_library can never disagree.
from bliss_tpu_torch.pipeline import LONG_SONG_SAMPLES  # noqa: E402


def default_config() -> AnalysisConfig:
    """The port's main path: ``AnalysisConfig.for_gpu()``."""
    return AnalysisConfig.for_gpu()


@dataclasses.dataclass
class ForceVector:
    """4-D perceptual feature vector (reference: include/bliss.h:26-31)."""

    tempo: float = 0.0
    amplitude: float = 0.0
    frequency: float = 0.0
    attack: float = 0.0

    def as_array(self) -> np.ndarray:
        return np.array(
            [self.tempo, self.amplitude, self.frequency, self.attack],
            np.float32,
        )

    def as_dict(self) -> dict[str, float]:
        return dataclasses.asdict(self)


class Song(Mapping):
    """A song: canonical PCM + metadata + analysis results.

    Field names match the reference struct bl_song (include/bliss.h:49-67);
    Mapping access (``song["force_vector"]``) matches the reference bindings'
    dict-style wrapper. Usable as a context manager for symmetry with the
    bindings' ``with bl_song(...)`` idiom (buffers are GC-managed here;
    ``free()`` just drops the PCM reference). ``device`` is where
    ``analyze`` runs unless it is given another.
    """

    _FIELDS = (
        "force", "force_vector", "sample_array", "channels", "nSamples",
        "sample_rate", "bitrate", "nb_bytes_per_sample", "calm_or_loud",
        "resampled", "duration", "filename", "artist", "title", "album",
        "tracknumber", "genre",
    )

    def __init__(
        self,
        filename: str | None = None,
        initial_values: dict | None = None,
        *,
        device="cuda",
    ):
        self.device = device
        self.force: float = 0.0
        self.force_vector = ForceVector()
        self.sample_array: np.ndarray | None = None
        self.channels: int = 0
        self.nSamples: int = 0
        self.sample_rate: int = 0
        self.bitrate: int = 0
        self.nb_bytes_per_sample: int = 0
        self.calm_or_loud: int = C.BL_UNKNOWN
        self.resampled: int = 0
        self.duration: int = 0
        self.filename: str | None = filename
        self.artist: str | None = None
        self.title: str | None = None
        self.album: str | None = None
        self.tracknumber: str | None = None
        self.genre: str | None = None
        if initial_values:
            for k, v in initial_values.items():
                self[k] = v
        if filename is not None:
            self.analyze(filename)

    # -- Mapping interface ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        if key not in self._FIELDS:
            raise KeyError(key)
        v = getattr(self, key)
        if key == "force_vector":
            return v.as_dict()
        return v

    def __setitem__(self, key: str, value: Any) -> None:
        if key not in self._FIELDS:
            raise KeyError(key)
        if key == "force_vector" and isinstance(value, dict):
            value = ForceVector(**value)
        setattr(self, key, value)

    def __iter__(self) -> Iterator[str]:
        return iter(self._FIELDS)

    def __len__(self) -> int:
        return len(self._FIELDS)

    def __enter__(self) -> "Song":
        return self

    def __exit__(self, *exc) -> None:
        self.free()

    def free(self) -> None:
        """Drop the PCM buffer (kept for API symmetry with bl_free_song,
        reference: src/helpers.c:3-13)."""
        self.sample_array = None

    # -- pipeline ------------------------------------------------------------
    def decode(self, filename: str | None = None) -> "Song":
        """Decode audio into the canonical PCM contract (no analysis)."""
        filename = filename or self.filename
        if filename is None:
            raise ValueError("no filename to decode")
        d: DecodedAudio = _decode(filename)
        self.sample_array = d.samples
        self.channels = d.channels
        self.nSamples = d.n_samples
        self.sample_rate = d.sample_rate
        self.bitrate = d.bitrate
        self.nb_bytes_per_sample = d.nb_bytes_per_sample
        self.resampled = d.resampled
        self.duration = d.duration
        self.filename = d.filename
        self.artist = d.artist
        self.title = d.title
        self.album = d.album
        self.tracknumber = d.tracknumber
        self.genre = d.genre
        return self

    def _batch(self, cfg: AnalysisConfig, device) -> PCMBatch:
        if self.sample_array is None:
            self.decode()
        return PCMBatch.from_arrays(
            [np.asarray(self.sample_array)],
            [self.duration],
            pad_multiple=cfg.pad_multiple,
            device=device,
        )

    def analyze(
        self,
        filename: str | None = None,
        cfg: AnalysisConfig | None = None,
        *,
        device=None,
    ) -> int:
        """Decode + full analysis on ``device`` (default: the Song's);
        returns the LOUD/CALM/UNKNOWN class (reference: src/analyze.c:33-80).

        A song longer than ``LONG_SONG_SAMPLES`` is streamed
        (``features/streaming.py``; ``streaming.streaming_supports`` holds
        for every config), as the pipeline does."""
        if filename is not None:
            self.filename = filename
            self.sample_array = None
        device = resolve_device(device or self.device)
        cfg = cfg or default_config()
        if self.sample_array is None:
            self.decode()
        pcm = np.asarray(self.sample_array)
        if pcm.shape[0] > LONG_SONG_SAMPLES and streaming.streaming_supports(cfg):
            feats = streaming.analyze_song_streaming(
                pcm, self.duration, cfg, device=device
            )
        else:
            feats = analyze_features(self._batch(cfg, device), cfg)[0]
        self.force_vector = ForceVector(*map(float, feats))
        force, cls = force_and_class(torch.from_numpy(feats[None, :]))
        self.force = float(force[0])
        self.calm_or_loud = int(cls[0])
        return self.calm_or_loud

    def amplitude_analysis(self, cfg: AnalysisConfig | None = None, *, device=None) -> float:
        """The amplitude score alone, from ``features/amplitude.py`` in
        ``cfg.amplitude_mode`` on ``device`` (default: the Song's); sets
        ``force_vector.amplitude``."""
        from bliss_tpu_torch.features.amplitude import amplitude_scores

        cfg = cfg or default_config()
        batch = self._batch(cfg, resolve_device(device or self.device))
        v = float(amplitude_scores(batch, cfg)[0])
        self.force_vector.amplitude = v
        return v

    def frequency_analysis(self, cfg: AnalysisConfig | None = None, *, device=None) -> float:
        """The frequency score alone, from ``features/frequency.py`` in
        ``cfg.spectrum_mode`` on ``device`` (default: the Song's); sets
        ``force_vector.frequency``."""
        from bliss_tpu_torch.features.frequency import frequency_scores

        cfg = cfg or default_config()
        batch = self._batch(cfg, resolve_device(device or self.device))
        v = float(frequency_scores(batch, cfg)[0])
        self.force_vector.frequency = v
        return v

    def extended_analysis(
        self, cfg: AnalysisConfig | None = None, *, device=None
    ) -> dict[str, float]:
        """The extended feature set (zero-crossing rate, loudness, spectral
        centroid/rolloff/flatness, bpm, beat loudness, MFCC mean and std,
        chroma) as a name -> value dict, analyzed on ``device`` (default:
        the Song's). The band energies and the beat aux come from the
        config's own device stage and envelope finish (``bliss_tpu`` takes
        its band energies from its XLA path whatever the config); a song
        longer than ``LONG_SONG_SAMPLES`` is streamed, as ``analyze``
        does."""
        device = resolve_device(device or self.device)
        cfg = cfg or default_config()
        if self.sample_array is None:
            self.decode()
        pcm = np.asarray(self.sample_array)
        if pcm.shape[0] > LONG_SONG_SAMPLES and streaming.streaming_supports(cfg):
            row = streaming.analyze_song_streaming(
                pcm, self.duration, cfg, extended=True, device=device
            )
        else:
            row = analyze_features(self._batch(cfg, device), cfg, extended=True)[0]
        return dict(zip(EXTENDED_FEATURE_NAMES, map(float, row[4:])))

    def envelope_analysis(
        self, cfg: AnalysisConfig | None = None, *, device=None
    ) -> tuple[float, float]:
        """(tempo, attack) alone, from ``tempo.envelope_scores`` (the
        XLA-path energies in ``cfg.tempo_energy_mode``, then the config's
        finish) on ``device`` (default: the Song's); sets
        ``force_vector.tempo`` and ``.attack``."""
        from bliss_tpu_torch.features.tempo import envelope_scores

        cfg = cfg or default_config()
        batch = self._batch(cfg, resolve_device(device or self.device))
        t, a = (float(x[0]) for x in envelope_scores(batch, cfg))
        self.force_vector.tempo = t
        self.force_vector.attack = a
        return t, a


def analyze_features(
    batch: PCMBatch, cfg: AnalysisConfig, extended: bool = False
) -> np.ndarray:
    """[B, 4] float32 force vectors of a PCM batch under ``cfg``, [B, 49]
    with the extended features after them when ``extended``: a
    ``tempo_finish="host"`` config goes through ``analyze_batch_hybrid``,
    any other through ``analyze_batch`` (``analyze_batch_ext``)."""
    if cfg.tempo_finish == "host":
        return analyze_batch_hybrid(batch, cfg, extended).numpy()
    if extended:
        return analyze_batch_ext(batch, cfg).cpu().numpy()
    return analyze_batch(batch, cfg).cpu().numpy()


def analyze_pcm(
    arrays: list[np.ndarray],
    durations: list[int],
    *,
    cfg: AnalysisConfig | None = None,
    device="cuda",
    extended: bool = False,
) -> np.ndarray:
    """[B, 4] float32 force vectors (tempo, amplitude, frequency, attack) of
    1-D int16 interleaved-stereo PCM arrays at 22.05 kHz, with each song's
    duration in whole seconds, analyzed on ``device``: the GPU unless the
    caller asks for the CPU (``device="cpu"``); raises RuntimeError when no
    GPU is present. With ``extended``, [B, 49]: the 45 extended features
    after the 4."""
    cfg = cfg or default_config()
    batch = PCMBatch.from_arrays(
        arrays, durations, pad_multiple=cfg.pad_multiple, device=device
    )
    return analyze_features(batch, cfg, extended)


# --- module-level functions (reference: python/bliss/distance.py) -----------

def _as_vector(song_or_file, device) -> torch.Tensor:
    if isinstance(song_or_file, str):
        song_or_file = Song(song_or_file, device=device)
    if isinstance(song_or_file, Song):
        song_or_file = song_or_file.force_vector
    if isinstance(song_or_file, ForceVector):
        song_or_file = song_or_file.as_array()
    return torch.as_tensor(np.asarray(song_or_file, np.float32))


def analyze(
    filename: str, cfg: AnalysisConfig | None = None, *, device="cuda"
) -> Song:
    """Analyze one file on ``device``; raises DecodeError on undecodable
    input."""
    s = Song(device=device)
    s.analyze(filename, cfg=cfg)
    return s


def distance(song1, song2, *, device="cuda") -> float:
    """Euclidean distance; args may be filenames (analyzed on ``device``),
    Songs, ForceVectors, or 4-arrays (reference:
    python/bliss/distance.py:5-40)."""
    return float(_distance(_as_vector(song1, device), _as_vector(song2, device)))


def cosine_similarity(song1, song2, *, device="cuda") -> float:
    """Cosine similarity with the same flexible arguments."""
    return float(
        _cosine_similarity(_as_vector(song1, device), _as_vector(song2, device))
    )


def distance_file(filename1: str, filename2: str, *, device="cuda") -> float:
    """Legacy-compatible: returns BL_UNEXPECTED (-2.0) on decode failure
    instead of raising (reference: src/analyze.c:105-125)."""
    try:
        return distance(filename1, filename2, device=device)
    except DecodeError:
        return float(C.BL_UNEXPECTED)


def cosine_similarity_file(
    filename1: str, filename2: str, *, device="cuda"
) -> float:
    """Legacy-compatible variant of cosine_similarity
    (reference: src/analyze.c:145-167)."""
    try:
        return cosine_similarity(filename1, filename2, device=device)
    except DecodeError:
        return float(C.BL_UNEXPECTED)


def version() -> str:
    """Framework version (the reference prints and returns 1.2,
    reference: src/helpers.c:25-28)."""
    return C.VERSION
