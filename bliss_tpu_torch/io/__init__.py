"""Audio decode (the native libav shim, built at first use) and the FLAC
writer."""

from bliss_tpu_torch.io.decoder import (
    AudioProbe,
    DecodedAudio,
    DecodeError,
    EncodeError,
    decode,
    decode_batch,
    encode,
    iter_decode,
    native_version,
    probe,
)

__all__ = [
    "AudioProbe",
    "DecodedAudio",
    "DecodeError",
    "EncodeError",
    "decode",
    "decode_batch",
    "encode",
    "iter_decode",
    "native_version",
    "probe",
]
