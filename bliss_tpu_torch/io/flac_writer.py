"""Minimal FLAC writer (verbatim subframes) for generating test fixtures.

A copy of ``bliss_tpu/io/flac_writer.py`` that writes the same bytes, so
that the port's tests and ``chip_smoke.py`` write files where ``bliss_tpu``
cannot be imported.

Produces spec-valid, uncompressed FLAC: STREAMINFO + fixed-blocksize frames
whose subframes are VERBATIM-coded 16-bit samples. Enough for any FLAC
decoder (validated against libav in tests); useful because this environment
ships no audio encoders, and the reference library only decodes formats
with in-band codec parameters (its decode path never fills the codec
context from the container, so raw PCM/WAV fails on modern ffmpeg).
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

_BLOCK = 4096


def _make_crc8_table():
    t = []
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
        t.append(crc)
    return t


def _make_crc16_table():
    t = []
    for byte in range(256):
        crc = byte << 8
        for _ in range(8):
            crc = (
                ((crc << 1) ^ 0x8005) & 0xFFFF
                if crc & 0x8000
                else (crc << 1) & 0xFFFF
            )
        t.append(crc)
    return t


_CRC8_TABLE = _make_crc8_table()
_CRC16_TABLE = _make_crc16_table()

# Explicit sample-rate code so frames are self-describing (decoders fed
# through codec contexts without STREAMINFO extradata — like the
# reference's — still work). Unlisted rates use the 16-bit Hz tail.
_RATE_CODES = {
    88200: 0b0001, 176400: 0b0010, 192000: 0b0011, 8000: 0b0100,
    16000: 0b0101, 22050: 0b0110, 24000: 0b0111, 32000: 0b1000,
    44100: 0b1001, 48000: 0b1010, 96000: 0b1011,
}


def _crc8(data: bytes) -> int:
    crc = 0
    t = _CRC8_TABLE
    for byte in data:
        crc = t[crc ^ byte]
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    t = _CRC16_TABLE
    for byte in data:
        crc = t[((crc >> 8) ^ byte) & 0xFF] ^ ((crc << 8) & 0xFFFF)
    return crc


def _utf8_coded_number(n: int) -> bytes:
    """FLAC frame-number coding (UTF-8-style, extended to 36 bits).

    An N-byte encoding has a lead byte of N ones + a zero + (8-N-1) payload
    bits, then N-1 continuation bytes of 6 payload bits each. (The original
    version emitted a wrong lead marker for multi-byte values, which made
    every frame past #127 — about 24 s of 22.05 kHz audio — undecodable;
    fixed round 3, validated against ffmpeg's decoder on 40 s files.)
    """
    if n < 0x80:
        return bytes([n])
    nbytes = 2
    while n.bit_length() > (7 - nbytes) + 6 * (nbytes - 1):
        nbytes += 1
    payload = n
    tail = []
    for _ in range(nbytes - 1):
        tail.append(0x80 | (payload & 0x3F))
        payload >>= 6
    lead_prefix = (0xFF << (8 - nbytes)) & 0xFF
    out = [lead_prefix | payload]
    out.extend(reversed(tail))
    return bytes(out)


def write_flac(
    path: str,
    frames: np.ndarray,
    sample_rate: int = 22050,
    tags: dict | None = None,
) -> None:
    """Write [n_frames, channels] int16 PCM as a verbatim FLAC file.

    The sample count is padded with zeros to a whole number of 4096-sample
    blocks (so STREAMINFO's fixed min/max blocksize holds exactly). ``tags``
    (e.g. {"ARTIST": ..., "TITLE": ...}) are written as a VORBIS_COMMENT
    metadata block.
    """
    frames = np.asarray(frames, np.int16)
    if frames.ndim == 1:
        frames = frames[:, None]
    n, ch = frames.shape
    pad = (-n) % _BLOCK
    if pad:
        frames = np.vstack([frames, np.zeros((pad, ch), np.int16)])
        n += pad

    md5 = hashlib.md5(frames.astype("<i2").tobytes()).digest()

    out = bytearray(b"fLaC")
    # STREAMINFO, last-metadata flag set
    si = bytearray()
    si += struct.pack(">HH", _BLOCK, _BLOCK)  # min/max blocksize
    si += b"\x00\x00\x00" * 2  # min/max framesize unknown
    packed = (sample_rate << 44) | ((ch - 1) << 41) | ((16 - 1) << 36) | n
    si += packed.to_bytes(8, "big")
    si += md5
    last_flag = 0x80 if not tags else 0x00
    out += bytes([last_flag]) + len(si).to_bytes(3, "big") + si

    if tags:
        vc = bytearray()
        vendor = b"bliss-tpu flac_writer"
        vc += struct.pack("<I", len(vendor)) + vendor
        entries = [f"{k}={v}".encode() for k, v in tags.items()]
        vc += struct.pack("<I", len(entries))
        for e in entries:
            vc += struct.pack("<I", len(e)) + e
        out += bytes([0x80 | 0x04]) + len(vc).to_bytes(3, "big") + vc

    for fi in range(n // _BLOCK):
        out += frame_bytes(
            frames[fi * _BLOCK : (fi + 1) * _BLOCK], fi, sample_rate
        )

    with open(path, "wb") as f:
        f.write(bytes(out))


def frame_bytes(blk: np.ndarray, fi: int, sample_rate: int = 22050) -> bytes:
    """One complete FLAC frame (header + verbatim subframes + CRCs) for a
    [_BLOCK, channels] int16 block at frame index ``fi``. Exposed so bulk
    fixture generators can precompute a pool of frames and compose many
    distinct files at I/O speed (the CRCs depend on (content, fi) only)."""
    ch = blk.shape[1]
    rate_code = _RATE_CODES.get(sample_rate, 0b1101)
    hdr = bytearray()
    # sync(14)=11111111111110, reserved(1)=0, blocking(1)=0 (fixed)
    hdr += b"\xff\xf8"
    # blocksize code 0b0111 (16-bit at end), explicit sample-rate code
    hdr.append((0b0111 << 4) | rate_code)
    # channels independent (ch-1), sample size 16 bits (0b100), reserved 0
    hdr.append(((ch - 1) << 4) | (0b100 << 1))
    hdr += _utf8_coded_number(fi)
    hdr += struct.pack(">H", _BLOCK - 1)
    if rate_code == 0b1101:
        hdr += struct.pack(">H", sample_rate)
    hdr.append(_crc8(bytes(hdr)))

    body = bytearray(hdr)
    for c in range(ch):
        body.append(0x02)  # subframe header: VERBATIM, no wasted bits
        body += blk[:, c].astype(">i2").tobytes()
    body += struct.pack(">H", _crc16(bytes(body)))
    return bytes(body)


def stream_header(
    n_samples: int,
    ch: int = 2,
    sample_rate: int = 22050,
    md5: bytes = b"\x00" * 16,
) -> bytes:
    """fLaC magic + STREAMINFO for composing files from frame_bytes pools
    (md5 of all zeros = 'unset' per spec; decoders do not verify it)."""
    out = bytearray(b"fLaC")
    si = bytearray()
    si += struct.pack(">HH", _BLOCK, _BLOCK)
    si += b"\x00\x00\x00" * 2
    packed = (sample_rate << 44) | ((ch - 1) << 41) | ((16 - 1) << 36) | n_samples
    si += packed.to_bytes(8, "big")
    si += md5
    out += bytes([0x80]) + len(si).to_bytes(3, "big") + si
    return bytes(out)
