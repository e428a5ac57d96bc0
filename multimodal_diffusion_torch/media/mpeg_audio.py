"""MPEG-1 program-stream audio extraction (GRID corpus `.mpg` clips; the
port's own copy of the JAX package's ``media/mpeg_audio.py``, numpy and
ctypes).

No ffmpeg binary is needed: the opencv-python wheel bundles the ffmpeg
shared libraries. This module:

  1. demuxes the MPEG-1 program stream in pure Python (pack headers
     0x000001BA, PES packets 0xC0-0xDF, MPEG-1 PES header skipping) into
     the MP2 elementary stream;
  2. splits MP2 frames by their sync headers (frame length from the
     bitrate/samplerate tables);
  3. decodes them with the bundled `libavcodec` via ctypes (one packet per
     frame, S16/S16P output), with hard sanity checks on the few AVPacket/
     AVFrame struct offsets used.

Those offsets are libavcodec's own, and known here for its majors
``KNOWN_AVCODEC_MAJORS`` only (ffmpeg 5 to 8): another major, or no bundled
library (no cv2, or a wheel without ffmpeg), makes ``available()`` False
and the decode raise RuntimeError; no offset is guessed.
"""

from __future__ import annotations

import ctypes
import glob
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# 1. MPEG-1 program stream demux (pure Python)
# ---------------------------------------------------------------------------


def demux_ps_audio(path, stream_id: int = 0xC0) -> bytes:
    """Extract the elementary audio stream from an MPEG-1 program stream.

    Walks start codes; for audio PES packets (default stream 0xC0) skips the
    MPEG-1 PES header (stuffing 0xFF bytes, optional STD buffer field,
    PTS/DTS or 0x0F terminator) and concatenates the payloads."""
    data = Path(path).read_bytes()
    out = bytearray()
    i = 0
    n = len(data)
    while True:
        i = data.find(b"\x00\x00\x01", i)
        if i < 0 or i + 4 > n:
            break
        sid = data[i + 3]
        if sid == 0xBA:  # pack header: MPEG-1 is 12 bytes total
            i += 12
            continue
        if sid == 0xB9:  # end code
            break
        if sid in (0xBB, 0xBE, 0xBF) or 0xE0 <= sid <= 0xEF or (
            0xBD == sid
        ) or (0xC0 <= sid <= 0xDF and sid != stream_id):
            # system header / padding / video / other audio: skip by length
            if i + 6 > n:
                break
            length = int.from_bytes(data[i + 4 : i + 6], "big")
            i += 6 + length
            continue
        if sid == stream_id:
            if i + 6 > n:
                break
            length = int.from_bytes(data[i + 4 : i + 6], "big")
            p = i + 6
            end = min(p + length, n)
            # MPEG-1 PES header
            while p < end and data[p] == 0xFF:  # stuffing
                p += 1
            if p < end and (data[p] & 0xC0) == 0x40:  # STD buffer size
                p += 2
            if p < end:
                top = data[p] >> 4
                if top == 0x2:  # PTS
                    p += 5
                elif top == 0x3:  # PTS + DTS
                    p += 10
                else:  # 0x0F "no timestamp" byte
                    p += 1
            out += data[p:end]
            i = end
            continue
        # video start codes (00/B3/B8...) inside an elementary stream we
        # never enter (video PES skipped above); just advance
        i += 3
    return bytes(out)


# ---------------------------------------------------------------------------
# 2. MP2 frame split
# ---------------------------------------------------------------------------

_L2_BITRATES = (0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
                320, 384)  # kbps, MPEG-1 Layer II
_SAMPLE_RATES = (44100, 48000, 32000)


def parse_mp2_header(b: bytes) -> Optional[Tuple[int, int, int, int]]:
    """4 header bytes -> (frame_bytes, sample_rate, channels, bitrate_kbps)
    or None if not an MPEG-1 Layer II sync."""
    if len(b) < 4 or b[0] != 0xFF or (b[1] & 0xF6) != 0xF4:
        # sync 0xFFF, ID=1 (MPEG-1), layer bits '10' (Layer II)
        return None
    bitrate_idx = b[2] >> 4
    sr_idx = (b[2] >> 2) & 0x3
    if bitrate_idx in (0, 15) or sr_idx == 3:
        return None
    padding = (b[2] >> 1) & 0x1
    mode = b[3] >> 6
    sr = _SAMPLE_RATES[sr_idx]
    bitrate = _L2_BITRATES[bitrate_idx]
    frame_bytes = 144 * bitrate * 1000 // sr + padding
    channels = 1 if mode == 3 else 2
    return frame_bytes, sr, channels, bitrate


def split_mp2_frames(es: bytes) -> Tuple[List[bytes], int, int]:
    """Elementary stream -> (frames, sample_rate, channels)."""
    frames: List[bytes] = []
    sr = ch = None
    i = 0
    n = len(es)
    while i + 4 <= n:
        hdr = parse_mp2_header(es[i : i + 4])
        if hdr is None:
            i += 1
            continue
        fb, f_sr, f_ch, _ = hdr
        if i + fb > n:
            break
        if sr is None:
            sr, ch = f_sr, f_ch
        if f_sr == sr and f_ch == ch:
            frames.append(es[i : i + fb])
            i += fb
        else:
            i += 1
    if sr is None:
        raise ValueError("no MP2 frames found in elementary stream")
    return frames, sr, ch


# ---------------------------------------------------------------------------
# 3. libavcodec decode via ctypes (bundled with opencv-python)
# ---------------------------------------------------------------------------

# libavcodec majors whose struct layouts the offsets below were read from
# (ffmpeg 5.x = 59 ... ffmpeg 8.x = 62)
KNOWN_AVCODEC_MAJORS = (59, 60, 61, 62)
# AVPacket field offsets (stable since ffmpeg 4: buf, pts, dts, data, size)
_PKT_DATA_OFF = 24
_PKT_SIZE_OFF = 32
# AVFrame field offsets (stable since ffmpeg 5: data[8], linesize[8],
# extended_data, width, height, nb_samples, format)
_FRM_DATA_OFF = 0
_FRM_NB_SAMPLES_OFF = 112
_FRM_FORMAT_OFF = 116
_FMT_S16 = 1
_FMT_S16P = 6
_EAGAIN = -11

_libs = None


def _bundled_dir() -> Path:
    try:
        import cv2  # locate the wheel's bundled libs
    except ImportError as err:
        raise RuntimeError(f"no bundled ffmpeg: cv2 does not import ({err})") from err
    return Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs"


def avcodec_major() -> int:
    """The major version of the bundled libavcodec (RuntimeError when there
    is none)."""
    return _load_ffmpeg()[1].avcodec_version() >> 16


def _load_ffmpeg():
    global _libs
    if _libs is not None:
        return _libs
    root = _bundled_dir()

    def find(name):
        hits = sorted(glob.glob(str(root / f"lib{name}-*.so*")))
        if not hits:
            raise RuntimeError(
                f"bundled ffmpeg lib{name} not found under {root}")
        return hits[0]

    avutil = ctypes.CDLL(find("avutil"), mode=ctypes.RTLD_GLOBAL)
    # avcodec's DT_NEEDED (hashed names) resolve via its rpath
    avcodec = ctypes.CDLL(find("avcodec"), mode=ctypes.RTLD_GLOBAL)
    avcodec.avcodec_version.restype = ctypes.c_uint
    major = avcodec.avcodec_version() >> 16
    if major not in KNOWN_AVCODEC_MAJORS:
        raise RuntimeError(
            f"bundled libavcodec major {major} is not one whose AVPacket/AVFrame "
            f"offsets are known here ({KNOWN_AVCODEC_MAJORS})")

    avcodec.avcodec_find_decoder_by_name.restype = ctypes.c_void_p
    avcodec.avcodec_find_decoder_by_name.argtypes = [ctypes.c_char_p]
    avcodec.avcodec_alloc_context3.restype = ctypes.c_void_p
    avcodec.avcodec_alloc_context3.argtypes = [ctypes.c_void_p]
    avcodec.avcodec_open2.restype = ctypes.c_int
    avcodec.avcodec_open2.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p]
    avcodec.av_packet_alloc.restype = ctypes.c_void_p
    avcodec.av_new_packet.restype = ctypes.c_int
    avcodec.av_new_packet.argtypes = [ctypes.c_void_p, ctypes.c_int]
    avcodec.av_packet_unref.argtypes = [ctypes.c_void_p]
    avcodec.avcodec_send_packet.restype = ctypes.c_int
    avcodec.avcodec_send_packet.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    avcodec.avcodec_receive_frame.restype = ctypes.c_int
    avcodec.avcodec_receive_frame.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    avutil.av_frame_alloc.restype = ctypes.c_void_p
    avutil.av_frame_unref.argtypes = [ctypes.c_void_p]
    _libs = (avutil, avcodec)
    return _libs


def _read_i32(ptr: int, off: int) -> int:
    return ctypes.c_int.from_address(ptr + off).value


def _read_ptr(ptr: int, off: int) -> int:
    return ctypes.c_void_p.from_address(ptr + off).value or 0


def decode_mp2_frames(frames: List[bytes], sr: int, ch: int) -> np.ndarray:
    """MP2 frames -> float32 interleaved-as-[n, ch] PCM in [-1, 1]."""
    avutil, avcodec = _load_ffmpeg()
    codec = avcodec.avcodec_find_decoder_by_name(b"mp2")
    if not codec:
        raise RuntimeError("bundled libavcodec has no mp2 decoder")
    ctx = avcodec.avcodec_alloc_context3(ctypes.c_void_p(codec))
    if avcodec.avcodec_open2(ctypes.c_void_p(ctx), ctypes.c_void_p(codec),
                             None) < 0:
        raise RuntimeError("avcodec_open2(mp2) failed")
    pkt = avcodec.av_packet_alloc()
    frm = avutil.av_frame_alloc()

    chunks: List[np.ndarray] = []

    def receive_all():
        while True:
            rc = avcodec.avcodec_receive_frame(ctypes.c_void_p(ctx),
                                               ctypes.c_void_p(frm))
            if rc == _EAGAIN or rc < 0:
                return
            nb = _read_i32(frm, _FRM_NB_SAMPLES_OFF)
            fmt = _read_i32(frm, _FRM_FORMAT_OFF)
            if nb != 1152 or fmt not in (_FMT_S16, _FMT_S16P):
                raise RuntimeError(
                    f"AVFrame layout sanity check failed (nb_samples={nb}, "
                    f"format={fmt}): ffmpeg struct offsets drifted")
            if fmt == _FMT_S16P:
                planes = []
                for c in range(ch):
                    d = _read_ptr(frm, _FRM_DATA_OFF + 8 * c)
                    buf = ctypes.string_at(d, nb * 2)
                    planes.append(np.frombuffer(buf, np.int16))
                pcm = np.stack(planes, axis=-1)  # [nb, ch]
            else:
                d = _read_ptr(frm, _FRM_DATA_OFF)
                buf = ctypes.string_at(d, nb * ch * 2)
                pcm = np.frombuffer(buf, np.int16).reshape(nb, ch)
            chunks.append(pcm.astype(np.float32) / 32768.0)
            avutil.av_frame_unref(ctypes.c_void_p(frm))

    for fr in frames:
        if avcodec.av_new_packet(ctypes.c_void_p(pkt), len(fr)) != 0:
            raise RuntimeError("av_new_packet failed")
        data_ptr = _read_ptr(pkt, _PKT_DATA_OFF)
        size = _read_i32(pkt, _PKT_SIZE_OFF)
        if size != len(fr) or not data_ptr:
            raise RuntimeError("AVPacket layout sanity check failed: "
                               "ffmpeg struct offsets drifted")
        ctypes.memmove(data_ptr, fr, len(fr))
        if avcodec.avcodec_send_packet(ctypes.c_void_p(ctx),
                                       ctypes.c_void_p(pkt)) == 0:
            receive_all()
        avcodec.av_packet_unref(ctypes.c_void_p(pkt))
    # drain
    avcodec.avcodec_send_packet(ctypes.c_void_p(ctx), None)
    receive_all()

    if not chunks:
        raise RuntimeError("mp2 decode produced no samples")
    return np.concatenate(chunks, axis=0)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def read_mpeg_audio(path, sr: Optional[int] = None,
                    mono: bool = True) -> Tuple[np.ndarray, int]:
    """`.mpg` program stream -> (float32 waveform, sample_rate).

    mono=True averages channels; sr resamples (media/audio_io.resample)."""
    es = demux_ps_audio(path)
    frames, src_sr, ch = split_mp2_frames(es)
    pcm = decode_mp2_frames(frames, src_sr, ch)  # [n, ch]
    y = pcm.mean(axis=-1) if mono else pcm
    if sr is not None and sr != src_sr:
        from .audio_io import resample

        y = resample(y, src_sr, sr)
        return y.astype(np.float32), sr
    return y.astype(np.float32), src_sr


def available() -> bool:
    """Whether the bundled libavcodec is there, of a known major."""
    try:
        _load_ffmpeg()
        return True
    except Exception:
        return False
