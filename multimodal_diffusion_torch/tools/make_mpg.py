"""Write an MPEG-1 program stream (``.mpg``) of a tone, its MP2 audio made
by the mp2 encoder of the ffmpeg libraries that the opencv-python wheel
bundles (driven through ctypes, as ``media/mpeg_audio.py`` drives the
decoder): a clip for ``media/mpeg_audio.py`` to read where no GRID corpus
is at hand.

    python -m multimodal_diffusion_torch.tools.make_mpg out.mpg [--seconds 0.5]

32 kHz mono at 64 kbps. The stream has pack headers, audio PES packets of
the three MPEG-1 header kinds (no timestamp; stuffing, STD buffer and PTS;
PTS and DTS), a system header, video and padding packets and the end code.
Raises RuntimeError where ``mpeg_audio.available()`` is False.
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import numpy as np

from ..media import mpeg_audio as M

SR, KBPS = 32000, 64
V = ctypes.c_void_p


def _silent_frame() -> bytes:
    """One MPEG-1 Layer II frame, 32 kHz mono 64 kbps, no CRC, every
    subband's bit allocation 0: a valid frame that decodes to silence."""
    return bytes([0xFF, 0xFD, 0x48, 0xC0]) + bytes(144 * KBPS * 1000 // SR - 4)


def _check(rc: int, what: str) -> int:
    if rc < 0:
        raise RuntimeError(f"{what} failed ({rc})")
    return rc


def encode_mp2(pcm: np.ndarray) -> bytes:
    """int16 mono PCM -> an MP2 elementary stream from the bundled mp2
    encoder. The frame handed to the encoder is one the mp2 decoder made
    (of ``_silent_frame``), so its channel layout and buffers are
    libavcodec's own; only data[0], nb_samples and format are touched, at
    mpeg_audio's offsets. The encoder context takes its rate, bit rate and
    layout as AVOptions; its sample format, which has no AVOption, is set
    at the offset where the decoder context holds S16P right after the
    32000 that both contexts hold as their sample rate."""
    avutil, avcodec = M._load_ffmpeg()
    avcodec.avcodec_find_encoder_by_name.restype = V
    avcodec.avcodec_find_encoder_by_name.argtypes = [ctypes.c_char_p]
    avcodec.avcodec_send_frame.argtypes = [V, V]
    avcodec.avcodec_receive_packet.argtypes = [V, V]
    avutil.av_opt_set.argtypes = [V, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    avutil.av_opt_set_int.argtypes = [V, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]

    dec = avcodec.avcodec_find_decoder_by_name(b"mp2")
    dctx = avcodec.avcodec_alloc_context3(V(dec))
    _check(avcodec.avcodec_open2(V(dctx), V(dec), None), "open the decoder")
    pkt, frm = avcodec.av_packet_alloc(), avutil.av_frame_alloc()
    silent = _silent_frame()
    _check(avcodec.av_new_packet(V(pkt), len(silent)), "av_new_packet")
    ctypes.memmove(M._read_ptr(pkt, M._PKT_DATA_OFF), silent, len(silent))
    _check(avcodec.avcodec_send_packet(V(dctx), V(pkt)), "send_packet")
    _check(avcodec.avcodec_receive_frame(V(dctx), V(frm)), "receive_frame")
    assert M._read_i32(frm, M._FRM_NB_SAMPLES_OFF) == 1152

    enc = avcodec.avcodec_find_encoder_by_name(b"mp2")
    assert enc, "the bundled libavcodec has no mp2 encoder"
    ectx = avcodec.avcodec_alloc_context3(V(enc))
    _check(avutil.av_opt_set_int(V(ectx), b"ar", SR, 0), "ar")
    _check(avutil.av_opt_set_int(V(ectx), b"b", KBPS * 1000, 0), "b")
    _check(avutil.av_opt_set(V(ectx), b"ch_layout", b"mono", 0), "ch_layout")
    d_ints = np.frombuffer(ctypes.string_at(dctx, 2048), np.int32)
    e_ints = np.frombuffer(ctypes.string_at(ectx, 2048), np.int32)
    at = [i + 1 for i in range(len(d_ints) - 1)
          if d_ints[i] == e_ints[i] == SR and d_ints[i + 1] == M._FMT_S16P
          and e_ints[i + 1] == -1]
    assert len(at) == 1, f"the sample format field is not unique: {at}"
    ctypes.c_int.from_address(ectx + 4 * at[0]).value = M._FMT_S16
    _check(avcodec.avcodec_open2(V(ectx), V(enc), None), "open the encoder")
    ctypes.c_int.from_address(frm + M._FRM_FORMAT_OFF).value = M._FMT_S16

    out = bytearray()

    def receive():
        while avcodec.avcodec_receive_packet(V(ectx), V(pkt)) >= 0:
            out.extend(ctypes.string_at(M._read_ptr(pkt, M._PKT_DATA_OFF),
                                        M._read_i32(pkt, M._PKT_SIZE_OFF)))
            avcodec.av_packet_unref(V(pkt))

    for k in range(len(pcm) // 1152):
        chunk = np.ascontiguousarray(pcm[k * 1152:(k + 1) * 1152], np.int16)
        ctypes.memmove(M._read_ptr(frm, M._FRM_DATA_OFF), chunk.tobytes(), chunk.nbytes)
        _check(avcodec.avcodec_send_frame(V(ectx), V(frm)), "send_frame")
        receive()
    avcodec.avcodec_send_frame(V(ectx), None)
    receive()
    return bytes(out)


def _pes(stream_id: int, header: bytes, payload: bytes) -> bytes:
    body = header + payload
    return b"\x00\x00\x01" + bytes([stream_id]) + len(body).to_bytes(2, "big") + body


PACK = b"\x00\x00\x01\xba" + bytes([0x21, 0x00, 0x01, 0x00, 0x01, 0x80, 0x1b, 0x91])
PTS = bytes([0x21, 0x00, 0x01, 0x00, 0x01])
# the MPEG-1 PES header kinds: no timestamp; stuffing + STD buffer + PTS;
# PTS + DTS
HEADERS = (b"\x0f", b"\xff\xff" + b"\x40\x20" + PTS,
           bytes([0x31, 0, 1, 0, 1, 0x11, 0, 1, 0, 1]))


def write_mpg(path, es: bytes, chunk: int = 700) -> None:
    """`es` in audio PES packets of `chunk` bytes (the header kinds in
    turn), each after a pack header; a system header, a video packet and a
    padding packet between them; the end code last."""
    out = bytearray(PACK + _pes(0xBB, b"", bytes(6)))
    for k, i in enumerate(range(0, len(es), chunk)):
        out += PACK + _pes(0xC0, HEADERS[k % 3], es[i:i + chunk])
        if k % 2:
            out += _pes(0xE0, b"\x0f", b"\x00\x00\x01\xb3" + bytes(20))
            out += _pes(0xBE, b"", b"\xff" * 9)
    out += b"\x00\x00\x01\xb9"
    path.write_bytes(bytes(out))



def tone(seconds: float = 0.5, freq: float = 440.0, amplitude: float = 0.4) -> np.ndarray:
    """int16 mono samples of a sine at SR."""
    t = np.arange(int(SR * seconds)) / SR
    return (amplitude * np.sin(2 * np.pi * freq * t) * 32767).astype(np.int16)


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", type=Path)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--freq", type=float, default=440.0)
    args = ap.parse_args(argv)
    if not M.available():
        raise RuntimeError("no bundled libavcodec of a known major (media/mpeg_audio.py)")
    write_mpg(args.out, encode_mp2(tone(args.seconds, args.freq)))
    print(f"[ok] wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
