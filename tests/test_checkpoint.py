"""Decode-state checkpoint/resume (runtime/checkpoint.py, SURVEY §5.4).

Property under test: for any picture boundary k, decoding pictures
1..k, checkpointing, restoring in a fresh decoder, and decoding the
rest from stream_pos yields byte-identical frames to one uninterrupted
decode — including DPB ordering, POC continuity, MMCO state, and
colocated-MV pages (temporal direct)."""

import pathlib
import pickle
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from streamgen.h264_enc import H264BGen, H264InterGen, H264MmcoGen  # noqa: E402
from streamgen.mpeg2_enc import Mpeg2StreamGen  # noqa: E402

from m2dec_tpu.codecs.h264.decoder import H264Decoder  # noqa: E402
from m2dec_tpu.codecs.mpeg2.decoder import Mpeg2Decoder  # noqa: E402
from m2dec_tpu.runtime import checkpoint  # noqa: E402
from m2dec_tpu.runtime.output import cropped_nv12_bytes  # noqa: E402


def h264_full(data):
    dec = H264Decoder()
    dec.set_data(data)
    return b"".join(cropped_nv12_bytes(f) for f in dec.decode_all())


def h264_resumed(data, k):
    """Decode k pictures, checkpoint, resume in a new decoder."""
    dec = H264Decoder()
    dec.set_data(data)
    out = []
    for _ in range(k):
        ready, frm = dec.peek_decoded_frame()
        while ready:
            dec.get_decoded_frame()
            out.append(frm)
            ready, frm = dec.peek_decoded_frame()
        assert dec.decode_picture() == 1
    blob, pos = checkpoint.save(dec)
    assert 0 < pos <= len(data)
    del dec

    dec2 = checkpoint.load(blob)
    dec2.set_data(data[pos:])
    while True:
        ready, frm = dec2.peek_decoded_frame()
        while ready:
            dec2.get_decoded_frame()
            out.append(frm)
            ready, frm = dec2.peek_decoded_frame()
        if dec2.decode_picture() < 0:
            ready, frm = dec2.peek_decoded_frame(True)
            while ready:
                dec2.get_decoded_frame(True)
                out.append(frm)
                ready, frm = dec2.peek_decoded_frame(True)
            break
    return b"".join(cropped_nv12_bytes(f) for f in out)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_h264_b_frames_resume(k):
    data = H264BGen(80, 48, seed=9, num_ref_frames=3,
                    b_direct_prob=0.4).generate("IPBBPBBP")
    assert h264_resumed(data, k) == h264_full(data)


@pytest.mark.parametrize("k", [1, 3])
def test_h264_multigop_resume(k):
    data = H264InterGen(80, 48, seed=2,
                        num_ref_frames=2).generate("IPPIPPP")
    assert h264_resumed(data, k) == h264_full(data)


def test_h264_mmco_resume():
    data = H264MmcoGen(80, 48, seed=4, num_ref_frames=3).generate("IPPPPP")
    assert h264_resumed(data, 2) == h264_full(data)


def test_h264_cabac_resume():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from streamgen.h264_transcode import transcode_to_cabac

    import random

    data = H264InterGen(80, 48, seed=5, num_ref_frames=2).generate("IPPP")
    data = transcode_to_cabac(data, random.Random(5))
    assert h264_resumed(data, 2) == h264_full(data)


def test_checkpoint_blob_is_self_contained():
    """The blob round-trips through bytes (cross-process shape)."""
    data = H264InterGen(80, 48, seed=1, num_ref_frames=2).generate("IPP")
    dec = H264Decoder()
    dec.set_data(data)
    dec.decode_picture()
    blob, pos = checkpoint.save(dec)
    assert blob[:12] == checkpoint.MAGIC
    rt = pickle.loads(pickle.dumps(checkpoint.load(blob)))
    assert rt.inited and rt.max_x == dec.max_x
    with pytest.raises(ValueError):
        checkpoint.load(b"garbage" + blob)


def mpeg2_full(data):
    dec = Mpeg2Decoder()
    dec.set_data(data)
    return b"".join(cropped_nv12_bytes(f) for f in dec.decode_all())


@pytest.mark.parametrize("k", [1, 2, 3])
def test_mpeg2_resume(k):
    data = Mpeg2StreamGen(80, 48, seed=6).generate("IPPBPB" + "I")
    dec = Mpeg2Decoder()
    dec.set_data(data)
    out = []
    for _ in range(k):
        ready, frm = dec.peek_decoded_frame()
        while ready:
            dec.get_decoded_frame()
            out.append(frm)
            ready, frm = dec.peek_decoded_frame()
        assert dec.decode_data() == 1
    blob, pos = checkpoint.save(dec)
    dec2 = checkpoint.load(blob)
    dec2.set_data(data[pos:])
    while True:
        ready, frm = dec2.peek_decoded_frame()
        while ready:
            dec2.get_decoded_frame()
            out.append(frm)
            ready, frm = dec2.peek_decoded_frame()
        if dec2.decode_data() < 0:
            ready, frm = dec2.peek_decoded_frame(True)
            while ready:
                dec2.get_decoded_frame(True)
                out.append(frm)
                ready, frm = dec2.peek_decoded_frame(True)
            break
    assert b"".join(cropped_nv12_bytes(f) for f in out) == mpeg2_full(data)


def test_h265_resume():
    """H.265 checkpoint/resume at slice boundaries (default Python
    decode path): outputs equal an uninterrupted decode."""
    from streamgen.h265_enc import H265StreamGen

    from m2dec_tpu.codecs.h265.headers import H265Decoder

    data = H265StreamGen(64, 64, seed=3).generate("IPPP")
    full_dec = H265Decoder()
    full_dec.set_data(data)
    full = b"".join(cropped_nv12_bytes(f) for f in full_dec.decode_all())

    dec = H265Decoder()
    dec.set_data(data)
    dec.begin_decode()
    out = []
    for _ in range(2):  # two slices/pictures
        assert dec.decode_picture() == 1
        ready, frm = dec.peek_decoded_frame()
        while ready:
            dec.get_decoded_frame()
            out.append(frm)
            ready, frm = dec.peek_decoded_frame()
    blob, pos = checkpoint.save(dec)
    dec2 = checkpoint.load(blob)
    dec2.set_data(data[pos:])
    dec2.begin_decode()
    while True:
        err = dec2.decode_picture()
        ready, frm = dec2.peek_decoded_frame()
        while ready:
            dec2.get_decoded_frame()
            out.append(frm)
            ready, frm = dec2.peek_decoded_frame()
        if err < 0:
            ready, frm = dec2.peek_decoded_frame(True)
            while ready:
                dec2.get_decoded_frame(True)
                out.append(frm)
                ready, frm = dec2.peek_decoded_frame(True)
            break
    assert b"".join(cropped_nv12_bytes(f) for f in out) == full


# ---------------------------------------------------------------------
# format hardening: version + schema digest in the
# header; stale blobs refuse to load instead of resuming silently
# ---------------------------------------------------------------------


def _small_h264_blob():
    data = H264InterGen(48, 48, seed=7).generate("IP")
    dec = H264Decoder()
    dec.set_data(data)
    assert dec.decode_picture() == 1
    return checkpoint.save(dec)[0]


def test_checkpoint_bad_magic_refused():
    with pytest.raises(ValueError, match="magic"):
        checkpoint.load(b"not-a-checkpoint-blob")


def test_checkpoint_version_mismatch_refused():
    import struct

    blob = _small_h264_blob()
    m = len(checkpoint.MAGIC)
    bad = (blob[:m] + struct.pack("<H", checkpoint.FORMAT_VERSION + 1)
           + blob[m + 2:])
    with pytest.raises(ValueError, match="format v"):
        checkpoint.load(bad)


def test_checkpoint_schema_change_refused(monkeypatch):
    """A blob written by a different revision of the decoder module
    (e.g. a field rename) must fail loudly, not resume with stale
    state. Simulated by saving under a forged schema digest — exactly
    what an old-revision blob carries."""
    real = checkpoint._schema_digest
    monkeypatch.setattr(checkpoint, "_schema_digest",
                        lambda cls: b"\x00" * 16)
    blob = _small_h264_blob()
    monkeypatch.setattr(checkpoint, "_schema_digest", real)
    with pytest.raises(ValueError, match="schema mismatch"):
        checkpoint.load(blob)
