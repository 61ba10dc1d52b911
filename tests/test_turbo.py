"""Overlapped two-phase driver (runtime/turbo.py): output frames,
order, and error containment must be bit-identical to the serial
decoder's decode_all pull loop (m2decoder.h:132-157 semantics)."""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.h264_enc import (  # noqa: E402
    H264BGen,
    H264HighGen,
    H264MmcoGen,
)

from m2dec_tpu.codecs.h264.decoder import H264Decoder  # noqa: E402
from m2dec_tpu.native import load_h264  # noqa: E402
from m2dec_tpu.runtime.turbo import TurboH264Decoder  # noqa: E402

pytestmark = pytest.mark.skipif(load_h264() is None,
                                reason="native toolchain unavailable")


def serial_frames(data):
    dec = H264Decoder()
    dec.set_data(data)
    return dec.decode_all()


def assert_equiv(data, batch):
    exp = serial_frames(data)
    got = TurboH264Decoder(data, batch=batch).decode_all()
    assert len(got) == len(exp)
    for k, (g, e) in enumerate(zip(got, exp)):
        assert g.cnt == e.cnt, f"frame {k} poc"
        assert g.crop == e.crop
        assert np.array_equal(g.y, e.y), f"frame {k} y"
        assert np.array_equal(g.cb, e.cb), f"frame {k} cb"
        assert np.array_equal(g.cr, e.cr), f"frame {k} cr"


@pytest.mark.parametrize("batch", [1, 3, 12])
def test_b_reordered_stream(batch):
    gen = H264BGen(48, 32, seed=2, skip_prob=0.2, intra_prob=0.15,
                   num_ref_frames=2, b_direct_prob=0.3, qp=30,
                   disable_deblock=False)
    assert_equiv(gen.generate("IPBBPBBPB"), batch)


def test_compact_mc_path(monkeypatch):
    """The compacted MC path (uniform-MB wide fetches + inter-only
    cell gathers) stays bit-equal to the serial decode; it is opt-in on
    every backend (see _derive_mc_aux)."""
    monkeypatch.setenv("M2DEC_TPU_MC", "compact")
    gen = H264BGen(64, 48, seed=11, skip_prob=0.5, intra_prob=0.1,
                   num_ref_frames=2, b_direct_prob=0.3, qp=30,
                   disable_deblock=False)
    assert_equiv(gen.generate("IPPBBP"), 6)


def test_multi_gop_idr():
    gen = H264HighGen(48, 32, seed=4, skip_prob=0.25, intra_prob=0.15,
                      qp=27, disable_deblock=False)
    assert_equiv(gen.generate("IPPIPP"), 4)


def test_mmco_stream():
    gen = H264MmcoGen(48, 32, seed=1, skip_prob=0.2, intra_prob=0.15)
    assert_equiv(gen.generate("IPPPPP"), 4)


def test_pcm_stream():
    gen = H264BGen(48, 32, seed=5, skip_prob=0.2, intra_prob=0.3,
                   ipcm_prob=0.5, num_ref_frames=2, b_direct_prob=0.2)
    assert_equiv(gen.generate("IPBP"), 3)


def test_truncated_stream_drains():
    gen = H264BGen(48, 32, seed=2, skip_prob=0.2, intra_prob=0.15,
                   num_ref_frames=2, b_direct_prob=0.3)
    data = gen.generate("IPBBP")
    cut = data[: len(data) * 3 // 4]
    exp = serial_frames(cut)
    t = TurboH264Decoder(cut, batch=4)
    got = t.decode_all()
    assert t.error < 0
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert np.array_equal(g.y, e.y)


def test_pipeline_two_phase():
    from m2dec_tpu.runtime.pipeline import Pipeline

    gen = H264BGen(48, 32, seed=7, skip_prob=0.2, intra_prob=0.15,
                   num_ref_frames=2, b_direct_prob=0.3)
    data = gen.generate("IPBBPBB")
    exp = serial_frames(data)
    got = []
    n = Pipeline(data, two_phase=True).run(got.append)
    assert n == len(exp)
    for g, e in zip(got, exp):
        assert np.array_equal(g.y, e.y)
        assert np.array_equal(g.cb, e.cb)
        assert np.array_equal(g.cr, e.cr)


# ---------------------------------------------------------------------
# H.265 overlapped driver: TurboH265Decoder must match
# the serial decode_all(backend="native") byte-for-byte
# ---------------------------------------------------------------------


def _h265_serial(data):
    from m2dec_tpu.codecs.h265.headers import H265Decoder

    dec = H265Decoder()
    dec.set_data(data)
    return dec.decode_all(backend="native")


def _h265_assert_equiv(data, batch):
    from m2dec_tpu.native import load_h265
    from m2dec_tpu.runtime.turbo import TurboH265Decoder

    if load_h265() is None:
        pytest.skip("native toolchain unavailable")
    exp = _h265_serial(data)
    got = TurboH265Decoder(data, batch=batch).decode_all()
    assert len(got) == len(exp)
    for k, (g, e) in enumerate(zip(got, exp)):
        assert g.cnt == e.cnt, f"frame {k} poc"
        assert g.crop == e.crop
        assert np.array_equal(g.y, e.y), f"frame {k} y"
        assert np.array_equal(g.cb, e.cb), f"frame {k} cb"
        assert np.array_equal(g.cr, e.cr), f"frame {k} cr"


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_h265_turbo_b_stream(batch):
    from streamgen.h265_enc import ALL_MODES, H265StreamGen

    data = H265StreamGen(64, 48, seed=82, qp=32, cbf_prob=0.4,
                         modes=ALL_MODES, tmvp=1, deblock=1, sao=1,
                         max_level=1).generate("IPBPB")
    _h265_assert_equiv(data, batch)


def test_h265_turbo_intra_multi_gop():
    from streamgen.h265_enc import H265StreamGen

    data = H265StreamGen(64, 48, seed=5).generate(5)
    _h265_assert_equiv(data, 2)


def test_h265_turbo_nonaligned_crop():
    from streamgen.h265_enc import ALL_MODES, H265StreamGen

    data = H265StreamGen(52, 36, seed=3, qp=30, cbf_prob=0.5,
                         modes=ALL_MODES, deblock=1,
                         max_level=1).generate("IPP")
    _h265_assert_equiv(data, 3)


@pytest.mark.parametrize("nsl", [2, 3])
def test_h265_turbo_multi_slice(nsl):
    """Row-aligned multi-slice pictures dispatch through the device
    pool as single-picture slice-replay graphs."""
    from streamgen.h265_enc import ALL_MODES, H265StreamGen

    class _MS(H265StreamGen):
        pass

    gen = _MS(64, 96, seed=200 + nsl, qp=30, cbf_prob=0.5,
              modes=ALL_MODES, tmvp=1, deblock=1, sao=1, max_level=1)
    gen.slices_per_pic = nsl
    data = gen.generate("IPBP")
    _h265_assert_equiv(data, 2)


def test_h265_turbo_multi_slice_mixed_batch():
    """Single- and multi-slice pictures interleave in one stream: the
    driver must flush pending batches around each slice-replay
    dispatch to keep pool order."""
    from streamgen.h265_enc import ALL_MODES, H265StreamGen

    gen = H265StreamGen(64, 96, seed=77, qp=31, cbf_prob=0.4,
                        modes=ALL_MODES, tmvp=1, deblock=1, sao=1,
                        max_level=1)
    one = gen.generate("IPP")
    gen2 = H265StreamGen(64, 96, seed=78, qp=31, cbf_prob=0.4,
                         modes=ALL_MODES, tmvp=1, deblock=1, sao=1,
                         max_level=1)
    gen2.slices_per_pic = 3
    two = gen2.generate("IPB")
    _h265_assert_equiv(one + two, 4)


def test_h265_turbo_truncated_drains():
    from streamgen.h265_enc import H265StreamGen
    from m2dec_tpu.native import load_h265
    from m2dec_tpu.runtime.turbo import TurboH265Decoder

    if load_h265() is None:
        pytest.skip("native toolchain unavailable")
    data = H265StreamGen(64, 48, seed=7).generate(3)
    cut = data[: len(data) - len(data) // 4]
    t = TurboH265Decoder(cut, batch=2)
    got = t.decode_all()
    assert t.error < 0
    # the serial path on the same truncated input is the arbiter
    exp = _h265_serial(cut)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert np.array_equal(g.y, e.y)


# ---------------------------------------------------------------------
# MPEG-2 overlapped driver
# ---------------------------------------------------------------------


def _m2_serial(data):
    from m2dec_tpu.codecs.mpeg2.decoder import Mpeg2Decoder

    dec = Mpeg2Decoder()
    dec.set_data(data)
    return dec.decode_all()


def _m2_assert_equiv(data, batch):
    from m2dec_tpu.runtime.turbo import TurboMpeg2Decoder

    exp = _m2_serial(data)
    got = TurboMpeg2Decoder(data, batch=batch).decode_all()
    assert len(got) == len(exp)
    for k, (g, e) in enumerate(zip(got, exp)):
        assert g.cnt == e.cnt, f"frame {k} cnt"
        assert np.array_equal(g.y, e.y), f"frame {k} y"
        assert np.array_equal(g.cb, e.cb), f"frame {k} cb"
        assert np.array_equal(g.cr, e.cr), f"frame {k} cr"


@pytest.mark.parametrize("batch", [1, 3, 12])
def test_mpeg2_turbo_ipb(batch):
    from streamgen.mpeg2_enc import Mpeg2StreamGen

    data = Mpeg2StreamGen(80, 48, seed=11).generate("IPPBPBB")
    _m2_assert_equiv(data, batch)


def test_mpeg2_turbo_multi_gop():
    from streamgen.mpeg2_enc import Mpeg2StreamGen

    data = Mpeg2StreamGen(96, 64, seed=3).generate("IPPBIPPB")
    _m2_assert_equiv(data, 3)


def test_mpeg2_turbo_fieldmc_frame_pictures():
    """frame pictures with FIELD MC (frame_motion_type 1) ride the
    has_field batch graph."""
    from streamgen.mpeg2_enc import Mpeg2FieldMcGen

    data = Mpeg2FieldMcGen(80, 48, seed=9, field_prob=0.7).generate(
        "IPPBP")
    _m2_assert_equiv(data, 3)


@pytest.mark.parametrize("pat", ["IIPP", "IIPPBBPP"])
def test_mpeg2_turbo_field_pictures(pat):
    """Field PICTURES (structure 1/2) ride the batched graph: the plan
    tensors fully capture the reference's frame_mode=0 field decode
    model."""
    from streamgen.mpeg2_enc import Mpeg2FieldPicGen

    data = Mpeg2FieldPicGen(80, 48, seed=9).generate(pat)
    _m2_assert_equiv(data, 3)
