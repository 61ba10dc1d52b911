"""Randomized H.264 syntax-stream generator for decoder conformance tests.

Same philosophy as mpeg2_enc.py: emit random-but-valid Annex-B streams and
let the compiled reference decoder define golden output. Feature coverage
grows with the decoder: IPCM -> intra CAVLC -> P -> B -> CABAC.
"""

from __future__ import annotations

import random

import numpy as np

from m2dec_tpu.bitstream import BitWriter
from m2dec_tpu.bitstream.writer import escape_nal
from m2dec_tpu.codecs.h264 import tables as T

ENC_COEFF_TOKEN = [T.invert(t) for t in T.COEFF_TOKEN]
ENC_TOTAL_ZEROS = [None] + [T.invert(t) for t in T.TOTAL_ZEROS[1:]]
ENC_TOTAL_ZEROS_C = [None] + [T.invert(t) for t in T.TOTAL_ZEROS_CHROMA[1:]]
ENC_RUN_BEFORE = {k: T.invert(t) for k, t in T.RUN_BEFORE.items()}
ENC_ME_CBP = [
    {cbp: codenum for codenum, cbp in enumerate(lut)} for lut in T.ME_CBP
]


class H264StreamGen:
    #: emit frame_mbs_only=0 + per-slice field_pic_flag/bottom_field_flag
    #: (decoded with frame machinery by the reference; CABAC switches to
    #: the field significance-map contexts)
    field_pics = False

    def __init__(self, width, height, seed=0, qp=26, num_ref_frames=1,
                 disable_deblock=True, level_idc=40, chroma_qp_index=0):
        assert width % 16 == 0 and height % 16 == 0
        self.w, self.h = width, height
        self.mb_w, self.mb_h = width >> 4, height >> 4
        self.rng = random.Random(seed)
        self.qp = qp
        self.num_ref_frames = num_ref_frames
        self.disable_deblock = disable_deblock
        self.level_idc = level_idc
        self.chroma_qp_index = chroma_qp_index
        self.frame_num = 0
        self.poc_lsb = 0
        self.log2_max_frame_num = 8
        self.log2_max_poc_lsb = 8

    # ----------------------------------------------------------- NALs ----
    def _nal(self, out, nal_ref_idc, nal_type, payload_writer):
        w = BitWriter()
        payload_writer(w)
        w.rbsp_trailing_bits()
        out += b"\x00\x00\x01"
        out.append((nal_ref_idc << 5) | nal_type)
        out += escape_nal(w.tobytes())

    def _sps(self, w):
        w.put_bits(66, 8)  # baseline
        w.put_bits(0, 8)  # constraint flags
        w.put_bits(self.level_idc, 8)
        w.ue(0)  # sps_id
        w.ue(self.log2_max_frame_num - 4)
        w.ue(0)  # poc_type 0
        w.ue(self.log2_max_poc_lsb - 4)
        w.ue(self.num_ref_frames)
        w.put_bits(0, 1)  # gaps
        w.ue(self.mb_w - 1)
        w.ue(self.mb_h - 1)
        if self.field_pics:
            # frame_mbs_only=0: the reference keeps frame geometry and
            # only consumes the per-slice field flags (h264.cpp:345-346,
            # :1453-1466)
            w.put_bits(0, 1)
            w.put_bits(0, 1)  # mb_adaptive_frame_field
        else:
            w.put_bits(1, 1)  # frame_mbs_only
        w.put_bits(1, 1)  # direct_8x8_inference (required for B parity)
        w.put_bits(0, 1)  # cropping
        w.put_bits(0, 1)  # vui

    def _pps(self, w):
        w.ue(0)  # pps_id
        w.ue(0)  # sps_id
        w.put_bits(0, 1)  # entropy: CAVLC
        w.put_bits(0, 1)  # pic_order_present
        w.ue(0)  # num_slice_groups-1
        w.ue(max(0, self.num_ref_frames - 1))  # l0_active-1
        w.ue(0)  # l1_active-1
        w.put_bits(0, 1)  # weighted_pred
        w.put_bits(0, 2)  # weighted_bipred
        w.se(self.qp - 26)
        w.se(0)  # qs
        w.se(self.chroma_qp_index)
        w.put_bits(1, 1)  # deblocking_filter_control_present
        w.put_bits(0, 1)  # constrained_intra
        w.put_bits(0, 1)  # redundant_pic_cnt

    # ---------------------------------------------------------- stream ---
    def generate(self, pattern="II"):
        """pattern: 'I' = IDR all-intra picture (more types as the decoder
        grows)."""
        out = bytearray()
        self._nal(out, 3, 7, self._sps)
        self._nal(out, 3, 8, self._pps)
        for c in pattern:
            if c == "I":
                self._idr_picture(out)
            else:
                raise NotImplementedError(c)
        return bytes(out)

    def _idr_picture(self, out):
        self.frame_num = 0
        self.poc_lsb = 0
        self._nal(out, 3, 5, lambda w: self._slice_I(w, idr=True))
        self.frame_num = (self.frame_num + 1) % (1 << self.log2_max_frame_num)
        self.poc_lsb = (self.poc_lsb + 2) % (1 << self.log2_max_poc_lsb)

    # ----------------------------------------------------------- slice ---
    def _emit_field_flags(self, w):
        if not self.field_pics:
            return
        w.put_bits(1, 1)  # field_pic_flag
        w.put_bits(getattr(self, "_bottom", 0), 1)
        self._bottom = 1 - getattr(self, "_bottom", 0)

    def _slice_I(self, w, idr):
        rng = self.rng
        w.ue(0)  # first_mb_in_slice
        w.ue(7)  # slice_type: I (all slices)
        w.ue(0)  # pps_id
        w.put_bits(self.frame_num, self.log2_max_frame_num)
        self._emit_field_flags(w)
        if idr:
            w.ue(0)  # idr_pic_id
        w.put_bits(self.poc_lsb, self.log2_max_poc_lsb)
        if idr:
            w.put_bits(0, 1)  # no_output_of_prior_pics
            w.put_bits(0, 1)  # long_term_reference
        else:
            w.put_bits(0, 1)  # adaptive_ref_pic_marking
        self.qp_cur = self.qp
        w.se(0)  # slice_qp_delta
        # deblocking control (control_present=1 in PPS)
        if self.disable_deblock:
            w.ue(1)
        else:
            # keep every edge's indexB >= 16: the reference indexes its beta
            # predicate table with qp+ofs-16 WITHOUT a lower clamp
            # (h264.cpp:10253-10257 + beta_offset_base[b] negative index =
            # out-of-bounds read). Real encoders avoid this region; so do we:
            # beta offset >= 0 and qp floor 24 (see _qp_floor).
            w.ue(0)
            w.se(rng.randint(-3, 3))
            w.se(rng.randint(0, 3))
        # state for intra pred mode prediction and nC tracking
        self._init_slice_state()
        for mb in range(self.mb_w * self.mb_h):
            self._macroblock_I(w, mb)

    def _after_ref_reorder(self, w, is_b):
        """Hook for the pred_weight_table (weighted generators)."""

    def _emit_marking(self, w):
        """dec_ref_pic_marking for non-IDR ref slices (MMCO hook)."""
        w.put_bits(0, 1)  # adaptive_ref_pic_marking_mode_flag

    def _init_slice_state(self):
        self.top_pred = [[2] * 4 for _ in range(self.mb_w)]
        self.left_pred = [0] * 4
        self.top_coef = [[0] * 8 for _ in range(self.mb_w)]
        self.left_coef = [0] * 8
        self.mb_count = 0

    # ------------------------------------------------------ macroblocks ---
    def _macroblock_I(self, w, mb_idx):
        self._emit_ipcm(w)

    def _emit_ipcm(self, w):
        rng = self.rng
        w.ue(25)  # I_PCM
        w.byte_align(0)
        for _ in range(256 + 128):
            w.put_bits(rng.randrange(256), 8)
        mbx = self.mb_count % self.mb_w
        self.left_pred[:] = [2] * 4
        self.top_pred[mbx][:] = [2] * 4
        self.left_coef[:] = [15] * 8
        self.top_coef[mbx][:] = [15] * 8
        self.mb_count += 1


# ======================================================================
# CAVLC encoding + intra MB emission
# ======================================================================

class CavlcEncoder:
    """Inverse of cavlc.residual_block: encodes a sparse coefficient list
    [(rel_scan_pos, level)] (ascending positions, levels nonzero)."""

    @staticmethod
    def nc_class(nc):
        if nc >= 8:
            return 3
        if nc >= 4:
            return 2
        if nc >= 2:
            return 1
        return 0

    @staticmethod
    def encode(w, coefs, num_coeff, nc):
        n = len(coefs)
        positions = [p for p, _ in coefs]
        levels_rev = [lv for _, lv in reversed(coefs)]  # last coeff first
        t1 = 0
        while t1 < min(3, n) and abs(levels_rev[t1]) == 1:
            t1 += 1
        tok_tbl = (
            ENC_COEFF_TOKEN[4] if num_coeff <= 4
            else ENC_COEFF_TOKEN[CavlcEncoder.nc_class(nc)]
        )
        w.put_bitstring(tok_tbl[(n, t1)])
        if n == 0:
            return 0
        for i in range(t1):
            w.put_bits(1 if levels_rev[i] < 0 else 0, 1)
        suffix_len = 1 if (n > 10 and t1 < 3) else 0
        for i in range(t1, n):
            v = levels_rev[i]
            lvl = 2 * v - 2 if v > 0 else -2 * v - 1
            if i == t1 and t1 < 3:
                lvl -= 2
            CavlcEncoder._put_level(w, lvl, suffix_len)
            if suffix_len == 0:
                suffix_len = 1
            if suffix_len < 6 and (3 << (suffix_len - 1)) ** 2 < v * v:
                suffix_len += 1
        if n < num_coeff:
            total_zeros = positions[-1] - (n - 1)
            if num_coeff > 4:
                w.put_bitstring(ENC_TOTAL_ZEROS[n][total_zeros])
            else:
                w.put_bitstring(ENC_TOTAL_ZEROS_C[n][total_zeros])
            zeros_left = total_zeros
        else:
            zeros_left = 0
        for i in range(n - 1):
            if zeros_left == 0:
                break
            run = positions[n - 1 - i] - positions[n - 2 - i] - 1
            w.put_bitstring(ENC_RUN_BEFORE[min(zeros_left, 7)][run])
            zeros_left -= run
        return min(n, 15)

    @staticmethod
    def _put_level(w, lvl, sl):
        if sl == 0:
            if lvl < 14:
                w.put_bits(0, lvl).put_bits(1, 1)
            elif lvl < 30:
                w.put_bits(0, 14).put_bits(1, 1)
                w.put_bits(lvl - 14, 4)
            else:
                assert lvl - 30 < 4096
                w.put_bits(0, 15).put_bits(1, 1)
                w.put_bits(lvl - 30, 12)
        else:
            if lvl < (15 << sl):
                prefix = lvl >> sl
                w.put_bits(0, prefix).put_bits(1, 1)
                w.put_bits(lvl & ((1 << sl) - 1), sl)
            else:
                rem = lvl - (15 << sl)
                assert rem < 4096
                w.put_bits(0, 15).put_bits(1, 1)
                w.put_bits(rem, 12)


# neighbor nC wiring identical to the decoder's
from m2dec_tpu.codecs.h264.decoder import _LUMA_NC_WIRING, _nc_resolve
from m2dec_tpu.codecs.h264 import transforms as _X


def _zpos(i):
    by = ((i >> 1) & 1) * 4 + ((i >> 3) & 1) * 8
    bx = (i & 1) * 4 + ((i >> 2) & 1) * 8
    return by, bx


class H264IntraGen(H264StreamGen):
    """Adds real intra-coded macroblocks (I_NxN / I_16x16 / IPCM mix)."""

    def __init__(self, *args, ipcm_prob=0.05, max_coefs=6, **kwargs):
        super().__init__(*args, **kwargs)
        # IPCM records deblock qpy=0 (h264.cpp:4749) whose averaged edge QP
        # re-enters the reference's unclamped-indexB UB region; keep IPCM
        # out of deblock-enabled streams
        self.ipcm_prob = 0.0 if not self.disable_deblock else ipcm_prob
        self.max_coefs = max_coefs
        self.qp_floor = 24 if not self.disable_deblock else 0
        if not self.disable_deblock:
            assert self.chroma_qp_index >= -4

    # -- residual helpers ------------------------------------------------
    def _rand_coefs(self, num_coeff, maxn=None, lvl_hi=6):
        rng = self.rng
        maxn = maxn if maxn is not None else self.max_coefs
        n = rng.randrange(0, maxn + 1)
        if n == 0:
            return []
        pos = sorted(rng.sample(range(num_coeff), min(n, num_coeff)))
        out = []
        for p in pos:
            lv = rng.choice([1, -1, 1, -1, 2, -2, 3, -3]) if rng.random() < 0.8 \
                else rng.randrange(-lvl_hi * 4, lvl_hi * 4 + 1)
            if lv == 0:
                lv = 1
            out.append((p, lv))
        return out

    def _residual_ok_4x4(self, coefs, qmat, dc=None, zigzag=None, rng_hi=500):
        """Bound the reconstruction residual to the reference's LUT-safe
        domain [-256, 511] (see mpeg2_enc.py note on CLIP255C)."""
        zz = zigzag or list(T.ZIGZAG4x4)
        arr = np.zeros(16, np.int64)
        for p, lv in coefs:
            zi = zz[p]
            arr[zi] = lv * int(qmat[zi & 15])
        if dc is not None:
            arr[0] = dc
        res = _X.idct4x4(arr)
        return -256 <= res.min() and res.max() <= rng_hi

    def _shrink(self, coefs):
        return [(p, lv // 2) for p, lv in coefs if abs(lv) >= 2]

    # -- macroblock ------------------------------------------------------
    def _macroblock_I(self, w, mb_idx):
        rng = self.rng
        mbx = mb_idx % self.mb_w
        self.mbx = mbx
        mby = mb_idx // self.mb_w
        self.avail = ((mbx != 0) | 0) | ((mby != 0) << 1) \
            | ((mby != 0 and mbx != self.mb_w - 1) << 2) \
            | ((mby != 0 and mbx != 0) << 3)
        u = rng.random()
        if u < self.ipcm_prob:
            self._emit_ipcm(w)
        elif u < 0.5 + self.ipcm_prob:
            self._emit_i16x16(w)
        else:
            self._emit_i4x4(w)

    def _pick_chroma_mode(self):
        rng = self.rng
        avail = self.avail
        modes = [0]
        if avail & 1:
            modes.append(1)
        if avail & 2:
            modes.append(2)
        if (avail & 3) == 3:
            modes.append(3)
        return rng.choice(modes)

    # -- chroma residual -------------------------------------------------
    def _emit_chroma_residual(self, w, cbp):
        rng = self.rng
        mbx = self.mbx
        cbp_c = cbp >> 4
        if not cbp_c:
            self.left_coef[4:] = [0] * 4
            self.top_coef[mbx][4:] = [0] * 4
            return
        # DC blocks (cat 3): always present when cbp_c != 0
        for i in range(2):
            while True:
                coefs = self._rand_coefs(4, maxn=4, lvl_hi=4)
                # chroma DC feeds (dc+32)>>6 adds; bound |dc| via transform
                arr = np.zeros(4, np.int64)
                for p, lv in coefs:
                    arr[p] = lv * int(self.qmatc_now[i][0])
                dcs = _X.chroma_dc_transform(arr)
                if all(-256 * 32 <= d <= 511 * 32 for d in dcs):
                    break
                coefs = self._shrink(coefs)
            CavlcEncoder.encode(w, coefs, 4, 0)
            self.chroma_dc_vals = getattr(self, "chroma_dc_vals", [None, None])
            self.chroma_dc_vals[i] = dcs
        if cbp_c & 2:
            left = list(self.left_coef[4:])
            top = list(self.top_coef[mbx][4:])
            new_left, new_top = [0] * 4, [0] * 4
            for i in range(2):
                c0l = left[i * 2] if self.avail & 1 else -1
                c2l = left[i * 2 + 1] if self.avail & 1 else -1
                c0t = top[i * 2] if self.avail & 2 else -1
                c1t = top[i * 2 + 1] if self.avail & 2 else -1
                nc = [0] * 4
                wiring = [(c0l, c0t), (None, c1t), (c2l, None), (None, None)]
                for b in range(4):
                    na, nb_ = wiring[b]
                    if b == 1:
                        na = nc[0]
                    elif b == 2:
                        nb_ = nc[0]
                    elif b == 3:
                        na, nb_ = nc[2], nc[1]
                    while True:
                        coefs = self._rand_coefs(15, maxn=5, lvl_hi=4)
                        dc = self.chroma_dc_vals[i][b]
                        zz = [T.ZIGZAG4x4[k] for k in range(1, 16)]
                        if self._residual_ok_4x4(
                            [(p, lv) for p, lv in coefs], self.qmatc_now[i],
                            dc=dc, zigzag=zz,
                        ):
                            break
                        coefs = self._shrink(coefs)
                    nc[b] = CavlcEncoder.encode(
                        w, coefs, 15,
                        0 if na < 0 and nb_ < 0 else self._nc(na, nb_),
                    )
                new_left[i * 2] = nc[1]
                new_left[i * 2 + 1] = nc[3]
                new_top[i * 2] = nc[2]
                new_top[i * 2 + 1] = nc[3]
            self.left_coef[4:] = new_left
            self.top_coef[mbx][4:] = new_top
        else:
            self.left_coef[4:] = [0] * 4
            self.top_coef[mbx][4:] = [0] * 4

    @staticmethod
    def _nc(na, nb):
        if na >= 0:
            return (na + nb + 1) >> 1 if nb >= 0 else na
        return nb if nb >= 0 else 0

    def _update_qmats(self):
        self.qmaty_now = _X.qmat4(self.qp_cur)
        self.qmatc_now = [
            _X.qmat4(_X.qpc_from_qpy(self.qp_cur, self.chroma_qp_index)),
            _X.qmat4(_X.qpc_from_qpy(self.qp_cur, self.chroma_qp_index)),
        ]

    # -- I_16x16 ---------------------------------------------------------
    def _emit_i16x16(self, w):
        rng = self.rng
        avail = self.avail
        mbx = self.mbx
        modes = [2]
        if avail & 2:
            modes.append(0)
        if avail & 1:
            modes.append(1)
        if (avail & 3) == 3:
            modes.append(3)
        pred_mode = rng.choice(modes)
        cbp_chroma = rng.choice([0, 1, 2])
        ac = rng.random() < 0.6
        mb_type = 1 + pred_mode + cbp_chroma * 4 + (12 if ac else 0)
        w.ue(mb_type)
        chroma_mode = self._pick_chroma_mode()
        w.ue(chroma_mode)
        qp_delta = rng.choice([0, 0, 0, 1, -1, 2, -2])
        if not (self.qp_floor <= self.qp_cur + qp_delta <= 45):
            qp_delta = 0
        w.se(qp_delta)
        self.qp_cur += qp_delta
        self._update_qmats()
        # luma DC (cat 0)
        na = self.left_coef[0] if avail & 1 else -1
        nb = self.top_coef[mbx][0] if avail & 2 else -1
        while True:
            dc_coefs = self._rand_coefs(16, maxn=6, lvl_hi=4)
            arr = np.zeros(16, np.int64)
            for p, lv in dc_coefs:
                arr[T.ZIGZAG4x4[p]] = lv * int(self.qmaty_now[0])
            dcs = _X.luma_dc_transform(arr)
            if -256 * 16 <= dcs.min() and dcs.max() <= 400 * 16:
                break
            dc_coefs = self._shrink(dc_coefs)
        CavlcEncoder.encode(w, dc_coefs, 16, self._nc(na, nb))
        self.luma_dcs = dcs
        nc = [0] * 16
        if ac:
            lc, tc = self.left_coef, self.top_coef[mbx]
            for i in range(16):
                na_s, nb_s = _LUMA_NC_WIRING[i]
                na = _nc_resolve(na_s, nc, lc, avail, True)
                nb = _nc_resolve(nb_s, nc, tc, avail, False)
                by, bx = _zpos(i)
                dci = (by >> 2) * 4 + (bx >> 2)
                zz = [T.ZIGZAG4x4[k] for k in range(1, 16)]
                while True:
                    coefs = self._rand_coefs(15, maxn=5, lvl_hi=4)
                    if self._residual_ok_4x4(coefs, self.qmaty_now,
                                             dc=int(self.luma_dcs[dci]),
                                             zigzag=zz):
                        break
                    coefs = self._shrink(coefs)
                nc[i] = CavlcEncoder.encode(w, coefs, 15, self._nc(na, nb))
        self.left_coef[:4] = [nc[5], nc[7], nc[13], nc[15]]
        self.top_coef[mbx][:4] = [nc[10], nc[11], nc[14], nc[15]]
        self.left_pred[:] = [2] * 4
        self.top_pred[mbx][:] = [2] * 4
        cbp = (0, 0x10, 0x20)[cbp_chroma] | (0x0F if ac else 0)
        self._emit_chroma_residual(w, cbp)
        self.mb_count += 1

    # -- I_NxN (4x4) -----------------------------------------------------
    _MODE_REQ = {0: 2, 1: 1, 2: 0, 3: 2, 4: 3, 5: 3, 6: 3, 7: 2, 8: 1}

    def _emit_i4x4(self, w):
        rng = self.rng
        avail = self.avail
        mbx = self.mbx
        w.ue(0)  # I_NxN
        # choose modes + encode predictions, mirroring the decoder's
        # quirky availability gating (decoder._pred_intra4x4_modes)
        from m2dec_tpu.codecs.h264.decoder import _intra4x4_block_avail

        blk_avail = _intra4x4_block_avail(avail)
        left = self.left_pred
        top = self.top_pred[mbx]
        pr = [0] * 16
        bits = []

        def emit_mode(pa, pb, ba):
            pred_m = min(pa, pb)
            legal = [m for m in range(9)
                     if (ba & self._MODE_REQ[m]) == self._MODE_REQ[m]]
            mode = rng.choice(legal)
            if mode == pred_m:
                bits.append(("f", 1))
            else:
                rem = mode if mode < pred_m else mode - 1
                if rem == pred_m:  # cannot encode mode > pred via rem path
                    bits.append(("f", 1))
                    mode = pred_m
                else:
                    bits.append(("f", 0))
                    bits.append(("r", rem))
            return mode

        pr[0] = emit_mode(left[0] if avail & 2 else 2,
                          top[0] if avail & 1 else 2, blk_avail[0])
        pr[1] = emit_mode(pr[0] if avail & 2 else 2, top[1], blk_avail[1])
        pr[2] = emit_mode(left[1], pr[0] if avail & 1 else 2, blk_avail[2])
        pr[3] = emit_mode(pr[2], pr[1], blk_avail[3])
        pr[4] = emit_mode(pr[1] if avail & 2 else 2, top[2], blk_avail[4])
        pr[5] = emit_mode(pr[4] if avail & 2 else 2, top[3], blk_avail[5])
        pr[6] = emit_mode(pr[3], pr[4], blk_avail[6])
        pr[7] = emit_mode(pr[6], pr[5], blk_avail[7])
        pr[8] = emit_mode(left[2], pr[2] if avail & 1 else 2, blk_avail[8])
        pr[9] = emit_mode(pr[8], pr[3], blk_avail[9])
        pr[10] = emit_mode(left[3], pr[8] if avail & 1 else 2, blk_avail[10])
        pr[11] = emit_mode(pr[10], pr[9], blk_avail[11])
        pr[12] = emit_mode(pr[9], pr[6], blk_avail[12])
        pr[13] = emit_mode(pr[12], pr[7], blk_avail[13])
        pr[14] = emit_mode(pr[11], pr[12], blk_avail[14])
        pr[15] = emit_mode(pr[14], pr[13], blk_avail[15])
        for kind, v in bits:
            if kind == "f":
                w.put_bits(v, 1)
            else:
                w.put_bits(v, 3)
        self.left_pred[:] = [pr[5], pr[7], pr[13], pr[15]]
        self.top_pred[mbx][:] = [pr[10], pr[11], pr[14], pr[15]]

        chroma_mode = self._pick_chroma_mode()
        w.ue(chroma_mode)
        # cbp: luma groups random, chroma 0..2
        cbp_luma = rng.randrange(16)
        cbp_chroma = rng.choice([0, 1, 2])
        cbp = cbp_luma | (cbp_chroma << 4)
        w.ue(ENC_ME_CBP[0][cbp])
        if cbp:
            qp_delta = rng.choice([0, 0, 1, -1])
            if not (self.qp_floor <= self.qp_cur + qp_delta <= 45):
                qp_delta = 0
            w.se(qp_delta)
            self.qp_cur += qp_delta
        self._update_qmats()
        nc = [0] * 16
        lc, tc = self.left_coef, self.top_coef[mbx]
        for i in range(16):
            if not cbp & (1 << (i >> 2)):
                continue
            na_s, nb_s = _LUMA_NC_WIRING[i]
            na = _nc_resolve(na_s, nc, lc, avail, True)
            nb = _nc_resolve(nb_s, nc, tc, avail, False)
            while True:
                coefs = self._rand_coefs(16, maxn=6, lvl_hi=4)
                if self._residual_ok_4x4(coefs, self.qmaty_now):
                    break
                coefs = self._shrink(coefs)
            nc[i] = CavlcEncoder.encode(w, coefs, 16, self._nc(na, nb))
        self.left_coef[:4] = [nc[5], nc[7], nc[13], nc[15]]
        self.top_coef[mbx][:4] = [nc[10], nc[11], nc[14], nc[15]]
        self._emit_chroma_residual(w, cbp)
        self.mb_count += 1


class H264InterGen(H264IntraGen):
    """Adds P slices: P16x16/16x8/8x16/8x8(+ref0)/skip + intra MBs in P.

    Motion vector deltas are drawn directly (the decoded MV is pmv+mvd,
    wherever that lands — unrestricted MVs are legal and both decoders
    clamp identically), so the generator needs no MV-prediction mirror.
    """

    def __init__(self, *args, skip_prob=0.2, intra_prob=0.15, mvd_range=24,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.skip_prob = skip_prob
        self.intra_prob = intra_prob
        self.mvd_range = mvd_range
        self.n_refs_avail = 0

    def generate(self, pattern="IPP"):
        out = bytearray()
        self._nal(out, 3, 7, self._sps)
        self._nal(out, 3, 8, self._pps)
        self.n_refs_avail = 0
        for c in pattern:
            if c == "I":
                self._idr_picture(out)
                self.n_refs_avail = 1
            elif c == "P":
                self._nal(out, 2, 1, lambda w: self._slice_P(w))
                self.frame_num = (self.frame_num + 1) % (1 << self.log2_max_frame_num)
                self.poc_lsb = (self.poc_lsb + 2) % (1 << self.log2_max_poc_lsb)
                self.n_refs_avail = self._next_ref_count()
            else:
                raise NotImplementedError(c)
        return bytes(out)

    def _next_ref_count(self):
        """Ref count after this picture's marking (MMCO hook)."""
        return min(self.n_refs_avail + 1, self.num_ref_frames)

    def _slice_P(self, w):
        rng = self.rng
        w.ue(0)  # first_mb
        w.ue(5)  # slice_type P (all)
        w.ue(0)  # pps
        w.put_bits(self.frame_num, self.log2_max_frame_num)
        self._emit_field_flags(w)
        w.put_bits(self.poc_lsb, self.log2_max_poc_lsb)
        w.put_bits(0, 1)  # num_ref_idx_active_override
        w.put_bits(0, 1)  # ref_pic_list_reordering
        self._after_ref_reorder(w, 0)  # weighted table hook (P)
        self._emit_marking(w)
        self.qp_cur = self.qp
        w.se(0)
        if self.disable_deblock:
            w.ue(1)
        else:
            w.ue(0)
            w.se(rng.randint(-3, 3))
            w.se(rng.randint(0, 3))
        self._init_slice_state()
        nmb = self.mb_w * self.mb_h
        mb = 0
        pending_skip = 0
        while mb < nmb:
            mbx = mb % self.mb_w
            mby = mb // self.mb_w
            if rng.random() < self.skip_prob:
                pending_skip += 1
                self._mark_skip_state(mbx)
                mb += 1
                continue
            w.ue(pending_skip)
            pending_skip = 0
            self.mbx = mbx
            self.avail = self._avail_of(mbx, mby)
            if rng.random() < self.intra_prob:
                u = rng.random()
                if u < self.ipcm_prob:
                    w.ue(25 + 5)
                    self._emit_ipcm_body(w)
                elif u < 0.5:
                    self._emit_i16x16_p(w)
                else:
                    self._emit_i4x4_p(w)
            else:
                self._emit_p_mb(w)
            mb += 1
        if pending_skip:
            w.ue(pending_skip)

    def _avail_of(self, mbx, mby):
        return ((mbx != 0) | 0) | ((mby != 0) << 1) \
            | ((mby != 0 and mbx != self.mb_w - 1) << 2) \
            | ((mby != 0 and mbx != 0) << 3)

    def _mark_skip_state(self, mbx):
        self.left_pred[:] = [2] * 4
        self.top_pred[mbx][:] = [2] * 4
        self.left_coef[:] = [0] * 8
        self.top_coef[mbx][:] = [0] * 8
        self.mb_count += 1

    # intra-in-P wrappers: mb_type offset +5
    def _emit_i16x16_p(self, w):
        # reproduce _emit_i16x16 but with mb_type+5: easiest is to wrap the
        # ue writer
        real_ue = w.ue
        first = [True]

        def patched(v):
            if first[0]:
                first[0] = False
                return real_ue(v + 5)
            return real_ue(v)

        w.ue = patched
        try:
            self._emit_i16x16(w)
        finally:
            w.ue = real_ue

    def _emit_i4x4_p(self, w):
        real_ue = w.ue
        first = [True]

        def patched(v):
            if first[0]:
                first[0] = False
                return real_ue(v + 5)
            return real_ue(v)

        w.ue = patched
        try:
            self._emit_i4x4(w)
        finally:
            w.ue = real_ue

    def _emit_ipcm_body(self, w):
        rng = self.rng
        w.byte_align(0)
        for _ in range(256 + 128):
            w.put_bits(rng.randrange(256), 8)
        mbx = self.mbx
        self.left_pred[:] = [2] * 4
        self.top_pred[mbx][:] = [2] * 4
        self.left_coef[:] = [15] * 8
        self.top_coef[mbx][:] = [15] * 8
        self.mb_count += 1

    # -- P macroblocks ---------------------------------------------------
    def _ref(self, w):
        t = max(0, self.num_ref_frames - 1)
        v = self.rng.randrange(self.n_refs_avail)
        if t == 0:
            return
        if t == 1:
            w.put_bits(v ^ 1, 1)
        else:
            w.ue(v)

    def _mvd(self, w):
        r = self.mvd_range
        w.se(self.rng.randint(-r, r))
        w.se(self.rng.randint(-r, r))

    def _emit_p_mb(self, w):
        rng = self.rng
        mbx = self.mbx
        kind = rng.choice([0, 0, 0, 1, 2, 3, 3, 4])
        w.ue(kind)
        if kind == 0:
            self._ref(w)
            self._mvd(w)
        elif kind in (1, 2):
            self._ref(w)
            self._ref(w)
            self._mvd(w)
            self._mvd(w)
        else:
            subs = [rng.choice([0, 0, 1, 2, 3]) for _ in range(4)]
            for s in subs:
                w.ue(s)
            if kind != 4:
                for _ in range(4):
                    self._ref(w)
            for s in subs:
                n = (1, 2, 2, 4)[s]
                for _ in range(n):
                    self._mvd(w)
        self._emit_inter_residual(w)

    def _emit_inter_residual(self, w):
        rng = self.rng
        mbx = self.mbx
        cbp_luma = rng.randrange(16)
        cbp_chroma = rng.choice([0, 0, 1, 2])
        cbp = cbp_luma | (cbp_chroma << 4)
        w.ue(ENC_ME_CBP[1][cbp])
        nc = [0] * 16
        if cbp:
            qp_delta = rng.choice([0, 0, 1, -1])
            if not (self.qp_floor <= self.qp_cur + qp_delta <= 45):
                qp_delta = 0
            w.se(qp_delta)
            self.qp_cur += qp_delta
        self._update_qmats()
        lc, tc = self.left_coef, self.top_coef[mbx]
        avail = self.avail
        for i in range(16):
            if not cbp & (1 << (i >> 2)):
                continue
            na_s, nb_s = _LUMA_NC_WIRING[i]
            na = _nc_resolve(na_s, nc, lc, avail, True)
            nb = _nc_resolve(nb_s, nc, tc, avail, False)
            while True:
                coefs = self._rand_coefs(16, maxn=6, lvl_hi=4)
                if self._residual_ok_4x4(coefs, self.qmaty_now):
                    break
                coefs = self._shrink(coefs)
            nc[i] = CavlcEncoder.encode(w, coefs, 16, self._nc(na, nb))
        self.left_coef[:4] = [nc[5], nc[7], nc[13], nc[15]]
        self.top_coef[mbx][:4] = [nc[10], nc[11], nc[14], nc[15]]
        self.left_pred[:] = [2] * 4
        self.top_pred[mbx][:] = [2] * 4
        self._emit_chroma_residual(w, cbp)
        self.mb_count += 1


class H264BGen(H264InterGen):
    """Adds B slices (non-reference, nal_ref_idc=0).

    Pattern grammar: leading 'I' (IDR), then 'P'/'B' in DECODE order; each
    run of B's after an anchor displays between the previous two anchors
    (classic IPB reordering, POCs assigned by a pre-pass).

    Staging knobs mirror how the decoder was brought up: ``b_direct_prob``
    enables BDirect16x16 + sub-direct, ``skip_prob`` enables B-skip,
    ``direct_spatial`` picks spatial (1) vs temporal (0) direct mode.
    """

    #: raw B mb_type -> (kind, refmap); kind 1=16x16, 2=16x8, 3=8x16
    _B_RAW = {1: (1, 1), 2: (1, 2), 3: (1, 3)}
    for _i, _m in enumerate((0x3, 0xC, 0x9, 0x6, 0xB, 0xE, 0x7, 0xD, 0xF)):
        _B_RAW[4 + _i * 2] = (2, _m)
        _B_RAW[5 + _i * 2] = (3, _m)
    del _i, _m
    #: sub_mb_type -> (shape, dir_mask); shape 0=8x8,1=8x4,2=4x8,3=4x4
    _B_SUB = (
        (0, -1), (0, 1), (0, 2), (0, 3), (1, 1), (2, 1), (1, 2), (2, 2),
        (1, 3), (2, 3), (3, 1), (3, 2), (3, 3),
    )

    def __init__(self, *args, direct_spatial=1, b_direct_prob=0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.direct_spatial = direct_spatial
        self.b_direct_prob = b_direct_prob

    def generate(self, pattern="IPB"):
        assert pattern[0] == "I" and "I" not in pattern[1:], \
            "B patterns: single leading IDR"
        # display-order pre-pass: anchor takes slot after its trailing Bs
        disp = [0] * len(pattern)
        dd = 0
        i = 0
        while i < len(pattern):
            if pattern[i] in "IP":
                run = 0
                while i + 1 + run < len(pattern) and pattern[i + 1 + run] == "B":
                    run += 1
                disp[i] = dd + run
                for k in range(run):
                    disp[i + 1 + k] = dd + k
                dd += run + 1
                i += run + 1
            else:
                raise NotImplementedError(pattern[i])
        out = bytearray()
        self._nal(out, 3, 7, self._sps)
        self._nal(out, 3, 8, self._pps)
        self.n_refs_avail = 0
        for i, c in enumerate(pattern):
            self.poc_lsb = (disp[i] * 2) % (1 << self.log2_max_poc_lsb)
            if c == "I":
                self.frame_num = 0
                self.poc_lsb = 0
                self._nal(out, 3, 5, lambda w: self._slice_I(w, idr=True))
                self.frame_num = 1
                self.n_refs_avail = 1
            elif c == "P":
                self._nal(out, 2, 1, lambda w: self._slice_P(w))
                self.frame_num = (self.frame_num + 1) % (1 << self.log2_max_frame_num)
                self.n_refs_avail = min(self.n_refs_avail + 1, self.num_ref_frames)
            else:  # B, non-reference
                self._nal(out, 0, 1, lambda w: self._slice_B(w))
        return bytes(out)

    def _slice_B(self, w):
        rng = self.rng
        w.ue(0)  # first_mb
        w.ue(6)  # slice_type B (all)
        w.ue(0)  # pps
        w.put_bits(self.frame_num, self.log2_max_frame_num)
        self._emit_field_flags(w)
        w.put_bits(self.poc_lsb, self.log2_max_poc_lsb)
        w.put_bits(self.direct_spatial, 1)
        w.put_bits(0, 1)  # num_ref_idx_active_override
        w.put_bits(0, 1)  # ref_pic_list_reordering_l0
        w.put_bits(0, 1)  # ref_pic_list_reordering_l1
        self._after_ref_reorder(w, 1)  # weighted table hook (B)
        # nal_ref_idc==0: no dec_ref_pic_marking
        self.qp_cur = self.qp
        w.se(0)
        if self.disable_deblock:
            w.ue(1)
        else:
            w.ue(0)
            w.se(rng.randint(-3, 3))
            w.se(rng.randint(0, 3))
        self._init_slice_state()
        nmb = self.mb_w * self.mb_h
        mb = 0
        pending_skip = 0
        while mb < nmb:
            mbx = mb % self.mb_w
            mby = mb // self.mb_w
            if rng.random() < self.skip_prob:
                pending_skip += 1
                self._mark_skip_state(mbx)
                mb += 1
                continue
            w.ue(pending_skip)
            pending_skip = 0
            self.mbx = mbx
            self.avail = self._avail_of(mbx, mby)
            if rng.random() < self.intra_prob:
                u = rng.random()
                if u < self.ipcm_prob:
                    w.ue(25 + 23)
                    self._emit_ipcm_body(w)
                elif u < 0.5:
                    self._emit_intra_offset(w, self._emit_i16x16, 23)
                else:
                    self._emit_intra_offset(w, self._emit_i4x4, 23)
            else:
                self._emit_b_mb(w)
            mb += 1
        if pending_skip:
            w.ue(pending_skip)

    def _emit_intra_offset(self, w, fn, ofs):
        real_ue = w.ue
        first = [True]

        def patched(v):
            if first[0]:
                first[0] = False
                return real_ue(v + ofs)
            return real_ue(v)

        w.ue = patched
        try:
            fn(w)
        finally:
            w.ue = real_ue

    # L1 active-1 is 0 in our PPS: te() reads no bits for L1 refs
    def _ref_l(self, w, lx):
        if lx == 0:
            self._ref(w)

    def _emit_b_mb(self, w):
        rng = self.rng
        if self.b_direct_prob and rng.random() < self.b_direct_prob:
            w.ue(0)  # B_Direct_16x16
            self._emit_inter_residual(w)
            return
        raw = rng.choice([1, 2, 3, rng.randrange(4, 22), 22, 22])
        w.ue(raw)
        if raw == 22:
            lo = 0 if self.b_direct_prob else 1
            subs = [rng.randrange(lo, 13) for _ in range(4)]
            for s in subs:
                w.ue(s)
            for lx in range(2):
                for s in subs:
                    dmask = self._B_SUB[s][1]
                    if dmask >= 0 and (1 << lx) & dmask:
                        self._ref_l(w, lx)
            for lx in range(2):
                for s in subs:
                    shape, dmask = self._B_SUB[s]
                    if s != 0 and (1 << lx) & dmask:
                        for _ in range((1, 2, 2, 4)[shape]):
                            self._mvd(w)
        else:
            kind, refmap = self._B_RAW[raw]
            if kind == 1:
                for lx in range(2):
                    if refmap & (1 << lx):
                        self._ref_l(w, lx)
                for lx in range(2):
                    if refmap & (1 << lx):
                        self._mvd(w)
            else:
                for lx in range(2):
                    m = refmap >> (lx * 2)
                    if m & 1:
                        self._ref_l(w, lx)
                    if m & 2:
                        self._ref_l(w, lx)
                for lx in range(2):
                    m = refmap >> (lx * 2)
                    if m & 1:
                        self._mvd(w)
                    if m & 2:
                        self._mvd(w)
        self._emit_inter_residual(w)


# ======================================================================
# CABAC encoding (spec 9.3.4 arithmetic encoder) + I-slice emission
# ======================================================================

from m2dec_tpu.codecs.h264 import cabac as _AE  # noqa: E402
from m2dec_tpu.codecs.h264 import cabac_tables as _CT  # noqa: E402


class CabacEncoder:
    """H.264 arithmetic encoder (spec 9.3.4), state-compatible with the
    decoder engine: contexts packed as state*2|valMPS, identical LPS and
    transition tables, so encoder and decoder walk the same schedule."""

    def __init__(self, w, slice_qp, idc):
        self.w = w
        self.low = 0
        self.range = 510
        self.outstanding = 0
        self.first = True
        #: bits the (reference) decoder consumes: 9 at init + renorm
        #: shifts; needed because the reference does NOT rewind at IPCM
        #: (mb_intrapcm byte-aligns its raw read position, h264.cpp:4741)
        self.dec_consumed = self.w.nbits + 9
        self.ctx = [0] * 460
        for i, (m, n) in enumerate(_CT.CTX_MN[idc]):
            pre = ((m * slice_qp) >> 4) + n
            if pre < 64:
                pre = 1 if pre <= 0 else pre
                self.ctx[i] = (63 - pre) * 2
            else:
                pre = 126 if pre > 126 else pre
                self.ctx[i] = (pre - 64) * 2 + 1

    def _put(self, b):
        if self.first:
            self.first = False
        else:
            self.w.put_bits(b, 1)
        while self.outstanding:
            self.w.put_bits(1 - b, 1)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            self.dec_consumed += 1
            if self.low >= 512:
                self.low -= 512
                self._put(1)
            elif self.low < 256:
                self._put(0)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, idx, binv):
        c = self.ctx[idx]
        mps = c & 1
        st = c >> 1
        lps = _CT.RANGE_TAB_LPS[st][(self.range >> 6) & 3]
        self.range -= lps
        if binv != mps:
            self.low += self.range
            self.range = lps
            self.ctx[idx] = _CT.STATE_TRANS[st] ^ mps
        else:
            self.ctx[idx] = ((st + (st < 62)) * 2) | mps
        self._renorm()

    def bypass(self, binv):
        self.dec_consumed += 1
        self.low <<= 1
        if binv:
            self.low += self.range
        if self.low >= 1024:
            self.low -= 1024
            self._put(1)
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, binv):
        self.range -= 2
        if binv:
            # the decoder consumes nothing on terminate==1
            # (cabac_decode_terminate, h264.cpp:11057-11063)
            save = self.dec_consumed
            self.low += self.range
            self.range = 2
            self._renorm()
            self._flush()
            self.dec_consumed = save
        else:
            self._renorm()

    def _flush(self):
        save = self.dec_consumed
        self.range = 2
        self._renorm()
        self.dec_consumed = save
        self._put((self.low >> 9) & 1)
        self.w.put_bits(((self.low >> 7) & 3) | 1, 2)

    def reinit_engine(self):
        """After IPCM: fresh arithmetic state, contexts keep adapting."""
        self.low = 0
        self.range = 510
        self.outstanding = 0
        self.first = True
        self.dec_consumed = self.w.nbits + 9


class _Nb:
    """Neighbor state mirror of the decoder's PrevMb (ctx-inc inputs)."""

    def __init__(self):
        self.type = 0
        self.cbp = 0
        self.cbf = 0
        self.chroma_pred_mode = 0
        self.mb_skip = 0
        self.direct8x8 = 0
        self.transform8x8 = 0


class H264CabacIGen(H264IntraGen):
    """CABAC I-slice generator: IPCM / I16x16 / I4x4 with residuals."""

    MB_INxN, MB_IPCM = 0, 25

    def _pps(self, w):
        w.ue(0)
        w.ue(0)
        w.put_bits(1, 1)  # entropy: CABAC
        w.put_bits(0, 1)
        w.ue(0)
        w.ue(max(0, self.num_ref_frames - 1))
        w.ue(0)
        w.put_bits(0, 1)
        w.put_bits(0, 2)
        w.se(self.qp - 26)
        w.se(0)
        w.se(self.chroma_qp_index)
        w.put_bits(1, 1)
        w.put_bits(0, 1)
        w.put_bits(0, 1)

    # -- neighbor-state plumbing (adapter for AE._CTXIDXINC_CBF) --------
    def _init_slice_state(self):
        super()._init_slice_state()
        self._left = _Nb()
        self._tops = [_Nb() for _ in range(self.mb_w)]
        self.prev_qp_delta = 0
        self.cbf = 0
        self.mb_type = 0

    @property
    def mbleft(self):
        return self._left

    def _top(self):
        return self._tops[self.mbx]

    def _cbf_ctx(self, pos4x4):
        return _AE._CTXIDXINC_CBF[pos4x4](self, self.cbf, self.avail)

    # -- slice ----------------------------------------------------------
    def _emit_field_flags(self, w):
        if not self.field_pics:
            return
        w.put_bits(1, 1)  # field_pic_flag
        w.put_bits(getattr(self, "_bottom", 0), 1)
        self._bottom = 1 - getattr(self, "_bottom", 0)

    def _slice_I(self, w, idr):
        rng = self.rng
        w.ue(0)
        w.ue(7)
        w.ue(0)
        w.put_bits(self.frame_num, self.log2_max_frame_num)
        self._emit_field_flags(w)
        if idr:
            w.ue(0)  # idr_pic_id
        w.put_bits(self.poc_lsb, self.log2_max_poc_lsb)
        if idr:
            w.put_bits(0, 2)  # no_output / long_term flags
        else:
            w.put_bits(0, 1)  # adaptive_ref_pic_marking
        self.qp_cur = self.qp
        w.se(0)
        if self.disable_deblock:
            w.ue(1)
        else:
            w.ue(0)
            w.se(rng.randint(-3, 3))
            w.se(rng.randint(0, 3))
        self._init_slice_state()
        self._update_qmats()
        w.byte_align(1)  # cabac_alignment_one_bit
        enc = CabacEncoder(w, self.qp_cur, 0)
        nmb = self.mb_w * self.mb_h
        for mb in range(nmb):
            self.mbx = mb % self.mb_w
            mby = mb // self.mb_w
            self.avail = self._avail_of(self.mbx, mby)
            self.cbf = 0
            self._cab_macroblock(enc, w)
            enc.terminate(mb == nmb - 1)
        # rbsp stop bit came from the flush; pad to byte with zeros
        w.byte_align(0)

    def _avail_of(self, mbx, mby):
        return ((mbx != 0) | 0) | ((mby != 0) << 1) \
            | ((mby != 0 and mbx != self.mb_w - 1) << 2) \
            | ((mby != 0 and mbx != 0) << 3)

    def _cab_macroblock(self, enc, w):
        rng = self.rng
        u = rng.random()
        if u < self.ipcm_prob:
            self._cab_ipcm(enc, w)
        elif u < 0.55:
            self._cab_i16x16(enc)
        else:
            self._cab_i4x4(enc)

    # -- mb_type tree (inverse of AE.mb_type_I, I-slice ctx_idx=3) ------
    def _enc_mb_type_I(self, enc, mbtype):
        avail = self.avail
        add = ((bool(avail & 2) and self._top().type != self.MB_INxN)
               + (bool(avail & 1) and self._left.type != self.MB_INxN))
        if mbtype == self.MB_INxN:
            enc.decision(3 + add, 0)
            return
        enc.decision(3 + add, 1)
        enc.terminate(mbtype == self.MB_IPCM)
        if mbtype == self.MB_IPCM:
            return
        v = mbtype - 1
        a, rem = divmod(v, 12)
        enc.decision(6, a)
        if rem < 4:
            enc.decision(7, 0)
        else:
            enc.decision(7, 1)
            rem -= 4
            enc.decision(8, rem >> 2)
            rem &= 3
        enc.decision(9, rem >> 1)
        enc.decision(10, rem & 1)

    def _cab_ipcm(self, enc, w):
        rng = self.rng
        self._enc_mb_type_I(enc, self.MB_IPCM)
        # terminate(1) flushed the arithmetic tail; the reference decoder
        # reads pcm from the byte boundary after the bits it actually
        # consumed -- truncate the over-emitted flush tail back to there.
        pcm_start = (enc.dec_consumed + 7) & ~7
        if pcm_start <= w.nbits:
            w.truncate_to_bits(pcm_start)
        else:
            # decoder lookahead ran past the flushed tail; pad with ones
            # (only raises the offset window, keeping terminate(1) true)
            w.put_bits((1 << (pcm_start - w.nbits)) - 1, pcm_start - w.nbits)
        for _ in range(256 + 128):
            w.put_bits(rng.randrange(256), 8)
        enc.reinit_engine()
        self._post_mb(self.MB_IPCM, 0x3F, 0x7FFFFFF, 0,
                      pred_reset=2, coef_fill=15)
        self.prev_qp_delta = 0

    # -- shared element encoders ----------------------------------------
    def _enc_chroma_mode(self, enc):
        mode = self._pick_chroma_mode()
        avail = self.avail
        tp, lf = self._top(), self._left
        idx = 64 + ((bool(avail & 2) and tp.type < self.MB_IPCM
                     and tp.chroma_pred_mode != 0)
                    + (bool(avail & 1) and lf.type < self.MB_IPCM
                       and lf.chroma_pred_mode != 0))
        enc.decision(idx, 1 if mode else 0)
        if mode:
            for _ in range(mode - 1):
                enc.decision(67, 1)
            if mode < 3:
                enc.decision(67, 0)
        self.chroma_pred_mode_cur = mode
        return mode

    def _enc_cbp(self, enc, cbp):
        avail = self.avail
        cbp_a = self._left.cbp if avail & 1 else 0x0F
        cbp_b = self._top().cbp if avail & 2 else 0x0F
        inc = (not (cbp_a & 2)) + (not (cbp_b & 4)) * 2
        enc.decision(73 + inc, cbp & 1)
        inc = (not (cbp & 1)) + (not (cbp_b & 8)) * 2
        enc.decision(73 + inc, (cbp >> 1) & 1)
        inc = (not (cbp_a & 8)) + (not (cbp & 1)) * 2
        enc.decision(73 + inc, (cbp >> 2) & 1)
        inc = (not (cbp & 4)) + (not (cbp & 2)) * 2
        enc.decision(73 + inc, (cbp >> 3) & 1)
        ca, cb = cbp_a >> 4, cbp_b >> 4
        inc = (ca != 0) + (cb != 0) * 2
        cc = cbp >> 4
        enc.decision(77 + inc, 1 if cc else 0)
        if cc:
            inc = (ca >> 1) + (cb & 2)
            enc.decision(77 + 4 + inc, cc - 1)

    def _enc_qp_delta(self, enc, delta):
        idx = 60 + (self.prev_qp_delta != 0)
        if delta == 0:
            enc.decision(idx, 0)
            self.prev_qp_delta = 0
            return
        enc.decision(idx, 1)
        code = 2 * delta - 1 if delta > 0 else -2 * delta
        # unary_cabac inverse: (code-1) ones then a zero
        for k in range(code - 1):
            enc.decision(62 if k == 0 else 63, 1)
        enc.decision(62 if code == 1 else 63, 0)
        self.prev_qp_delta = code

    def _enc_residual(self, enc, coefs, cat, pos4x4):
        """Inverse of AE.residual_block; returns nC-equivalent count."""
        _, num_coeff, _ = _AE.COEFF_OFS[cat]
        if cat != 5:
            inc = self._cbf_ctx(pos4x4)
            if not coefs:
                enc.decision(85 + inc + cat * 4, 0)
                return 0
            enc.decision(85 + inc + cat * 4, 1)
            self.cbf |= 1 << pos4x4
        else:
            self.cbf |= 0xF << pos4x4
        if self.field_pics:
            from m2dec_tpu.codecs.h264.cabac import _SIG_OFS_FIELD
            sig_ofs, last_ofs = _SIG_OFS_FIELD[cat]
        else:
            sig_ofs, last_ofs = _CT.SIG_OFS[cat]
        latter = _CT.SIG64 if cat == 5 else _CT.SIG16
        posset = {p for p, _ in coefs}
        lastpos = max(posset)
        for i in range(num_coeff - 1):
            if i > lastpos:
                break
            sig = i in posset
            enc.decision(sig_ofs + latter[i][1], 1 if sig else 0)
            if sig:
                enc.decision(last_ofs + latter[i][0], 1 if i == lastpos else 0)
        node = 0
        for p, lv in reversed(coefs):
            a = abs(lv)
            if a == 1:
                enc.decision(227 + _CT.ABS_LEVEL_OFS[cat]
                             + _CT.COEFF_ABS_LEVEL_CTX[0][node], 0)
                node = _CT.COEFF_ABS_LEVEL_TRANS[0][node]
            else:
                enc.decision(227 + _CT.ABS_LEVEL_OFS[cat]
                             + _CT.COEFF_ABS_LEVEL_CTX[0][node], 1)
                idx = (227 + _CT.ABS_LEVEL_OFS[cat]
                       + _CT.COEFF_ABS_LEVEL_CTX[1][node])
                node = _CT.COEFF_ABS_LEVEL_TRANS[1][node]
                for _ in range(min(a, 15) - 2):
                    enc.decision(idx, 1)
                if a < 15:
                    enc.decision(idx, 0)
                else:
                    v = a - 15
                    ln = 0
                    while (1 << (ln + 1)) - 1 <= v:
                        ln += 1
                    for _ in range(ln):
                        enc.bypass(1)
                    enc.bypass(0)
                    rem = v - ((1 << ln) - 1)
                    for k in range(ln - 1, -1, -1):
                        enc.bypass((rem >> k) & 1)
            enc.bypass(1 if lv < 0 else 0)
        return min(len(coefs), 15)

    # -- neighbor-state commit ------------------------------------------
    def _post_mb(self, mbtype, cbp, cbf, chroma_mode, pred_reset=None,
                 coef_fill=None):
        from m2dec_tpu.codecs.h264.decoder import _cbf_top, _cbf_left
        mbx = self.mbx
        lf, tp = self._left, self._tops[mbx]
        lf.type = tp.type = mbtype
        lf.cbp = tp.cbp = cbp
        lf.cbf = _cbf_left(cbf)
        tp.cbf = _cbf_top(cbf)
        lf.chroma_pred_mode = tp.chroma_pred_mode = chroma_mode
        lf.mb_skip = tp.mb_skip = 0
        if pred_reset is not None:
            self.left_pred[:] = [pred_reset] * 4
            self.top_pred[mbx][:] = [pred_reset] * 4
        if coef_fill is not None:
            self.left_coef[:] = [coef_fill] * 8
            self.top_coef[mbx][:] = [coef_fill] * 8
        self.mb_count += 1

    # -- I16x16 ----------------------------------------------------------
    def _cab_i16x16(self, enc):
        rng = self.rng
        avail = self.avail
        mbx = self.mbx
        modes = [2]
        if avail & 2:
            modes.append(0)
        if avail & 1:
            modes.append(1)
        if (avail & 3) == 3:
            modes.append(3)
        pred_mode = rng.choice(modes)
        cbp_chroma = rng.choice([0, 1, 2])
        ac = rng.random() < 0.6
        mbtype = 1 + pred_mode + cbp_chroma * 4 + (12 if ac else 0)
        self.mb_type = mbtype
        self._enc_mb_type_I(enc, mbtype)
        chroma_mode = self._enc_chroma_mode(enc)
        qp_delta = rng.choice([0, 0, 0, 1, -1, 2, -2])
        if not (self.qp_floor <= self.qp_cur + qp_delta <= 45):
            qp_delta = 0
        self._enc_qp_delta(enc, qp_delta)
        self.qp_cur += qp_delta
        self._update_qmats()
        # luma DC (cat 0, pos 26)
        while True:
            dc_coefs = self._rand_coefs(16, maxn=6, lvl_hi=4)
            arr = np.zeros(16, np.int64)
            for p, lv in dc_coefs:
                arr[T.ZIGZAG4x4[p]] = lv * int(self.qmaty_now[0])
            dcs = _X.luma_dc_transform(arr)
            if -256 * 16 <= dcs.min() and dcs.max() <= 400 * 16:
                break
            dc_coefs = self._shrink(dc_coefs)
        self._enc_residual(enc, dc_coefs, 0, 26)
        nc = [0] * 16
        if ac:
            for i in range(16):
                by, bx = _zpos(i)
                dci = (by >> 2) * 4 + (bx >> 2)
                zz = [T.ZIGZAG4x4[k] for k in range(1, 16)]
                while True:
                    coefs = self._rand_coefs(15, maxn=5, lvl_hi=4)
                    if self._residual_ok_4x4(coefs, self.qmaty_now,
                                             dc=int(dcs[dci]), zigzag=zz):
                        break
                    coefs = self._shrink(coefs)
                nc[i] = self._enc_residual(enc, coefs, 1, i)
        cbp = (0, 0x10, 0x20)[cbp_chroma] | (0x0F if ac else 0)
        self._cab_chroma_residual(enc, cbp)
        cbf = self.cbf
        self._post_mb(mbtype, cbp, cbf, chroma_mode, pred_reset=2)
        self.left_coef[:4] = [nc[5], nc[7], nc[13], nc[15]]
        self.top_coef[mbx][:4] = [nc[10], nc[11], nc[14], nc[15]]

    # -- I_NxN -----------------------------------------------------------
    def _cab_i4x4(self, enc):
        rng = self.rng
        avail = self.avail
        mbx = self.mbx
        self.mb_type = self.MB_INxN
        self._enc_mb_type_I(enc, self.MB_INxN)
        from m2dec_tpu.codecs.h264.decoder import _intra4x4_block_avail
        blk_avail = _intra4x4_block_avail(avail)
        left = self.left_pred
        top = self.top_pred[mbx]
        pr = [0] * 16

        def emit_mode(pa, pb, ba):
            pred_m = min(pa, pb)
            legal = [m for m in range(9)
                     if (ba & self._MODE_REQ[m]) == self._MODE_REQ[m]]
            mode = rng.choice(legal)
            if mode == pred_m:
                enc.decision(68, 1)
            else:
                rem = mode if mode < pred_m else mode - 1
                if rem == pred_m:
                    enc.decision(68, 1)
                    mode = pred_m
                else:
                    enc.decision(68, 0)
                    enc.decision(69, rem & 1)
                    enc.decision(69, (rem >> 1) & 1)
                    enc.decision(69, (rem >> 2) & 1)
            return mode

        pr[0] = emit_mode(left[0] if avail & 2 else 2,
                          top[0] if avail & 1 else 2, blk_avail[0])
        pr[1] = emit_mode(pr[0] if avail & 2 else 2, top[1], blk_avail[1])
        pr[2] = emit_mode(left[1], pr[0] if avail & 1 else 2, blk_avail[2])
        pr[3] = emit_mode(pr[2], pr[1], blk_avail[3])
        pr[4] = emit_mode(pr[1] if avail & 2 else 2, top[2], blk_avail[4])
        pr[5] = emit_mode(pr[4] if avail & 2 else 2, top[3], blk_avail[5])
        pr[6] = emit_mode(pr[3], pr[4], blk_avail[6])
        pr[7] = emit_mode(pr[6], pr[5], blk_avail[7])
        pr[8] = emit_mode(left[2], pr[2] if avail & 1 else 2, blk_avail[8])
        pr[9] = emit_mode(pr[8], pr[3], blk_avail[9])
        pr[10] = emit_mode(left[3], pr[8] if avail & 1 else 2, blk_avail[10])
        pr[11] = emit_mode(pr[10], pr[9], blk_avail[11])
        pr[12] = emit_mode(pr[9], pr[6], blk_avail[12])
        pr[13] = emit_mode(pr[12], pr[7], blk_avail[13])
        pr[14] = emit_mode(pr[11], pr[12], blk_avail[14])
        pr[15] = emit_mode(pr[14], pr[13], blk_avail[15])
        chroma_mode = self._enc_chroma_mode(enc)
        cbp_luma = rng.randrange(16)
        cbp_chroma = rng.choice([0, 1, 2])
        cbp = cbp_luma | (cbp_chroma << 4)
        self._enc_cbp(enc, cbp)
        if cbp:
            qp_delta = rng.choice([0, 0, 1, -1])
            if not (self.qp_floor <= self.qp_cur + qp_delta <= 45):
                qp_delta = 0
            self._enc_qp_delta(enc, qp_delta)
            self.qp_cur += qp_delta
        else:
            self.prev_qp_delta = 0
        self._update_qmats()
        nc = [0] * 16
        for i in range(16):
            if not cbp & (1 << (i >> 2)):
                continue
            while True:
                coefs = self._rand_coefs(16, maxn=6, lvl_hi=4)
                if self._residual_ok_4x4(coefs, self.qmaty_now):
                    break
                coefs = self._shrink(coefs)
            nc[i] = self._enc_residual(enc, coefs, 2, i)
        self._cab_chroma_residual(enc, cbp)
        cbf = self.cbf
        self._post_mb(self.MB_INxN, cbp, cbf, chroma_mode)
        self.left_pred[:] = [pr[5], pr[7], pr[13], pr[15]]
        self.top_pred[mbx][:] = [pr[10], pr[11], pr[14], pr[15]]
        self.left_coef[:4] = [nc[5], nc[7], nc[13], nc[15]]
        self.top_coef[mbx][:4] = [nc[10], nc[11], nc[14], nc[15]]

    # -- chroma ----------------------------------------------------------
    def _cab_chroma_residual(self, enc, cbp):
        rng = self.rng
        mbx = self.mbx
        cbp_c = cbp >> 4
        if not cbp_c:
            self.left_coef[4:] = [0] * 4
            self.top_coef[mbx][4:] = [0] * 4
            return
        dcs_all = []
        for i in range(2):
            while True:
                coefs = self._rand_coefs(4, maxn=4, lvl_hi=4)
                arr = np.zeros(4, np.int64)
                for p, lv in coefs:
                    arr[p] = lv * int(self.qmatc_now[i][0])
                dcs = _X.chroma_dc_transform(arr)
                if all(-256 * 32 <= d <= 511 * 32 for d in dcs):
                    break
                coefs = self._shrink(coefs)
            self._enc_residual(enc, coefs, 3, 16 + i)
            dcs_all.append(dcs)
        if cbp_c & 2:
            nc4 = [[0] * 4, [0] * 4]
            for i in range(2):
                zz = [T.ZIGZAG4x4[k] for k in range(1, 16)]
                for b in range(4):
                    while True:
                        coefs = self._rand_coefs(15, maxn=4, lvl_hi=4)
                        if self._residual_ok_4x4(
                                coefs, self.qmatc_now[i],
                                dc=int(dcs_all[i][b]), zigzag=zz):
                            break
                        coefs = self._shrink(coefs)
                    nc4[i][b] = self._enc_residual(enc, coefs, 4,
                                                   18 + i * 4 + b)
            self.left_coef[4:] = [nc4[0][1], nc4[0][3], nc4[1][1], nc4[1][3]]
            self.top_coef[mbx][4:] = [nc4[0][2], nc4[0][3],
                                      nc4[1][2], nc4[1][3]]
        else:
            self.left_coef[4:] = [0] * 4
            self.top_coef[mbx][4:] = [0] * 4


# ======================================================================
# High profile: transform_8x8_mode (I_8x8 + inter 8x8 transform)
# ======================================================================

from m2dec_tpu.codecs.h264 import transforms as _XT  # noqa: E402


class H264HighGen(H264InterGen):
    """High-profile streams: PPS transform_8x8_mode=1; emits I_8x8 MBs and
    8x8-transform inter residuals alongside the existing MB kinds.

    CAVLC cat-5 blocks keep all coefficients in scan positions < 16: the
    reference codes 8x8 blocks with its 4x4 CAVLC machinery
    (residual_block_cavlc at cat 5, h264.cpp:4096-4125), whose total-zeros
    tables only span the 4x4 domain. Every coded 8x8 block carries at
    least one coefficient (the reference feeds stale stack memory to the
    inverse transform on empty cat-5 blocks).
    """

    #: per-mode avail requirement for 8x8 (pred8x8 entry guards)
    _MODE_REQ8 = {0: 2, 1: 1, 2: 0, 3: 2, 4: 3, 5: 11, 6: 11, 7: 2, 8: 1}

    def __init__(self, *args, i8x8_prob=0.5, t8_prob=0.5, **kwargs):
        super().__init__(*args, **kwargs)
        self.i8x8_prob = i8x8_prob
        self.t8_prob = t8_prob

    def _pps(self, w):
        w.ue(0)
        w.ue(0)
        w.put_bits(0, 1)  # CAVLC
        w.put_bits(0, 1)
        w.ue(0)
        w.ue(max(0, self.num_ref_frames - 1))
        w.ue(0)
        w.put_bits(0, 1)
        w.put_bits(0, 2)
        w.se(self.qp - 26)
        w.se(0)
        w.se(self.chroma_qp_index)
        w.put_bits(1, 1)
        w.put_bits(0, 1)
        w.put_bits(0, 1)
        # trailing: transform_8x8_mode, no scaling lists, 2nd chroma ofs
        w.put_bits(1, 1)
        w.put_bits(0, 1)
        w.se(self.chroma_qp_index)

    def _update_qmats(self):
        super()._update_qmats()
        self.qmaty8_now = _XT.qmat8(self.qp_cur)

    # -- 8x8 residual helpers -------------------------------------------
    def _rand_coefs8(self):
        rng = self.rng
        n = rng.randrange(1, 6)
        pos = sorted(rng.sample(range(16), n))  # scan pos < 16 (see doc)
        return [(p, rng.choice([1, -1, 1, -1, 2, -2, 3, -3])) for p in pos]

    def _residual_ok_8x8(self, coefs):
        arr = np.zeros(64, np.int64)
        for p, lv in coefs:
            zi = T.ZIGZAG8x8[p]
            arr[zi] = lv * int(self.qmaty8_now[zi])
        res = _XT.idct8x8(arr)
        return -256 <= res.min() and res.max() <= 500

    def _emit_resid8(self, w, na, nb):
        while True:
            coefs = self._rand_coefs8()
            if self._residual_ok_8x8(coefs):
                break
        return CavlcEncoder.encode(w, coefs, 64, self._nc(na, nb))

    def _emit_luma8x8(self, w, cbp):
        """Mirror of the decoder's 8x8 nC chain (c0/c1/c2/c3)."""
        avail = self.avail
        lc, tc = self.left_coef, self.top_coef[self.mbx]
        cs = [0, 0, 0, 0]
        for b in range(4):
            if not cbp & (1 << b):
                continue
            if b == 0:
                na = lc[0] if avail & 1 else -1
                nb = tc[0] if avail & 2 else -1
            elif b == 1:
                na = cs[0]
                nb = tc[2] if avail & 2 else -1
            elif b == 2:
                na = lc[2] if avail & 1 else -1
                nb = cs[1]
            else:
                na, nb = cs[2], cs[1]
            cs[b] = self._emit_resid8(w, na, nb)
        self.left_coef[:4] = [cs[1], cs[1], cs[3], cs[3]]
        self.top_coef[self.mbx][:4] = [cs[2], cs[2], cs[3], cs[3]]

    # -- I_8x8 ----------------------------------------------------------
    def _emit_i8x8(self, w, mb_type_ofs=0):
        rng = self.rng
        avail = self.avail
        mbx = self.mbx
        w.ue(0 + mb_type_ofs)  # I_NxN
        w.put_bits(1, 1)  # transform_size_8x8_flag
        left = self.left_pred
        top = self.top_pred[mbx]
        a = avail
        blkav = (
            (a & ~4) | ((a & 2) * 2),
            (a & ~8) | ((a & 2) * 4) | 1,
            6 | ((a & 1) * 9),
            11,
        )

        def emit_mode(pa, pb, ba):
            pred_m = min(pa, pb)
            legal = [m for m in range(9)
                     if (ba & self._MODE_REQ8[m]) == self._MODE_REQ8[m]]
            mode = rng.choice(legal)
            if mode == pred_m:
                w.put_bits(1, 1)
            else:
                rem = mode if mode < pred_m else mode - 1
                if rem == pred_m:
                    w.put_bits(1, 1)
                    mode = pred_m
                else:
                    w.put_bits(0, 1)
                    w.put_bits(rem, 3)
            return mode

        p0 = emit_mode(left[0] if a & 2 else 2, top[0] if a & 1 else 2,
                       blkav[0])
        p1 = emit_mode(p0 if a & 2 else 2, top[2], blkav[1])
        p2 = emit_mode(left[2], p0 if a & 1 else 2, blkav[2])
        p3 = emit_mode(p2, p1, blkav[3])
        self.left_pred[:] = [p1, p1, p3, p3]
        self.top_pred[mbx][:] = [p2, p2, p3, p3]
        chroma_mode = self._pick_chroma_mode()
        w.ue(chroma_mode)
        cbp_luma = rng.randrange(16)
        cbp_chroma = rng.choice([0, 1, 2])
        cbp = cbp_luma | (cbp_chroma << 4)
        w.ue(ENC_ME_CBP[0][cbp])
        if cbp:
            qp_delta = rng.choice([0, 0, 1, -1])
            if not (self.qp_floor <= self.qp_cur + qp_delta <= 45):
                qp_delta = 0
            w.se(qp_delta)
            self.qp_cur += qp_delta
        self._update_qmats()
        self._emit_luma8x8(w, cbp)
        self._emit_chroma_residual(w, cbp)
        self.mb_count += 1

    # i4x4 in a High PPS needs the transform flag (0) after mb_type
    def _emit_i4x4(self, w):
        real_ue = w.ue
        first = [True]

        def patched(v):
            if first[0]:
                first[0] = False
                real_ue(v)
                w.put_bits(0, 1)  # transform_size_8x8_flag
                return w
            return real_ue(v)

        w.ue = patched
        try:
            super()._emit_i4x4(w)
        finally:
            w.ue = real_ue

    # inter residual with the NxN transform flag
    def _emit_inter_residual(self, w, allow_t8=True):
        rng = self.rng
        mbx = self.mbx
        cbp_luma = rng.randrange(16)
        cbp_chroma = rng.choice([0, 0, 1, 2])
        cbp = cbp_luma | (cbp_chroma << 4)
        w.ue(ENC_ME_CBP[1][cbp])
        # NOTE: no transform flag for CAVLC inter MBs -- the reference's
        # CAVLC High table always uses the 4x4 inter residual
        # (h264.cpp:9558-9586); 8x8 inter transforms are CABAC-only
        t8 = 0
        if cbp:
            qp_delta = rng.choice([0, 0, 1, -1])
            if not (self.qp_floor <= self.qp_cur + qp_delta <= 45):
                qp_delta = 0
            w.se(qp_delta)
            self.qp_cur += qp_delta
        self._update_qmats()
        if t8:
            self._emit_luma8x8(w, cbp_luma)
        else:
            lc, tc = self.left_coef, self.top_coef[mbx]
            avail = self.avail
            nc = [0] * 16
            for i in range(16):
                if not cbp & (1 << (i >> 2)):
                    continue
                na_s, nb_s = _LUMA_NC_WIRING[i]
                na = _nc_resolve(na_s, nc, lc, avail, True)
                nb = _nc_resolve(nb_s, nc, tc, avail, False)
                while True:
                    coefs = self._rand_coefs(16, maxn=6, lvl_hi=4)
                    if self._residual_ok_4x4(coefs, self.qmaty_now):
                        break
                    coefs = self._shrink(coefs)
                nc[i] = CavlcEncoder.encode(w, coefs, 16, self._nc(na, nb))
            self.left_coef[:4] = [nc[5], nc[7], nc[13], nc[15]]
            self.top_coef[mbx][:4] = [nc[10], nc[11], nc[14], nc[15]]
        self.left_pred[:] = [2] * 4
        self.top_pred[mbx][:] = [2] * 4
        self._emit_chroma_residual(w, cbp)
        self.mb_count += 1

    def _emit_p_mb(self, w):
        rng = self.rng
        kind = rng.choice([0, 0, 0, 1, 2, 3, 3])  # no ref0 (simplifies t8)
        w.ue(kind)
        if kind == 0:
            self._ref(w)
            self._mvd(w)
        elif kind in (1, 2):
            self._ref(w)
            self._ref(w)
            self._mvd(w)
            self._mvd(w)
        else:
            subs = [rng.choice([0, 0, 1, 2, 3]) for _ in range(4)]
            for s in subs:
                w.ue(s)
            for _ in range(4):
                self._ref(w)
            for s in subs:
                for _ in range((1, 2, 2, 4)[s]):
                    self._mvd(w)
            self._subs_all8 = all(s == 0 for s in subs)
            self._emit_inter_residual(w, allow_t8=self._subs_all8)
            return
        self._emit_inter_residual(w, allow_t8=True)

    def _macroblock_I(self, w, mb_idx):
        rng = self.rng
        mbx = mb_idx % self.mb_w
        self.mbx = mbx
        mby = mb_idx // self.mb_w
        self.avail = self._avail_of(mbx, mby)
        u = rng.random()
        if u < self.i8x8_prob:
            self._emit_i8x8(w)
        elif u < 0.75:
            self._emit_i16x16(w)
        else:
            self._emit_i4x4(w)


class H264HighBGen(H264HighGen, H264BGen):
    """High-profile streams with B pictures: H264HighGen's I/P slices
    (intra 8x8 in I) and H264BGen's pattern grammar and B slices. B
    inter residuals stay 4x4 (the CAVLC rule in _emit_inter_residual)
    and intra MBs in B emit transform_size_8x8_flag=0."""


class H264WeightedGen(H264BGen):
    """Weighted prediction: explicit (type 1) for P and B, or implicit
    (type 2) for B. Weights stay in [0, 2<<shift] and offsets small so
    the reference's CLIP255C LUT domain [-256, 767] holds."""

    def __init__(self, *args, bipred_idc=1, **kwargs):
        super().__init__(*args, **kwargs)
        self.bipred_idc = bipred_idc

    def _pps(self, w):
        w.ue(0)
        w.ue(0)
        w.put_bits(0, 1)
        w.put_bits(0, 1)
        w.ue(0)
        w.ue(max(0, self.num_ref_frames - 1))
        w.ue(0)
        w.put_bits(1, 1)  # weighted_pred_flag
        w.put_bits(self.bipred_idc, 2)
        w.se(self.qp - 26)
        w.se(0)
        w.se(self.chroma_qp_index)
        w.put_bits(1, 1)
        w.put_bits(0, 1)
        w.put_bits(0, 1)

    def _after_ref_reorder(self, w, is_b):
        if is_b and self.bipred_idc != 1:
            return  # implicit (type 2): no table in the stream
        rng = self.rng
        sy = rng.choice([0, 1, 2])
        sc = rng.choice([0, 1, 2])
        w.ue(sy)
        w.ue(sc)
        nlists = 2 if is_b else 1
        for lx in range(nlists):
            n = max(0, self.num_ref_frames - 1) + 1 if lx == 0 else 1
            for _ in range(n):
                if rng.random() < 0.7:
                    w.put_bits(1, 1)
                    w.se(rng.randint(0, 2 << sy))
                    w.se(rng.randint(-20, 20))
                else:
                    w.put_bits(0, 1)
                if rng.random() < 0.7:
                    w.put_bits(1, 1)
                    for _ in range(2):
                        w.se(rng.randint(0, 2 << sc))
                        w.se(rng.randint(-20, 20))
                else:
                    w.put_bits(0, 1)


class H264MmcoGen(H264InterGen):
    """P streams with memory-management control operations.

    ``mmco_plan`` maps P-picture ordinal (0-based, counting P pictures)
    to a list of (op, arg1, arg2) tuples emitted as adaptive marking.
    """

    def __init__(self, *args, mmco_plan=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.mmco_plan = mmco_plan or {}
        self._p_ordinal = 0

    def generate(self, pattern="IPP"):
        self._p_ordinal = 0
        self._mmco_discards = 0
        self._mmco_reset = False
        return super().generate(pattern)

    def _next_ref_count(self):
        if self._mmco_reset:
            n = 1
        else:
            n = min(self.n_refs_avail - self._mmco_discards + 1,
                    self.num_ref_frames)
        self._mmco_discards = 0
        self._mmco_reset = False
        return max(1, n)

    def _emit_marking(self, w):
        ops = self.mmco_plan.get(self._p_ordinal)
        self._p_ordinal += 1
        if not ops:
            w.put_bits(0, 1)
            return
        w.put_bits(1, 1)  # adaptive
        for op, a1, a2 in ops:
            w.ue(op)
            if op != 5:
                w.ue(a1)
                if op == 3:
                    w.ue(a2)
            # marking applies at post-process: record the effect for the
            # NEXT picture's ref count (reading an unused list entry is
            # reference-indeterminate -- std::sort order of equal
            # elements decides which stale frame it hits)
            if op in (1, 2):
                self._mmco_discards += 1
            elif op == 5:
                self._mmco_reset = True
        w.ue(0)  # end of ops


class H264MultiSliceGen(H264IntraGen):
    """Multi-slice IDR pictures: each picture split into row-band slices.

    Mirrors the decoder's per-slice resets (set_mb_pos, h264.cpp:556-579):
    firstline makes the top row of every slice intra-predict without top
    neighbors, left is unavailable at the slice's first MB, and the intra
    pred-mode caches reset; top_coef nC state persists across slices but
    is gated off by availability.
    """

    def __init__(self, *args, rows_per_slice=1, **kwargs):
        super().__init__(*args, **kwargs)
        self.rows_per_slice = rows_per_slice

    def _idr_picture(self, out):
        self.frame_num = 0
        self.poc_lsb = 0
        self._pic_top_coef = [[0] * 8 for _ in range(self.mb_w)]
        for r0 in range(0, self.mb_h, self.rows_per_slice):
            rows = min(self.rows_per_slice, self.mb_h - r0)
            self._nal(out, 3, 5,
                      lambda w, a=r0, b=rows: self._slice_part(w, a, b))
        self.frame_num = (self.frame_num + 1) % (1 << self.log2_max_frame_num)
        self.poc_lsb = (self.poc_lsb + 2) % (1 << self.log2_max_poc_lsb)

    def _slice_part(self, w, r0, rows):
        rng = self.rng
        w.ue(r0 * self.mb_w)  # first_mb_in_slice
        w.ue(7)
        w.ue(0)
        w.put_bits(self.frame_num, self.log2_max_frame_num)
        w.ue(0)  # idr_pic_id (same for every slice of the picture)
        w.put_bits(self.poc_lsb, self.log2_max_poc_lsb)
        w.put_bits(0, 2)  # no_output / long_term
        self.qp_cur = self.qp
        w.se(0)
        if self.disable_deblock:
            w.ue(1)
        else:
            w.ue(0)
            w.se(rng.randint(-3, 3))
            w.se(rng.randint(0, 3))
        # per-slice neighbor state (set_mb_pos resets)
        self._init_slice_state()
        self.top_coef = self._pic_top_coef  # persists across slices
        n = rows * self.mb_w
        for k in range(n):
            mb = r0 * self.mb_w + k
            mbx = mb % self.mb_w
            self.mbx = mbx
            # slice-aware availability (firstline countdown, _avail)
            fl = self.mb_w - k
            self.avail = (
                ((mbx != 0 and fl < 0) << 3)
                | ((mbx != self.mb_w - 1 and fl <= 1) << 2)
                | ((fl <= 0) << 1)
                | int(mbx != 0 and k > 0)
            )
            u = rng.random()
            if u < self.ipcm_prob:
                self._emit_ipcm(w)
            elif u < 0.5:
                self._emit_i16x16(w)
            else:
                self._emit_i4x4(w)
