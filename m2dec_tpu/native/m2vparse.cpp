/* Native MPEG-1/2 Phase-A: slice entropy decode -> dense picture plan.
 *
 * Device-first design: this is NOT a decoder — it is the host-side bit-serial
 * front end of the two-phase engine. It walks a picture's slices once and
 * emits plan tensors (flags / motion vectors / dequantized coefficients)
 * that Phase B consumes as batched XLA ops. Semantics mirror the verified
 * Python Phase A (m2dec_tpu/codecs/mpeg2/entropy.py), which in turn is
 * bit-exact with the reference (m2d_decode_macroblocks, mpeg2.cpp:1502+).
 *
 * Quirks carried over on purpose (differentially verified):
 *  - unsaturated intra-DC predictor, saturation only at use
 *  - MPEG-2 mismatch control XOR on coef[63]; MPEG-1 oddification
 *  - inter '1s' DC shortcut writes an UNSATURATED int16
 *  - B-skip propagates PMV pair 0 without predictor reset
 */

#include <cstdint>
#include <cstring>

#include "mpeg2_tables.inc"

namespace {

struct BitReader {
    const uint8_t *p;
    const uint8_t *end;
    uint64_t cache;   // MSB-aligned
    int ncache;       // valid bits in cache
    int64_t consumed; // bits consumed beyond buffer end stay counted

    void init(const uint8_t *data, int64_t len) {
        p = data;
        end = data + len;
        cache = 0;
        ncache = 0;
        consumed = 0;
        fill();
    }
    void fill() {
        while (ncache <= 56) {
            uint64_t b = (p < end) ? *p++ : 0;
            cache |= b << (56 - ncache);
            ncache += 8;
        }
    }
    uint32_t show(int n) { return (uint32_t)(cache >> (64 - n)); }
    void skip(int n) {
        cache <<= n;
        ncache -= n;
        consumed += n;
        fill();
    }
    uint32_t get(int n) {
        uint32_t v = show(n);
        skip(n);
        return v;
    }
    int64_t remaining() const { return (end - p) * 8 + ncache - 64 + (64 - 0); }
    // bits_remaining equivalent: actual unread payload bits
    int64_t bits_left(int64_t total_bits) const { return total_bits - consumed; }
};

struct State {
    // plan outputs
    uint8_t *intra, *fwd, *bwd, *dct_type, *covered;
    int32_t *mvf, *mvb;
    int16_t *coef;
    int16_t *dc0; // pre-oddification DC per block (FAST_DECODE semantics) // [N][6][64]
    // field motion in frame pictures (motion_type=1): second field MV,
    // field-select bits, per-MB flag (entropy.py PicturePlan)
    int32_t *mvf2, *mvb2;
    uint8_t *fsel, *fieldmc;
    // config
    int mb_w, mb_h, is_mpeg2, coding_type;
    int r_size[2][2];
    int intra_dc_scale, intra_dc_max, intra_vlc, frame_mode;
    int concealment;
    const int32_t *qmat_intra, *qmat_nonintra;
    const uint8_t *scan;
    const int16_t *qmap;
    // running state
    int q_scale;
    int64_t dc_pred[3];
    int64_t pmv[2][2][2];
    int mb_type;
    int64_t mb_i;
    int mb_y;
    int dct;
    // motion_type triple (entropy.py): mv_count, field-format, dual-prime
    int mt_count, mt_field, mt_dmv;
};

/* bit layout from the behaviorally-dumped mb_type tables
 * (m2dec_tpu/codecs/mpeg2/entropy.py:37) */
enum { MB_FORWARD = 1, MB_BACKWARD = 2, MB_INTRA = 4, MB_PATTERN = 8,
       MB_QUANT = 16, MB_MC = 3 };
enum { I_VOP = 1, P_VOP = 2, B_VOP = 3 };

#define READ_VLC(r, NAME, out)                                    \
    do {                                                          \
        uint32_t probe_ = (r).show(NAME##_BITS);                  \
        int len_ = NAME##_LEN[probe_];                            \
        if (len_ == 0) return -2; /* invalid VLC */               \
        (r).skip(len_);                                           \
        (out) = NAME##_VAL[probe_];                               \
    } while (0)

static inline void reset_intra(State &s) {
    int64_t v = (int64_t)(s.intra_dc_max + 1) >> 1;
    s.dc_pred[0] = s.dc_pred[1] = s.dc_pred[2] = v;
}
static inline void reset_inter(State &s) { memset(s.pmv, 0, sizeof(s.pmv)); }

static int mb_address_increment(BitReader &r, int *out) {
    int val = 0;
    for (;;) {
        int t;
        READ_VLC(r, MB_INC, t);
        if (t != VLC_ESC) {
            *out = val + t;
            return 0;
        }
        val += 33;
    }
}

static void skip_mbs(State &s, int mb_inc, int64_t n_mbs) {
    if (s.mb_i + mb_inc - 1 >= n_mbs) {
        mb_inc = (int)(n_mbs - s.mb_i);  // clamp; caller errors out after
        if (mb_inc < 1) return;
    }
    if (s.coding_type == B_VOP) {
        int d = s.mb_type & MB_MC;
        int bidir = (d == MB_MC);
        int dirsel = bidir ? 0 : (d >> 1);
        for (int k = 0; k < mb_inc - 1; ++k) {
            int64_t i = ++s.mb_i;
            s.covered[i] = 1;
            if (bidir) {
                s.fwd[i] = s.bwd[i] = 1;
                s.mvf[i * 2] = (int32_t)s.pmv[0][0][0];
                s.mvf[i * 2 + 1] = (int32_t)s.pmv[0][0][1];
                s.mvb[i * 2] = (int32_t)s.pmv[1][0][0];
                s.mvb[i * 2 + 1] = (int32_t)s.pmv[1][0][1];
            } else if (dirsel == 0) {
                s.fwd[i] = 1;
                s.mvf[i * 2] = (int32_t)s.pmv[0][0][0];
                s.mvf[i * 2 + 1] = (int32_t)s.pmv[0][0][1];
            } else {
                s.bwd[i] = 1;
                s.mvb[i * 2] = (int32_t)s.pmv[1][0][0];
                s.mvb[i * 2 + 1] = (int32_t)s.pmv[1][0][1];
            }
        }
    } else {
        for (int k = 0; k < mb_inc - 1; ++k) {
            int64_t i = ++s.mb_i;
            s.covered[i] = 1;
            s.fwd[i] = 1;
        }
        reset_intra(s);
        reset_inter(s);
    }
}

static int one_mv(State &s, BitReader &r, int sdir, int pair, int xy,
                  int is_field, int64_t *out) {
    int r_size = s.r_size[sdir][xy];
    int64_t pred = s.pmv[sdir][pair][xy];
    int code;
    READ_VLC(r, MOTION_CODE, code);
    int64_t mv;
    if (code != 0) {
        int64_t residual = (r_size > 0) ? 1 + r.get(r_size) : 1;
        if (code >= 0)
            mv = ((int64_t)(code - 1) << r_size) + residual;
        else
            mv = ((int64_t)(code + 1) << r_size) - residual;
        mv += pred >> is_field;
        int64_t limit = (int64_t)16 << r_size;
        if (mv < -limit)
            mv += 2 * limit;
        else if (mv >= limit)
            mv -= 2 * limit;
    } else {
        mv = pred >> is_field;
    }
    s.pmv[sdir][pair][xy] = mv << is_field;
    *out = mv;
    return 0;
}

/* dmvector[] parse, values discarded (m2d_one_mv_with_dmv,
 * mpeg2.cpp:1212-1220) */
static void dmvector(BitReader &r) {
    if (r.get(1))
        r.get(1);
}

/* m2d_motion_vectors (mpeg2.cpp:1245-1275): frame MVs, or two field MVs
 * with per-field reference select, or dual prime (dmvectors discarded).
 * mv2/sel are written only in the two-MV (field) format. */
static int motion_vectors(State &s, BitReader &r, int sdir,
                          int64_t *mx, int64_t *my,
                          int64_t *mx2, int64_t *my2, int *sel) {
    int rc;
    if (s.mt_count == 1) {
        if (s.mt_field && !s.mt_dmv)
            r.get(1); // motion_vertical_field_select (discarded)
        rc = one_mv(s, r, sdir, 0, 0, 0, mx);
        if (rc) return rc;
        if (s.mt_dmv)
            dmvector(r);
        rc = one_mv(s, r, sdir, 0, 1, s.mt_field, my);
        if (rc) return rc;
        if (s.mt_dmv)
            dmvector(r);
        s.pmv[sdir][1][0] = s.pmv[sdir][0][0];
        s.pmv[sdir][1][1] = s.pmv[sdir][0][1];
        *sel = 0;
        return 0;
    }
    int se = 0;
    int64_t v[2][2];
    for (int pair = 0; pair < 2; ++pair) {
        se |= (int)r.get(1) << pair;
        rc = one_mv(s, r, sdir, pair, 0, 0, &v[pair][0]);
        if (rc) return rc;
        rc = one_mv(s, r, sdir, pair, 1, 1, &v[pair][1]);
        if (rc) return rc;
    }
    *mx = v[0][0]; *my = v[0][1];
    *mx2 = v[1][0]; *my2 = v[1][1];
    *sel = se;
    return 0;
}

static int parse_intra_dc(State &s, BitReader &r, int comp, int64_t *out) {
    int size;
    if (comp == 0)
        READ_VLC(r, DC_LUMA, size);
    else
        READ_VLC(r, DC_CHROMA, size);
    int64_t dc = s.dc_pred[comp];
    if (size != 0) {
        int64_t diff = r.get(size);
        int64_t half = (int64_t)1 << (size - 1);
        if (!(diff & half))
            diff = diff + 1 - half * 2;
        dc += diff;
        s.dc_pred[comp] = dc; // unsaturated predictor
        if (dc < 0) dc = 0;
        if (dc > s.intra_dc_max) dc = s.intra_dc_max;
    }
    *out = dc << s.intra_dc_scale;
    return 0;
}

static int parse_coef(State &s, BitReader &r, int16_t *coef, int start_idx,
                      int intra, int16_t *dc0slot) {
    const int use1 = intra && (s.intra_vlc & 1);
    const int32_t *qmat = intra ? s.qmat_intra : s.qmat_nonintra;
    const int q_scale = s.q_scale;
    const uint8_t *scan = s.scan;
    const int mpeg1 = !s.is_mpeg2;
    int64_t mismatch = start_idx ? coef[0] : 0;
    int idx = start_idx;
    for (;;) {
        int sym;
        if (use1)
            READ_VLC(r, DCT1, sym);
        else
            READ_VLC(r, DCT0, sym);
        int64_t level;
        if (sym == VLC_EOB)
            break;
        if (sym == VLC_ESC) {
            idx += r.get(6);
            if (mpeg1) {
                int64_t lv = r.get(8);
                if ((lv & 0x7F) == 0)
                    level = (int64_t)r.get(8) - (lv & 0x80) * 2;
                else
                    level = (int64_t)(int8_t)lv;
            } else {
                level = (int64_t)(int16_t)((uint16_t)r.get(12) << 4) >> 4;
            }
        } else {
            idx += (sym >> 8) & 0x7F;
            level = (int8_t)(sym & 0xFF);
        }
        if (idx >= 64)
            break;
        int pos = scan[idx];
        int64_t q = (int64_t)qmat[pos] * q_scale;
        int64_t a = level < 0 ? -level : level;
        int64_t t = intra ? ((a * q) >> 4) : (((2 * a + 1) * q) >> 5);
        int64_t val = level < 0 ? -t : t;
        if (val < -2048) val = -2048;
        if (val > 2047) val = 2047;
        mismatch += val;
        coef[pos] = (int16_t)val;
        idx += 1;
    }
    if (dc0slot)
        *dc0slot = coef[0]; // before oddification (skipped in FAST_DECODE)
    if (mpeg1) {
        for (int k = 0; k < 64; ++k) {
            int v = coef[k];
            if (v && !(v & 1))
                coef[k] = (int16_t)(v > 0 ? v - 1 : v + 1);
        }
    } else {
        if (!(mismatch & 1))
            coef[63] ^= 1;
    }
    return 0;
}

static int parse_inter_block(State &s, BitReader &r, int16_t *coef,
                             int16_t *dc0slot) {
    int start = 0;
    uint32_t bits = r.show(2);
    if (bits & 2) {
        r.skip(2);
        int level = (bits == 2) ? 1 : -1;
        int64_t q = (int64_t)s.q_scale * s.qmat_nonintra[0];
        int64_t t = ((2 * (level < 0 ? -level : level) + 1) * q) >> 5;
        coef[0] = (int16_t)(level > 0 ? t : -t); // unsaturated (int16 wrap)
        start = 1;
    }
    return parse_coef(s, r, coef, start, 0, dc0slot);
}

static int decode_mb_mode(State &s, BitReader &r, int *out) {
    int mb_type;
    if (s.coding_type == I_VOP)
        READ_VLC(r, MB_TYPE_I, mb_type);
    else if (s.coding_type == P_VOP)
        READ_VLC(r, MB_TYPE_P, mb_type);
    else
        READ_VLC(r, MB_TYPE_B, mb_type);
    s.mb_type = mb_type;
    int fm = s.frame_mode;
    if (mb_type & MB_MC) {
        if (fm == 0) {
            // field picture: m2d_motion_type[1][idx] (mpeg2.cpp:826-831)
            int idx = (int)r.get(2);
            if (idx <= 1)
                // field MC, 1 mv: vertical_field_select read+discarded;
                // idx 0 is the reference's "dummy" row == row 1
                // (m2d_motion_type[1][0], mpeg2.cpp:826)
                s.mt_count = 1, s.mt_field = 1, s.mt_dmv = 0;
            else if (idx == 2)
                s.mt_count = 2, s.mt_field = 1, s.mt_dmv = 0; // 16x8 pair
            else
                s.mt_count = 1, s.mt_field = 1, s.mt_dmv = 1; // dual prime
        } else {
            // frame picture: m2d_motion_type[0][idx] (mpeg2.cpp:819-825)
            int idx = (fm == 1) ? (int)r.get(2) : 2;
            if (idx == 2)
                s.mt_count = 1, s.mt_field = 0, s.mt_dmv = 0; // frame MVs
            else if (idx <= 1)
                // field MVs; idx 0 is the "dummy" row == row 1
                // (m2d_motion_type[0][0], mpeg2.cpp:819)
                s.mt_count = 2, s.mt_field = 1, s.mt_dmv = 0;
            else
                s.mt_count = 1, s.mt_field = 1, s.mt_dmv = 1; // dual prime
        }
    } else if (fm == 0) {
        s.mt_count = 1, s.mt_field = 1, s.mt_dmv = 0; // m2d_motion_type[1][1]
    } else {
        s.mt_count = 1, s.mt_field = 0, s.mt_dmv = 0;
    }
    if (fm == 1 && (mb_type & (MB_PATTERN | MB_INTRA)))
        s.dct = r.get(1);
    else if (fm != 0)
        s.dct = 0;
    else
        s.dct = 1;
    *out = mb_type;
    return 0;
}

static int parse_macroblock(State &s, BitReader &r) {
    int prev_intra = s.mb_type & MB_INTRA;
    int mb_type;
    int rc = decode_mb_mode(s, r, &mb_type);
    if (rc) return rc;
    int64_t i = s.mb_i;
    int16_t *mbcoef = s.coef + i * 6 * 64;
    if (mb_type & MB_INTRA) {
        if (!prev_intra)
            reset_intra(s);
        s.covered[i] = 1;
        s.intra[i] = 1;
        s.dct_type[i] = (uint8_t)s.dct;
        if (mb_type & MB_QUANT)
            s.q_scale = s.qmap[r.get(5)];
        if (s.concealment) {
            int64_t mx, my, mx2, my2;
            int sel;
            rc = motion_vectors(s, r, 0, &mx, &my, &mx2, &my2, &sel);
            if (rc) return rc;
            if (!r.get(1))
                return -2;
        }
        for (int blk = 0; blk < 4; ++blk) {
            int16_t *c = mbcoef + blk * 64;
            int64_t dc;
            rc = parse_intra_dc(s, r, 0, &dc);
            if (rc) return rc;
            c[0] = (int16_t)dc;
            rc = parse_coef(s, r, c, 1, 1, s.dc0 + i * 6 + blk);
            if (rc) return rc;
        }
        for (int blk = 0; blk < 2; ++blk) {
            int16_t *c = mbcoef + (4 + blk) * 64;
            int64_t dc;
            rc = parse_intra_dc(s, r, blk + 1, &dc);
            if (rc) return rc;
            c[0] = (int16_t)dc;
            rc = parse_coef(s, r, c, 1, 1, s.dc0 + i * 6 + 4 + blk);
            if (rc) return rc;
        }
    } else {
        if (prev_intra)
            reset_inter(s);
        s.covered[i] = 1;
        s.dct_type[i] = (uint8_t)s.dct;
        if (mb_type & MB_QUANT)
            s.q_scale = s.qmap[r.get(5)];
        if (mb_type & MB_MC) {
            int is_field = (s.mt_count == 2);
            s.fieldmc[i] = (uint8_t)is_field;
            if (mb_type & MB_FORWARD) {
                s.fwd[i] = 1;
                int64_t mx, my, mx2 = 0, my2 = 0;
                int sel = 0;
                rc = motion_vectors(s, r, 0, &mx, &my, &mx2, &my2, &sel);
                if (rc) return rc;
                s.mvf[i * 2] = (int32_t)mx;
                s.mvf[i * 2 + 1] = (int32_t)my;
                if (is_field) {
                    s.mvf2[i * 2] = (int32_t)mx2;
                    s.mvf2[i * 2 + 1] = (int32_t)my2;
                    s.fsel[i] |= (uint8_t)sel;
                }
            }
            if (mb_type & MB_BACKWARD) {
                s.bwd[i] = 1;
                int64_t mx, my, mx2 = 0, my2 = 0;
                int sel = 0;
                rc = motion_vectors(s, r, 1, &mx, &my, &mx2, &my2, &sel);
                if (rc) return rc;
                s.mvb[i * 2] = (int32_t)mx;
                s.mvb[i * 2 + 1] = (int32_t)my;
                if (is_field) {
                    s.mvb2[i * 2] = (int32_t)mx2;
                    s.mvb2[i * 2 + 1] = (int32_t)my2;
                    s.fsel[i] |= (uint8_t)(sel << 2);
                }
            }
        } else {
            s.fwd[i] = 1;
            s.mvf[i * 2] = 0;
            s.mvf[i * 2 + 1] = 0;
            reset_intra(s);
            reset_inter(s);
        }
        if (mb_type & MB_PATTERN) {
            int cbp;
            READ_VLC(r, CBP, cbp);
            for (int blk = 0; blk < 4; ++blk)
                if (cbp & (1 << (5 - blk))) {
                    rc = parse_inter_block(s, r, mbcoef + blk * 64,
                                           s.dc0 + i * 6 + blk);
                    if (rc) return rc;
                }
            for (int blk = 0; blk < 2; ++blk)
                if (cbp & (1 << (1 - blk))) {
                    rc = parse_inter_block(s, r, mbcoef + (4 + blk) * 64,
                                           s.dc0 + i * 6 + 4 + blk);
                    if (rc) return rc;
                }
        }
    }
    return 0;
}

} // namespace

extern "C" {

typedef struct {
    int32_t mb_w, mb_h, is_mpeg2, coding_type;
    int32_t r_size[4]; // [s*2+xy]
    int32_t intra_dc_precision, frame_pred_frame_dct;
    int32_t concealment_motion_vectors, q_scale_type, intra_vlc_format;
    int32_t alternate_scan, picture_structure;
    int32_t qmat_intra[64], qmat_nonintra[64];
} m2v_pic_params;

/* Decode one picture's slices into the plan arrays.
 * Returns: 1 picture complete, 0 incomplete, <0 error
 * (-2 invalid stream, -3 unsupported syntax -> caller falls back). */
int m2v_decode_picture(const uint8_t *data, int64_t data_len,
                       const int64_t *slice_off, const int64_t *slice_len,
                       const int32_t *vertical_pos, int n_slices,
                       const m2v_pic_params *pp,
                       uint8_t *intra, uint8_t *fwd, uint8_t *bwd,
                       int32_t *mvf, int32_t *mvb,
                       uint8_t *dct_type, int16_t *coef, uint8_t *covered,
                       int16_t *dc0, int32_t *mvf2, int32_t *mvb2,
                       uint8_t *fsel, uint8_t *fieldmc) {
    State s;
    memset(&s, 0, sizeof(s));
    s.intra = intra; s.fwd = fwd; s.bwd = bwd;
    s.dct_type = dct_type; s.covered = covered;
    s.mvf = mvf; s.mvb = mvb; s.coef = coef; s.dc0 = dc0;
    s.mvf2 = mvf2; s.mvb2 = mvb2; s.fsel = fsel; s.fieldmc = fieldmc;
    s.mb_w = pp->mb_w; s.mb_h = pp->mb_h;
    s.is_mpeg2 = pp->is_mpeg2; s.coding_type = pp->coding_type;
    for (int k = 0; k < 4; ++k) s.r_size[k >> 1][k & 1] = pp->r_size[k];
    s.intra_dc_scale = 3 - pp->intra_dc_precision;
    s.intra_dc_max = (1 << (pp->intra_dc_precision + 8)) - 1;
    s.intra_vlc = (pp->concealment_motion_vectors * 2) | pp->intra_vlc_format;
    s.concealment = pp->concealment_motion_vectors;
    // set_coding_extension_param (mpeg2.cpp:489-497): field pictures
    // (structure 1/2) decode with frame_mode 0
    s.frame_mode = (pp->picture_structure != 3) ? 0
                 : (pp->frame_pred_frame_dct ? 3 : 1);
    s.qmat_intra = pp->qmat_intra;
    s.qmat_nonintra = pp->qmat_nonintra;
    s.scan = pp->alternate_scan ? SCAN1 : SCAN0;
    s.qmap = pp->q_scale_type ? QSCALE1 : QSCALE0;
    s.mb_i = -1;
    s.mb_y = 0;
    const int64_t n_mbs = (int64_t)s.mb_w * s.mb_h;

    for (int sl = 0; sl < n_slices; ++sl) {
        BitReader r;
        /* reader spans to the END of the stream: the reference's MB loop
         * crosses slice-chunk padding and stops on a 23-zero-bit window
         * over the whole buffer (m2d_decode_macroblocks) */
        r.init(data + slice_off[sl], data_len - slice_off[sl]);
        const int64_t total_bits = (data_len - slice_off[sl]) * 8;
        (void)slice_len;
        int vpos = vertical_pos[sl];
        s.q_scale = s.qmap[r.get(5)];
        if (vpos >= s.mb_h)
            continue;
        if (vpos - s.mb_y > 1) {
            int64_t first = ((int64_t)s.mb_y + 1) * s.mb_w;
            int64_t last = (int64_t)vpos * s.mb_w;
            for (int64_t i = first; i < last; ++i) {
                s.fwd[i] = 1;
                s.covered[i] = 1;
            }
        }
        s.mb_y = vpos;
        s.mb_i = (int64_t)vpos * s.mb_w - 1;
        if (r.get(1)) {
            r.get(8);
            while (r.get(1))
                r.get(8);
        }
        reset_intra(s);
        reset_inter(s);
        for (;;) {
            int mb_inc;
            int rc = mb_address_increment(r, &mb_inc);
            if (rc) return rc;
            if (mb_inc > 1)
                skip_mbs(s, mb_inc, n_mbs);
            s.mb_i += 1;
            if (s.mb_i >= n_mbs)
                return -2;
            rc = parse_macroblock(s, r);
            if (rc) return rc;
            if (s.mb_i >= n_mbs - 1) {
                s.mb_y = s.mb_h;
                return 1;
            }
            if (r.bits_left(total_bits) < 23 || r.show(23) == 0)
                break;
        }
        s.mb_y = (int)(s.mb_i / s.mb_w);
    }
    return 0;
}

} // extern "C"
