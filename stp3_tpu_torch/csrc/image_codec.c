/* Host image codec of the port's data path: a sequential-Huffman JPEG
 * decoder, PNG row unfiltering and Pillow's resampling, in plain C with a
 * C interface for ctypes (utils/image_io.py builds it with the host's cc).
 *
 * The datasets of the JAX package read images through Pillow (libjpeg-turbo
 * underneath) and OpenCV; the port reproduces their arithmetic bit for bit:
 *
 * JPEG (libjpeg-turbo as Pillow calls it: JDCT_ISLOW, fancy upsampling):
 *   baseline and extended sequential Huffman (SOF0 / SOF1), 8-bit samples,
 *   1 or 3 components, chroma at full, half-width (4:2:2) or half-width and
 *   half-height (4:2:0) resolution through the triangle filters of
 *   jdsample.c, interleaved or one scan a component, DRI restart intervals
 *   and byte stuffing; the jidctint.c integer IDCT with its wrap-around
 *   range limit; jdcolor.c's fixed-point YCbCr -> RGB tables. Progressive,
 *   lossless, hierarchical and arithmetic-coded frames, precisions other
 *   than 8, four-component images and other sampling factors are refused
 *   (jpeg_header's return value).
 * PNG: the five row filters of one non-interlaced image (zlib stays in
 *   Python).
 * Resample (Pillow's Resample.c): the two-pass fixed-point convolution
 *   (bilinear, bicubic; coefficients rounded to 22 bits, a clipped uint8
 *   intermediate), and NEAREST through ImagingScaleAffine's accumulated
 *   double coordinates; RGBA / LA premultiplied around the convolution as
 *   Image.resize does.
 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ JPEG */

#define JPEG_ERR_CORRUPT (-1)
#define JPEG_ERR_NOMEM (-2)
#define JPEG_ERR_COMPONENTS (-3)
#define JPEG_ERR_PRECISION (-4)
#define JPEG_ERR_SAMPLING (-5)

typedef struct {
    int defined;
    uint8_t bits[17];
    uint8_t vals[256];
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t look_nbits[256]; /* 8-bit lookahead: code length, 0 if longer */
    uint8_t look_sym[256];
} huff_t;

typedef struct {
    int id, h, v, tq;
    int td, ta;                 /* tables of the current scan */
    int bw, bh;                 /* blocks a line / column, padded to MCUs */
    int dw, dh;                 /* downsampled width / height */
    int wib, hib;               /* blocks covering the component alone */
    uint8_t *plane;             /* bw*8 x bh*8 samples after the IDCT */
    int last_dc;
} comp_t;

typedef struct {
    const uint8_t *data;
    size_t n, pos;
    int width, height, ncomp, precision, sof;
    int hmax, vmax, mcux, mcuy;
    int restart_interval;
    int adobe, adobe_transform, jfif;
    uint16_t qt[4][64];         /* natural order */
    int qt_defined[4];
    huff_t dc[4], ac[4];
    comp_t comp[4];
} jpeg_t;

static const int natural_order[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

static int get16(const jpeg_t *j, size_t at) {
    return (j->data[at] << 8) | j->data[at + 1];
}

static int build_huff(huff_t *t) {
    int huffsize[257], huffcode[257];
    int p = 0, l, i, code, si;
    for (l = 1; l <= 16; l++)
        for (i = 0; i < t->bits[l]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    code = 0;
    si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) huffcode[p++] = code++;
        code <<= 1;
        si++;
    }
    p = 0;
    for (l = 1; l <= 16; l++) {
        if (t->bits[l]) {
            t->valoffset[l] = p - huffcode[p];
            p += t->bits[l];
            t->maxcode[l] = huffcode[p - 1];
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->maxcode[17] = 0xFFFFF;
    memset(t->look_nbits, 0, sizeof t->look_nbits);
    p = 0;
    for (l = 1; l <= 8; l++) {
        for (i = 1; i <= t->bits[l]; i++, p++) {
            int look = huffcode[p] << (8 - l), ctr;
            for (ctr = 1 << (8 - l); ctr > 0; ctr--, look++) {
                t->look_nbits[look] = (uint8_t)l;
                t->look_sym[look] = t->vals[p];
            }
        }
    }
    t->defined = 1;
    return 0;
}

/* One marker segment (its payload at [at, end)). Returns 0, a SOF marker
 * code (0xC2 ...) of a process this decoder refuses, or a JPEG_ERR_*. */
static int parse_segment(jpeg_t *j, int m, size_t at, size_t end) {
    size_t len = end - at + 2;
    if (m == 0xC0 || m == 0xC1) {
        int c;
        if (len < 8 || j->sof) return JPEG_ERR_CORRUPT;
        j->sof = m;
        j->precision = j->data[at];
        j->height = get16(j, at + 1);
        j->width = get16(j, at + 3);
        j->ncomp = j->data[at + 5];
        if (j->precision != 8) return JPEG_ERR_PRECISION;
        if (j->ncomp != 1 && j->ncomp != 3) return JPEG_ERR_COMPONENTS;
        if (len < 8 + 3 * (size_t)j->ncomp || j->width <= 0 || j->height <= 0)
            return JPEG_ERR_CORRUPT;
        for (c = 0; c < j->ncomp; c++) {
            comp_t *cp = &j->comp[c];
            cp->id = j->data[at + 6 + 3 * c];
            cp->h = j->data[at + 7 + 3 * c] >> 4;
            cp->v = j->data[at + 7 + 3 * c] & 15;
            cp->tq = j->data[at + 8 + 3 * c];
            if (cp->h < 1 || cp->h > 4 || cp->v < 1 || cp->v > 4 || cp->tq > 3)
                return JPEG_ERR_CORRUPT;
        }
    } else if (m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        return m;                   /* progressive, lossless, hierarchical, arithmetic */
    } else if (m == 0xC4) {
        while (at < end) {
            int tc = j->data[at] >> 4, th = j->data[at] & 15, total = 0, l;
            huff_t *t;
            if (tc > 1 || th > 3 || at + 17 > end) return JPEG_ERR_CORRUPT;
            t = tc ? &j->ac[th] : &j->dc[th];
            t->bits[0] = 0;
            for (l = 1; l <= 16; l++) total += (t->bits[l] = j->data[at + l]);
            if (total > 256 || at + 17 + total > end) return JPEG_ERR_CORRUPT;
            memcpy(t->vals, j->data + at + 17, total);
            build_huff(t);
            at += 17 + total;
        }
    } else if (m == 0xDB) {
        while (at < end) {
            int pq = j->data[at] >> 4, tq = j->data[at] & 15, k;
            if (pq > 1 || tq > 3 || at + 1 + 64 * (pq + 1) > end) return JPEG_ERR_CORRUPT;
            for (k = 0; k < 64; k++)
                j->qt[tq][natural_order[k]] = (uint16_t)(
                    pq ? get16(j, at + 1 + 2 * k) : j->data[at + 1 + k]);
            j->qt_defined[tq] = 1;
            at += 1 + 64 * (pq + 1);
        }
    } else if (m == 0xDD) {
        if (len < 4) return JPEG_ERR_CORRUPT;
        j->restart_interval = get16(j, at);
    } else if (m == 0xE0) {
        if (len >= 7 && !memcmp(j->data + at, "JFIF\0", 5)) j->jfif = 1;
    } else if (m == 0xEE) {
        if (len >= 14 && !memcmp(j->data + at, "Adobe", 5)) {
            j->adobe = 1;
            j->adobe_transform = j->data[at + 11];
        }
    }
    return 0;
}

/* Walk the marker segments from j->pos up to the next SOS or EOI, leaving
 * j->pos on that marker's 0xFF; *marker gets its code. */
static int parse_until_scan(jpeg_t *j, int *marker) {
    for (;;) {
        int m, rc;
        size_t len;
        while (j->pos < j->n && j->data[j->pos] != 0xFF) j->pos++;
        while (j->pos < j->n && j->data[j->pos] == 0xFF) j->pos++;
        if (j->pos >= j->n) return JPEG_ERR_CORRUPT;
        m = j->data[j->pos++];
        if (m == 0xD9 || m == 0xDA) {
            j->pos -= 2;
            *marker = m;
            return j->sof ? 0 : JPEG_ERR_CORRUPT;
        }
        if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
        if (j->pos + 2 > j->n) return JPEG_ERR_CORRUPT;
        len = (size_t)get16(j, j->pos);
        if (len < 2 || j->pos + len > j->n) return JPEG_ERR_CORRUPT;
        rc = parse_segment(j, m, j->pos + 2, j->pos + len);
        if (rc) return rc;
        j->pos += len;
    }
}

static int parse_headers(jpeg_t *j) {
    int marker;
    if (j->n < 4 || j->data[0] != 0xFF || j->data[1] != 0xD8) return JPEG_ERR_CORRUPT;
    j->pos = 2;
    return parse_until_scan(j, &marker);
}

static int setup_components(jpeg_t *j) {
    int c;
    j->hmax = j->vmax = 1;
    for (c = 0; c < j->ncomp; c++) {
        if (j->comp[c].h > j->hmax) j->hmax = j->comp[c].h;
        if (j->comp[c].v > j->vmax) j->vmax = j->comp[c].v;
    }
    j->mcux = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
    j->mcuy = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
    for (c = 0; c < j->ncomp; c++) {
        comp_t *cp = &j->comp[c];
        int hr = j->hmax / cp->h, vr = j->vmax / cp->v;
        if (hr * cp->h != j->hmax || vr * cp->v != j->vmax || hr > 2 || vr > hr)
            return JPEG_ERR_SAMPLING;       /* only 1x1, 2x1 and 2x2 upsampling */
        cp->dw = (int)(((long)j->width * cp->h + j->hmax - 1) / j->hmax);
        cp->dh = (int)(((long)j->height * cp->v + j->vmax - 1) / j->vmax);
        cp->wib = (int)(((long)j->width * cp->h + 8L * j->hmax - 1) / (8L * j->hmax));
        cp->hib = (int)(((long)j->height * cp->v + 8L * j->vmax - 1) / (8L * j->vmax));
        cp->bw = j->mcux * cp->h;
        cp->bh = j->mcuy * cp->v;
        cp->plane = (uint8_t *)calloc((size_t)cp->bw * 8 * cp->bh * 8, 1);
        if (!cp->plane) return JPEG_ERR_NOMEM;
    }
    return 0;
}

/* ---- entropy decoding (jdhuff.c) ---- */

typedef struct {
    const uint8_t *p, *end;
    uint64_t buf;
    int bits;
    int marker;                 /* a marker was reached: feed zeros */
} bitreader_t;

static void br_fill(bitreader_t *b) {
    while (b->bits <= 56) {
        int c = 0;
        if (!b->marker && b->p < b->end) {
            c = *b->p;
            if (c == 0xFF) {
                const uint8_t *q = b->p + 1;
                while (q < b->end && *q == 0xFF) q++;     /* fill bytes */
                if (q < b->end && *q == 0x00) {
                    b->p = q + 1;                          /* stuffed 0xFF */
                } else {
                    b->marker = 1;
                    c = 0;
                }
            } else {
                b->p++;
            }
        }
        b->buf |= (uint64_t)c << (56 - b->bits);
        b->bits += 8;
    }
}

static inline int br_get(bitreader_t *b, int n) {
    int v;
    if (n == 0) return 0;
    if (b->bits < n) br_fill(b);
    v = (int)(b->buf >> (64 - n));
    b->buf <<= n;
    b->bits -= n;
    return v;
}

static inline int huff_decode(bitreader_t *b, const huff_t *t) {
    int look, nb, code, l;
    if (b->bits < 16) br_fill(b);
    look = (int)(b->buf >> 56);
    nb = t->look_nbits[look];
    if (nb) {
        b->buf <<= nb;
        b->bits -= nb;
        return t->look_sym[look];
    }
    code = br_get(b, 9);
    l = 9;
    while (l <= 16 && code > t->maxcode[l]) {
        code = (code << 1) | br_get(b, 1);
        l++;
    }
    if (l > 16) return 0;       /* corrupt data: libjpeg decodes a zero */
    return t->vals[(code + t->valoffset[l]) & 0xFF];
}

#define HUFF_EXTEND(x, s) ((x) < (1 << ((s) - 1)) ? (x) + (int)((-1u << (s)) + 1) : (x))

static void decode_block(bitreader_t *b, comp_t *cp, const huff_t *dc, const huff_t *ac,
                         int16_t *blk) {
    int s, k, r;
    memset(blk, 0, 64 * sizeof(int16_t));
    s = huff_decode(b, dc);
    if (s) {
        r = br_get(b, s);
        s = HUFF_EXTEND(r, s);
    }
    cp->last_dc += s;
    blk[0] = (int16_t)cp->last_dc;
    for (k = 1; k < 64; k++) {
        s = huff_decode(b, ac);
        r = s >> 4;
        s &= 15;
        if (s) {
            k += r;
            r = br_get(b, s);
            blk[natural_order[k]] = (int16_t)HUFF_EXTEND(r, s);
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
}

/* ---- jidctint.c: jpeg_idct_islow ---- */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

/* post-IDCT range limit (jdmaster.c prepare_range_limit_table): index
 * (value & 1023) of the level-shifted output */
static uint8_t idct_limit[1024];
static int idct_limit_ready;

static void init_idct_limit(void) {
    int i;
    if (idct_limit_ready) return;
    for (i = 0; i < 1024; i++) {
        if (i < 128) idct_limit[i] = (uint8_t)(i + 128);
        else if (i < 512) idct_limit[i] = 255;
        else if (i < 896) idct_limit[i] = 0;
        else idct_limit[i] = (uint8_t)(i - 896);
    }
    idct_limit_ready = 1;
}

static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out, int stride) {
    int64_t tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13, z1, z2, z3, z4, z5;
    int ws[64];
    int ctr;
    for (ctr = 0; ctr < 8; ctr++) {
        const int16_t *ip = in + ctr;
        const uint16_t *qp = q + ctr;
        int *wp = ws + ctr;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
            int dcval = (ip[0] * qp[0]) * (1 << PASS1_BITS);
            wp[0] = wp[8] = wp[16] = wp[24] = wp[32] = wp[40] = wp[48] = wp[56] = dcval;
            continue;
        }
        z2 = ip[16] * qp[16];
        z3 = ip[48] * qp[48];
        z1 = (z2 + z3) * FIX_0_541196100;
        tmp2 = z1 + z3 * (-FIX_1_847759065);
        tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = ip[0] * qp[0];
        z3 = ip[32] * qp[32];
        tmp0 = (z2 + z3) * (1 << CONST_BITS);
        tmp1 = (z2 - z3) * (1 << CONST_BITS);
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        tmp0 = ip[56] * qp[56];
        tmp1 = ip[40] * qp[40];
        tmp2 = ip[24] * qp[24];
        tmp3 = ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        z4 = tmp1 + tmp3;
        z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 = tmp0 * FIX_0_298631336;
        tmp1 = tmp1 * FIX_2_053119869;
        tmp2 = tmp2 * FIX_3_072711026;
        tmp3 = tmp3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        wp[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
        wp[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
        wp[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
        wp[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
        wp[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
        wp[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
        wp[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
        wp[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
    }
    for (ctr = 0; ctr < 8; ctr++) {
        const int *wp = ws + 8 * ctr;
        uint8_t *op = out + (size_t)ctr * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
            uint8_t v = idct_limit[(int)DESCALE((int64_t)wp[0], PASS1_BITS + 3) & 1023];
            memset(op, v, 8);
            continue;
        }
        z2 = wp[2];
        z3 = wp[6];
        z1 = (z2 + z3) * FIX_0_541196100;
        tmp2 = z1 + z3 * (-FIX_1_847759065);
        tmp3 = z1 + z2 * FIX_0_765366865;
        tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
        tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
        tmp10 = tmp0 + tmp3;
        tmp13 = tmp0 - tmp3;
        tmp11 = tmp1 + tmp2;
        tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        z4 = tmp1 + tmp3;
        z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 = tmp0 * FIX_0_298631336;
        tmp1 = tmp1 * FIX_2_053119869;
        tmp2 = tmp2 * FIX_3_072711026;
        tmp3 = tmp3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
#define OUT(i, x) op[i] = idct_limit[(int)DESCALE(x, CONST_BITS + PASS1_BITS + 3) & 1023]
        OUT(0, tmp10 + tmp3);
        OUT(7, tmp10 - tmp3);
        OUT(1, tmp11 + tmp2);
        OUT(6, tmp11 - tmp2);
        OUT(2, tmp12 + tmp1);
        OUT(5, tmp12 - tmp1);
        OUT(3, tmp13 + tmp0);
        OUT(4, tmp13 - tmp0);
#undef OUT
    }
}

/* Decode one scan starting at the SOS marker at j->pos. */
static int decode_scan(jpeg_t *j) {
    size_t at = j->pos + 2;
    int len = get16(j, at), ns, i, c;
    comp_t *sc[4];
    bitreader_t br;
    int16_t blk[64];
    long mcus, m, total;
    int restarts_left;
    at += 2;
    ns = j->data[at++];
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) return JPEG_ERR_CORRUPT;
    for (i = 0; i < ns; i++) {
        int cid = j->data[at], tables = j->data[at + 1];
        sc[i] = NULL;
        for (c = 0; c < j->ncomp; c++)
            if (j->comp[c].id == cid) sc[i] = &j->comp[c];
        if (!sc[i]) return JPEG_ERR_CORRUPT;
        sc[i]->td = tables >> 4;
        sc[i]->ta = tables & 15;
        if (sc[i]->td > 3 || sc[i]->ta > 3 || !j->dc[sc[i]->td].defined ||
            !j->ac[sc[i]->ta].defined || !j->qt_defined[sc[i]->tq])
            return JPEG_ERR_CORRUPT;
        sc[i]->last_dc = 0;
        at += 2;
    }
    at += 3;                                        /* Ss, Se, Ah/Al */
    br.p = j->data + at;
    br.end = j->data + j->n;
    br.buf = 0;
    br.bits = 0;
    br.marker = 0;

    if (ns == 1) {
        comp_t *cp = sc[0];
        total = (long)cp->wib * cp->hib;
        mcus = total;
    } else {
        total = (long)j->mcux * j->mcuy;
        mcus = total;
    }
    restarts_left = j->restart_interval;
    for (m = 0; m < mcus; m++) {
        if (j->restart_interval) {
            if (restarts_left == 0) {
                /* discard the buffered bits, skip to and past the RSTn marker */
                const uint8_t *p = br.p;
                while (p + 1 < br.end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)) p++;
                if (p + 1 < br.end) p += 2;
                br.p = p;
                br.buf = 0;
                br.bits = 0;
                br.marker = 0;
                for (i = 0; i < ns; i++) sc[i]->last_dc = 0;
                restarts_left = j->restart_interval;
            }
            restarts_left--;
        }
        if (ns == 1) {
            comp_t *cp = sc[0];
            long bx = m % cp->wib, by = m / cp->wib;
            decode_block(&br, cp, &j->dc[cp->td], &j->ac[cp->ta], blk);
            idct_islow(blk, j->qt[cp->tq], cp->plane + (size_t)by * 8 * cp->bw * 8 + bx * 8,
                       cp->bw * 8);
        } else {
            long mx = m % j->mcux, my = m / j->mcux;
            for (i = 0; i < ns; i++) {
                comp_t *cp = sc[i];
                int yy, xx;
                for (yy = 0; yy < cp->v; yy++)
                    for (xx = 0; xx < cp->h; xx++) {
                        long bx = mx * cp->h + xx, by = my * cp->v + yy;
                        decode_block(&br, cp, &j->dc[cp->td], &j->ac[cp->ta], blk);
                        idct_islow(blk, j->qt[cp->tq],
                                   cp->plane + (size_t)by * 8 * cp->bw * 8 + bx * 8, cp->bw * 8);
                    }
            }
        }
    }
    /* continue after the entropy-coded segment: the next marker */
    {
        const uint8_t *p = br.p;
        while (p + 1 < br.end && !(p[0] == 0xFF && p[1] != 0x00 && !(p[1] >= 0xD0 && p[1] <= 0xD7)))
            p++;
        j->pos = (size_t)(p - j->data);
    }
    return 0;
}

/* ---- jdsample.c: upsample one component row to the output width ---- */

static void upsample_row(const jpeg_t *j, const comp_t *cp, int y, uint8_t *out) {
    int hr = j->hmax / cp->h, vr = j->vmax / cp->v;
    int stride = cp->bw * 8, dw = cp->dw, x;
    const uint8_t *plane = cp->plane;
    if (hr == 1 && vr == 1) {
        memcpy(out, plane + (size_t)y * stride, j->width);
        return;
    }
    if (hr == 2 && vr == 1 && dw > 2) {
        const uint8_t *in = plane + (size_t)y * stride;
        int o = 0, v;
        v = in[0];
        out[o++] = (uint8_t)v;
        out[o++] = (uint8_t)((v * 3 + in[1] + 2) >> 2);
        for (x = 1; x < dw - 1; x++) {
            v = in[x] * 3;
            out[o++] = (uint8_t)((v + in[x - 1] + 1) >> 2);
            out[o++] = (uint8_t)((v + in[x + 1] + 2) >> 2);
        }
        v = in[dw - 1];
        out[o++] = (uint8_t)((v * 3 + in[dw - 2] + 1) >> 2);
        out[o++] = (uint8_t)v;
        return;
    }
    if (hr == 2 && vr == 2 && dw > 2) {
        int r = y / 2, r1 = (y & 1) ? r + 1 : r - 1, o = 0;
        int thiscolsum, lastcolsum, nextcolsum;
        const uint8_t *in0, *in1;
        if (r1 < 0) r1 = 0;
        if (r1 > cp->dh - 1) r1 = cp->dh - 1;
        in0 = plane + (size_t)r * stride;
        in1 = plane + (size_t)r1 * stride;
        thiscolsum = in0[0] * 3 + in1[0];
        nextcolsum = in0[1] * 3 + in1[1];
        out[o++] = (uint8_t)((thiscolsum * 4 + 8) >> 4);
        out[o++] = (uint8_t)((thiscolsum * 3 + nextcolsum + 7) >> 4);
        lastcolsum = thiscolsum;
        thiscolsum = nextcolsum;
        for (x = 2; x < dw; x++) {
            nextcolsum = in0[x] * 3 + in1[x];
            out[o++] = (uint8_t)((thiscolsum * 3 + lastcolsum + 8) >> 4);
            out[o++] = (uint8_t)((thiscolsum * 3 + nextcolsum + 7) >> 4);
            lastcolsum = thiscolsum;
            thiscolsum = nextcolsum;
        }
        out[o++] = (uint8_t)((thiscolsum * 3 + lastcolsum + 8) >> 4);
        out[o++] = (uint8_t)((thiscolsum * 4 + 7) >> 4);
        return;
    }
    {   /* h2v1_upsample / h2v2_upsample (a component at most 2 wide): replication */
        const uint8_t *in = plane + (size_t)(y / vr) * stride;
        for (x = 0; x < j->width; x++) out[x] = in[x / hr];
    }
}

static int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

/* Read the header of a JPEG held in memory. info: width, height,
 * components (1 or 3), SOF marker. Returns 0, the code of a refused SOF
 * marker (0xC2 ...), or a negative JPEG_ERR_*. */
int jpeg_header(const uint8_t *data, size_t n, int *info) {
    jpeg_t j;
    int rc;
    memset(&j, 0, sizeof j);
    j.data = data;
    j.n = n;
    rc = parse_headers(&j);
    info[0] = j.width;
    info[1] = j.height;
    info[2] = j.ncomp;
    info[3] = j.sof;
    info[4] = j.precision;
    return rc;
}

/* Decode a JPEG held in memory into out (height x width x components). */
int jpeg_decode(const uint8_t *data, size_t n, uint8_t *out) {
    jpeg_t j;
    int rc, c, y, x, rgb;
    uint8_t *rows[4] = {0};
    static int cr_r[256], cb_b[256];
    static int32_t cr_g[256], cb_g[256];
    static int tables_ready;
    memset(&j, 0, sizeof j);
    j.data = data;
    j.n = n;
    init_idct_limit();
    if (!tables_ready) {                            /* jdcolor.c build_ycc_rgb_table */
        int i;
        for (i = 0; i < 256; i++) {
            int64_t xv = i - 128;
            cr_r[i] = (int)((91881 * xv + 32768) >> 16);
            cb_b[i] = (int)((116130 * xv + 32768) >> 16);
            cr_g[i] = (int32_t)(-46802 * xv);
            cb_g[i] = (int32_t)(-22554 * xv + 32768);
        }
        tables_ready = 1;
    }
    rc = parse_headers(&j);
    if (rc) return rc;
    rc = setup_components(&j);
    if (rc) goto done;
    for (;;) {                                      /* every scan, to EOI */
        int marker;
        rc = parse_until_scan(&j, &marker);
        if (rc) goto done;
        if (marker == 0xD9) break;
        rc = decode_scan(&j);
        if (rc) goto done;
        if (j.pos + 1 >= j.n) break;                /* no EOI: what was decoded stands */
    }
    rgb = 0;
    if (j.ncomp == 3) {                             /* jdapimin.c default_decompress_parms */
        if (j.jfif) rgb = 0;
        else if (j.adobe) rgb = j.adobe_transform == 0;
        else rgb = j.comp[0].id == 82 && j.comp[1].id == 71 && j.comp[2].id == 66;
    }
    for (c = 0; c < j.ncomp; c++) {
        rows[c] = (uint8_t *)malloc((size_t)j.comp[c].bw * 8 * 4 + 16);
        if (!rows[c]) { rc = JPEG_ERR_NOMEM; goto done; }
    }
    for (y = 0; y < j.height; y++) {
        uint8_t *o = out + (size_t)y * j.width * j.ncomp;
        for (c = 0; c < j.ncomp; c++) upsample_row(&j, &j.comp[c], y, rows[c]);
        if (j.ncomp == 1) {
            memcpy(o, rows[0], j.width);
        } else if (rgb) {
            for (x = 0; x < j.width; x++) {
                o[3 * x] = rows[0][x];
                o[3 * x + 1] = rows[1][x];
                o[3 * x + 2] = rows[2][x];
            }
        } else {
            for (x = 0; x < j.width; x++) {
                int yv = rows[0][x], cb = rows[1][x], cr = rows[2][x];
                o[3 * x] = (uint8_t)clamp255(yv + cr_r[cr]);
                o[3 * x + 1] = (uint8_t)clamp255(yv + (int)((cb_g[cb] + cr_g[cr]) >> 16));
                o[3 * x + 2] = (uint8_t)clamp255(yv + cb_b[cb]);
            }
        }
    }
    rc = 0;
done:
    for (c = 0; c < 4; c++) {
        free(rows[c]);
        free(j.comp[c].plane);
    }
    return rc;
}

/* ------------------------------------------------------------------- PNG */

static inline int paeth(int a, int b, int c) {
    int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

/* Undo the row filters of a non-interlaced image: raw holds h rows of a
 * filter byte and stride bytes; bpp the bytes a pixel (at least 1).
 * Returns 0, or 1 + the row of an unknown filter type. */
int png_unfilter(const uint8_t *raw, uint8_t *out, int h, int stride, int bpp) {
    int y, i;
    for (y = 0; y < h; y++) {
        const uint8_t *src = raw + (size_t)y * (stride + 1);
        uint8_t *dst = out + (size_t)y * stride;
        const uint8_t *prev = y ? dst - stride : NULL;
        int f = *src++;
        switch (f) {
        case 0:
            memcpy(dst, src, stride);
            break;
        case 1:
            for (i = 0; i < stride; i++)
                dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
            break;
        case 2:
            for (i = 0; i < stride; i++) dst[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
            break;
        case 3:
            for (i = 0; i < stride; i++) {
                int a = i >= bpp ? dst[i - bpp] : 0, b = prev ? prev[i] : 0;
                dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (i = 0; i < stride; i++) {
                int a = i >= bpp ? dst[i - bpp] : 0, b = prev ? prev[i] : 0;
                int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
                dst[i] = (uint8_t)(src[i] + paeth(a, b, c));
            }
            break;
        default:
            return y + 1;
        }
    }
    return 0;
}

/* -------------------------------------------------- Pillow's Resample.c */

#define PRECISION_BITS (32 - 8 - 2)

static double filter_bilinear(double x) {
    if (x < 0.0) x = -x;
    if (x < 1.0) return 1.0 - x;
    return 0.0;
}

static double filter_bicubic(double x) {
    const double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
    if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
    return 0.0;
}

/* precompute_coeffs + normalize_coeffs_8bpc: bounds (xmin, count) per
 * output pixel and ksize fixed-point coefficients each. */
static int precompute_coeffs(int in_size, int out_size, int filter, int **boundsp,
                             int32_t **kkp) {
    double (*fn)(double) = filter == 2 ? filter_bicubic : filter_bilinear;
    double support = filter == 2 ? 2.0 : 1.0, scale, filterscale, ss;
    int ksize, xx, x;
    int *bounds;
    double *kk;
    int32_t *ik;
    filterscale = scale = (double)(float)in_size / out_size;
    if (filterscale < 1.0) filterscale = 1.0;
    support = support * filterscale;
    ksize = (int)ceil(support) * 2 + 1;
    kk = (double *)malloc((size_t)out_size * ksize * sizeof(double));
    bounds = (int *)malloc((size_t)out_size * 2 * sizeof(int));
    ik = (int32_t *)malloc((size_t)out_size * ksize * sizeof(int32_t));
    if (!kk || !bounds || !ik) {
        free(kk); free(bounds); free(ik);
        return -1;
    }
    ss = 1.0 / filterscale;
    for (xx = 0; xx < out_size; xx++) {
        double center = 0.0 + (xx + 0.5) * scale, ww = 0.0;
        int xmin = (int)(center - support + 0.5), xmax = (int)(center + support + 0.5);
        double *k = kk + (size_t)xx * ksize;
        if (xmin < 0) xmin = 0;
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        for (x = 0; x < xmax; x++) {
            double w = fn((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++)
            if (ww != 0.0) k[x] /= ww;
        for (; x < ksize; x++) k[x] = 0;
        bounds[xx * 2] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
    for (x = 0; x < out_size * ksize; x++)
        ik[x] = kk[x] < 0 ? (int32_t)(-0.5 + kk[x] * (1 << PRECISION_BITS))
                          : (int32_t)(0.5 + kk[x] * (1 << PRECISION_BITS));
    free(kk);
    *boundsp = bounds;
    *kkp = ik;
    return ksize;
}

static inline uint8_t clip8(int32_t in) {
    if (in >= (1 << PRECISION_BITS << 8)) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> PRECISION_BITS);
}

/* Convert.c rgbA2rgba / rgba2rgbA on the last channel as alpha */
#define MULDIV255(a, b, tmp) (tmp = (a) * (b) + 128, ((((tmp) >> 8) + (tmp)) >> 8))

static void premultiply(uint8_t *p, size_t npix, int ch) {
    size_t i;
    int c;
    for (i = 0; i < npix; i++, p += ch) {
        unsigned int alpha = p[ch - 1], tmp;
        for (c = 0; c < ch - 1; c++) p[c] = (uint8_t)MULDIV255(p[c], alpha, tmp);
    }
}

static void unpremultiply(uint8_t *p, size_t npix, int ch) {
    size_t i;
    int c;
    for (i = 0; i < npix; i++, p += ch) {
        unsigned int alpha = p[ch - 1];
        if (alpha == 255 || alpha == 0) continue;
        for (c = 0; c < ch - 1; c++) {
            unsigned int v = (255 * p[c]) / alpha;
            p[c] = (uint8_t)(v > 255 ? 255 : v);
        }
    }
}

/* ImagingScaleAffine with IMAGING_TRANSFORM_NEAREST: the source of output
 * pixel x is (int) of a double that starts at scale / 2 and grows by
 * scale each pixel; out-of-range sources stay 0. */
static void nearest_table(int in_size, int out_size, int *tab) {
    double a = (double)(float)in_size / out_size, xo = 0.0 + a * 0.5;
    int x;
    for (x = 0; x < out_size; x++) {
        int xin = xo < 0.0 ? -1 : (int)xo;
        tab[x] = (xin >= 0 && xin < in_size) ? xin : -1;
        xo += a;
    }
}

/* Resize an ih x iw x ch uint8 image to oh x ow as Pillow's Image.resize
 * does on a whole image: filter 0 NEAREST, 1 BILINEAR, 2 BICUBIC;
 * premultiply: the last channel is alpha (RGBA, LA) and the convolution
 * runs on premultiplied values. Returns 0, or -1 when out of memory. */
int resample_u8(const uint8_t *in, int ih, int iw, int ch, uint8_t *out, int oh, int ow,
                int filter, int premult) {
    if (filter == 0) {
        int *xt = (int *)malloc(sizeof(int) * ow), *yt = (int *)malloc(sizeof(int) * oh);
        int y, x, c;
        if (!xt || !yt) { free(xt); free(yt); return -1; }
        nearest_table(iw, ow, xt);
        nearest_table(ih, oh, yt);
        for (y = 0; y < oh; y++) {
            uint8_t *o = out + (size_t)y * ow * ch;
            if (yt[y] < 0) { memset(o, 0, (size_t)ow * ch); continue; }
            for (x = 0; x < ow; x++) {
                const uint8_t *s = in + ((size_t)yt[y] * iw + (xt[x] < 0 ? 0 : xt[x])) * ch;
                for (c = 0; c < ch; c++) o[x * ch + c] = xt[x] < 0 ? 0 : s[c];
            }
        }
        free(xt);
        free(yt);
        return 0;
    }
    {
        int need_h = ow != iw, need_v = oh != ih;
        int *bh = NULL, *bv = NULL, kh = 0, kv, ybox_first, ybox_last, y, x, c, i;
        int32_t *kkh = NULL, *kkv = NULL;
        uint8_t *src = NULL, *tmp = NULL;
        const uint8_t *cur;
        int cur_h, cur_w;
        int rc = -1;
        if (!need_h && !need_v) {
            memcpy(out, in, (size_t)ih * iw * ch);
            return 0;
        }
        if (premult) {
            src = (uint8_t *)malloc((size_t)ih * iw * ch);
            if (!src) return -1;
            memcpy(src, in, (size_t)ih * iw * ch);
            premultiply(src, (size_t)ih * iw, ch);
            in = src;
        }
        kv = precompute_coeffs(ih, oh, filter, &bv, &kkv);
        if (kv < 0) goto fail;
        ybox_first = bv[0];
        ybox_last = bv[oh * 2 - 2] + bv[oh * 2 - 1];
        cur = in;
        cur_h = ih;
        cur_w = iw;
        if (need_h) {
            int th = ybox_last - ybox_first;
            kh = precompute_coeffs(iw, ow, filter, &bh, &kkh);
            if (kh < 0) goto fail;
            for (i = 0; i < oh; i++) bv[i * 2] -= ybox_first;
            tmp = (uint8_t *)malloc((size_t)th * ow * ch + 1);
            if (!tmp) goto fail;
            for (y = 0; y < th; y++) {
                const uint8_t *row = in + (size_t)(y + ybox_first) * iw * ch;
                uint8_t *o = tmp + (size_t)y * ow * ch;
                for (x = 0; x < ow; x++) {
                    int xmin = bh[x * 2], xmax = bh[x * 2 + 1];
                    const int32_t *k = kkh + (size_t)x * kh;
                    for (c = 0; c < ch; c++) {
                        int32_t ss = 1 << (PRECISION_BITS - 1);
                        int xi;
                        for (xi = 0; xi < xmax; xi++) ss += row[(xi + xmin) * ch + c] * k[xi];
                        o[x * ch + c] = clip8(ss);
                    }
                }
            }
            cur = tmp;
            cur_h = th;
            cur_w = ow;
        }
        if (need_v) {
            for (y = 0; y < oh; y++) {
                int ymin = bv[y * 2], ymax = bv[y * 2 + 1];
                const int32_t *k = kkv + (size_t)y * kv;
                uint8_t *o = out + (size_t)y * cur_w * ch;
                for (x = 0; x < cur_w * ch; x++) {
                    int32_t ss = 1 << (PRECISION_BITS - 1);
                    int yi;
                    for (yi = 0; yi < ymax; yi++)
                        ss += cur[(size_t)(yi + ymin) * cur_w * ch + x] * k[yi];
                    o[x] = clip8(ss);
                }
            }
        } else {
            memcpy(out, cur, (size_t)cur_h * cur_w * ch);
        }
        if (premult) unpremultiply(out, (size_t)oh * ow, ch);
        rc = 0;
    fail:
        free(bh); free(bv); free(kkh); free(kkv); free(tmp); free(src);
        return rc;
    }
}
