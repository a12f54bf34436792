"""The port's image I/O: what the JAX package's datasets take from Pillow
(``Image.open`` of JPEG and PNG files, ``Image.resize``), bit for bit, on
a host C source (``csrc/image_codec.c``) that ``nvcc_build.load_host_library``
builds with the host's C compiler at first use and ctypes binds.

* ``read_jpeg(path)``: uint8 (H, W, 3), or (H, W) for a grayscale file,
  as ``np.asarray(PIL.Image.open(path))`` under libjpeg-turbo: baseline
  and extended sequential Huffman frames (SOF0 / SOF1), 8-bit, 1 or 3
  components, sampled 4:4:4, 4:2:2 or 4:2:0 (through libjpeg-turbo's
  triangle upsampling filters), restart intervals. Progressive,
  lossless, hierarchical and arithmetic-coded frames, 12-bit samples,
  CMYK and other sampling factors raise ``NotImplementedError``.
* ``read_png(path)``: what ``np.asarray(PIL.Image.open(path))`` gives for
  a non-interlaced 8-bit PNG: (H, W) for grayscale ('L') and palette
  ('P': the indices), (H, W, 2) 'LA', (H, W, 3) 'RGB', (H, W, 4) 'RGBA'.
  Interlaced files and other bit depths raise ``NotImplementedError``.
  ``decode_png`` also gives the Pillow mode.
* ``resample(arr, (w, h), filter)``: ``Image.resize((w, h), filter)`` of
  the whole image for 'nearest', 'bilinear' and 'bicubic'; a 4-channel
  array is RGBA and a 2-channel one LA, whose colour Pillow resamples
  premultiplied by alpha (not under 'nearest').

The C functions serve every caller on every device. Beside them stand
their numpy plain versions (``decode_jpeg_plain``, ``decode_png_plain``,
``resample_plain``), straightforward and slow, which only the tests call
to hold the C source to.
"""
from __future__ import annotations

import ctypes
import math
import struct
import zlib
from typing import Tuple

import numpy as np

from stp3_tpu_torch.ops.kernels import nvcc_build

FILTERS = {'nearest': 0, 'bilinear': 1, 'bicubic': 2}

# the frames this decoder refuses, by their SOF marker
_SOF_NAMES = {
    0xC2: 'SOF2 (progressive Huffman)', 0xC3: 'SOF3 (lossless Huffman)',
    0xC5: 'SOF5 (differential sequential Huffman)', 0xC6: 'SOF6 (differential progressive '
    'Huffman)', 0xC7: 'SOF7 (differential lossless Huffman)', 0xC9: 'SOF9 (sequential '
    'arithmetic)', 0xCA: 'SOF10 (progressive arithmetic)', 0xCB: 'SOF11 (lossless '
    'arithmetic)', 0xCD: 'SOF13 (differential sequential arithmetic)', 0xCE: 'SOF14 '
    '(differential progressive arithmetic)', 0xCF: 'SOF15 (differential lossless arithmetic)'}


def load() -> dict:
    """Build (at first use) and load the C library; returns the build's
    info (``nvcc_build.load_host_library``). A data loader calls it in
    the parent process before it starts its workers."""
    return _lib()[1]


def _lib():
    lib, info = nvcc_build.load_host_library('image_codec', ['image_codec.c'])
    if not getattr(lib, '_stp3_bound', False):
        u8p = ctypes.c_void_p
        lib.jpeg_header.argtypes = [u8p, ctypes.c_size_t, u8p]
        lib.jpeg_header.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [u8p, ctypes.c_size_t, u8p]
        lib.jpeg_decode.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.png_unfilter.restype = ctypes.c_int
        lib.resample_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.resample_u8.restype = ctypes.c_int
        lib._stp3_bound = True
    return lib, info


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def read_bytes(path) -> bytes:
    with open(path, 'rb') as f:
        return f.read()


# ---------------------------------------------------------------- JPEG


def _jpeg_error(rc: int, what: str) -> Exception:
    if rc in _SOF_NAMES:
        return NotImplementedError(f'{what}: a {_SOF_NAMES[rc]} JPEG; only baseline and '
                                   'extended sequential Huffman (SOF0 / SOF1) are read')
    if rc == -3:
        return NotImplementedError(f'{what}: only 1- and 3-component JPEGs are read')
    if rc == -4:
        return NotImplementedError(f'{what}: only 8-bit JPEG samples are read')
    if rc == -5:
        return NotImplementedError(f'{what}: only 4:4:4, 4:2:2 and 4:2:0 JPEG sampling is read')
    if rc == -2:
        return MemoryError(what)
    return ValueError(f'{what}: not a readable JPEG (code {rc})')


def decode_jpeg(data: bytes, what: str = 'JPEG') -> np.ndarray:
    """A JPEG file's bytes -> uint8 (H, W, 3) or (H, W) (``read_jpeg``)."""
    lib = _lib()[0]
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(5, np.int32)
    rc = lib.jpeg_header(_ptr(buf), buf.size, _ptr(info))
    if rc:
        raise _jpeg_error(rc, what)
    w, h, nc = int(info[0]), int(info[1]), int(info[2])
    out = np.empty((h, w, nc), np.uint8)
    rc = lib.jpeg_decode(_ptr(buf), buf.size, _ptr(out))
    if rc:
        raise _jpeg_error(rc, what)
    return out[..., 0] if nc == 1 else out


def read_jpeg(path) -> np.ndarray:
    """``np.asarray(PIL.Image.open(path))`` of a JPEG file."""
    return decode_jpeg(read_bytes(path), str(path))


# ----------------------------------------------------------------- PNG

_PNG_MODES = {0: ('L', 1), 2: ('RGB', 3), 3: ('P', 1), 4: ('LA', 2), 6: ('RGBA', 4)}


def _png_parse(data: bytes, what: str):
    """(height, width, channels, mode, the inflated filtered rows)."""
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError(f'{what}: not a PNG file')
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None:
        raise ValueError(f'{what}: a PNG without IHDR')
    width, height, depth, colour, _, _, interlace = header
    if colour not in _PNG_MODES:
        raise ValueError(f'{what}: PNG colour type {colour}')
    if depth != 8:
        raise NotImplementedError(f'{what}: a PNG of bit depth {depth}; only 8 is read')
    if interlace:
        raise NotImplementedError(f'{what}: an interlaced (Adam7) PNG')
    mode, ch = _PNG_MODES[colour]
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if raw.size != height * (width * ch + 1):
        raise ValueError(f'{what}: PNG data of {raw.size} bytes for {width}x{height}x{ch}')
    return height, width, ch, mode, raw


def _png_array(out: np.ndarray, ch: int) -> np.ndarray:
    return out[..., 0] if ch == 1 else out


def decode_png(data: bytes, what: str = 'PNG') -> Tuple[np.ndarray, str]:
    """A PNG file's bytes -> (the array ``read_png`` gives, Pillow's mode:
    'L', 'P', 'LA', 'RGB' or 'RGBA')."""
    h, w, ch, mode, raw = _png_parse(data, what)
    out = np.empty((h, w, ch), np.uint8)
    rc = _lib()[0].png_unfilter(_ptr(raw), _ptr(out), h, w * ch, ch)
    if rc:
        raise ValueError(f'{what}: unknown PNG filter type in row {rc - 1}')
    return _png_array(out, ch), mode


def read_png(path) -> np.ndarray:
    """``np.asarray(PIL.Image.open(path))`` of an 8-bit PNG file."""
    return decode_png(read_bytes(path), str(path))[0]


# ------------------------------------------------------------- resample


def _check_image(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3):
        raise TypeError(f'resample takes a uint8 (H, W) or (H, W, C) array, got '
                        f'{arr.dtype} {arr.shape}')
    return np.ascontiguousarray(arr)


def resample(arr: np.ndarray, size: Tuple[int, int], filter: str = 'bicubic') -> np.ndarray:
    """``Image.resize(size, filter)`` of the whole image; ``size`` is
    (width, height) as Pillow takes it."""
    arr = _check_image(arr)
    ow, oh = (int(s) for s in size)
    if ow <= 0 or oh <= 0:
        raise ValueError(f'resample to {size}')
    ih, iw = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    out = np.empty((oh, ow) + arr.shape[2:], np.uint8)
    premult = filter != 'nearest' and ch in (2, 4)
    rc = _lib()[0].resample_u8(_ptr(arr), ih, iw, ch, _ptr(out), oh, ow, FILTERS[filter],
                               int(premult))
    if rc:
        raise MemoryError(f'resample {arr.shape} -> {size}')
    return out


# -------------------------------------------------------- plain versions
# numpy / Python versions of the C functions, for the tests only


def _huffman_tables(bits, vals):
    """{(length, code): symbol} of a DHT table."""
    table, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[(length, code)] = vals[k]
            code += 1
            k += 1
        code <<= 1
    return table


_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
                    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
                    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
                    60, 61, 54, 47, 55, 62, 63] + [63] * 16)


class _BitReader:
    """Bit-serial reader of an entropy-coded segment (0xFF00 unstuffed;
    a marker yields zero bits)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.byte, self.left, self.marker = data, pos, 0, 0, False

    def bit(self) -> int:
        if self.left == 0:
            c = 0
            if not self.marker and self.pos < len(self.data):
                c = self.data[self.pos]
                if c == 0xFF:
                    q = self.pos + 1
                    while q < len(self.data) and self.data[q] == 0xFF:
                        q += 1
                    if q < len(self.data) and self.data[q] == 0:
                        self.pos = q + 1
                    else:
                        self.marker, c = True, 0
                else:
                    self.pos += 1
            self.byte, self.left = c, 8
        self.left -= 1
        return (self.byte >> self.left) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def decode(self, table) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.bit()
            if (length, code) in table:
                return table[(length, code)]
        return 0

    def restart(self):
        d = self.data
        p = self.pos
        while p + 1 < len(d) and not (d[p] == 0xFF and 0xD0 <= d[p + 1] <= 0xD7):
            p += 1
        self.pos, self.left, self.marker = min(p + 2, len(d)), 0, False


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """jidctint.c over blocks: coef (n, 64) natural order, q (64,) ->
    (n, 8, 8) uint8 through the post-IDCT range limit."""
    c = (coef.astype(np.int64) * q.astype(np.int64)).reshape(-1, 8, 8)

    def one_d(x, shift, axis):
        g = [np.take(x, i, axis=axis) for i in range(8)]
        z2, z3 = g[2], g[6]
        z1 = (z2 + z3) * 4433
        tmp2 = z1 + z3 * -15137
        tmp3 = z1 + z2 * 6270
        tmp0 = (g[0] + g[4]) * 8192
        tmp1 = (g[0] - g[4]) * 8192
        t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        tmp0, tmp1, tmp2, tmp3 = g[7], g[5], g[3], g[1]
        z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
        z5 = (z3 + z4) * 9633
        tmp0, tmp1, tmp2, tmp3 = tmp0 * 2446, tmp1 * 16819, tmp2 * 25172, tmp3 * 12299
        z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
        tmp0 += z1 + z3
        tmp1 += z2 + z4
        tmp2 += z2 + z3
        tmp3 += z1 + z4
        outs = [t10 + tmp3, t11 + tmp2, t12 + tmp1, t13 + tmp0,
                t13 - tmp0, t12 - tmp1, t11 - tmp2, t10 - tmp3]
        return np.stack([(o + (1 << (shift - 1))) >> shift for o in outs], axis=axis)

    ws = one_d(c, 13 - 2, axis=1)                 # columns: rows index 0..7 along axis 1
    out = one_d(ws, 13 + 2 + 3, axis=2)
    idx = out & 1023
    limit = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                            np.arange(128)]).astype(np.uint8)
    return limit[idx]


def _jpeg_segments(data: bytes, pos: int):
    """Yield (marker, payload start, payload end) from ``pos`` on, up to
    and including an SOS or EOI."""
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError('JPEG: no EOI')
        m = data[pos]
        pos += 1
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            continue
        if m == 0xD9:
            yield m, pos, pos
            return
        length = (data[pos] << 8) | data[pos + 1]
        yield m, pos + 2, pos + length
        pos += length


def decode_jpeg_plain(data: bytes) -> np.ndarray:
    """``decode_jpeg`` in Python and numpy."""
    qt, dc_t, ac_t, comps, frame = {}, {}, {}, [], {}
    restart, jfif, adobe = 0, False, None
    pos = 2
    while True:
        for m, a, b in _jpeg_segments(data, pos):
            pos = b
            if m in (0xC0, 0xC1):
                frame = dict(p=data[a], h=(data[a + 1] << 8) | data[a + 2],
                             w=(data[a + 3] << 8) | data[a + 4])
                if frame['p'] != 8:
                    raise NotImplementedError('only 8-bit JPEG samples are read')
                nc = data[a + 5]
                if nc not in (1, 3):
                    raise NotImplementedError('only 1- and 3-component JPEGs are read')
                comps = [dict(id=data[a + 6 + 3 * i], h=data[a + 7 + 3 * i] >> 4,
                              v=data[a + 7 + 3 * i] & 15, tq=data[a + 8 + 3 * i])
                         for i in range(nc)]
            elif m in _SOF_NAMES:
                raise NotImplementedError(f'a {_SOF_NAMES[m]} JPEG')
            elif m == 0xC4:
                while a < b:
                    tc, th = data[a] >> 4, data[a] & 15
                    bits = list(data[a + 1:a + 17])
                    vals = list(data[a + 17:a + 17 + sum(bits)])
                    (ac_t if tc else dc_t)[th] = _huffman_tables(bits, vals)
                    a += 17 + sum(bits)
            elif m == 0xDB:
                while a < b:
                    pq, tq = data[a] >> 4, data[a] & 15
                    n = 64 * (pq + 1)
                    raw = np.frombuffer(data[a + 1:a + 1 + n], '>u2' if pq else np.uint8)
                    table = np.zeros(64, np.int64)
                    table[_ZIGZAG[:64]] = raw
                    qt[tq] = table
                    a += 1 + n
            elif m == 0xDD:
                restart = (data[a] << 8) | data[a + 1]
            elif m == 0xE0 and data[a:a + 5] == b'JFIF\0':
                jfif = True
            elif m == 0xEE and data[a:a + 5] == b'Adobe':
                adobe = data[a + 11]
            if m in (0xDA, 0xD9):
                break
        if m == 0xD9:
            break
        if not comps:
            raise ValueError('JPEG: a scan before the frame header')
        if 'planes' not in frame:
            hmax = max(c['h'] for c in comps)
            vmax = max(c['v'] for c in comps)
            for c in comps:
                hr, vr = hmax // c['h'], vmax // c['v']
                if hr * c['h'] != hmax or vr * c['v'] != vmax or hr > 2 or vr > hr:
                    raise NotImplementedError('only 4:4:4, 4:2:2 and 4:2:0 JPEG sampling is read')
            frame.update(hmax=hmax, vmax=vmax, mcux=-(-frame['w'] // (8 * hmax)),
                         mcuy=-(-frame['h'] // (8 * vmax)), planes=[])
            for c in comps:
                c['dw'] = -(-frame['w'] * c['h'] // hmax)
                c['dh'] = -(-frame['h'] * c['v'] // vmax)
                c['wib'] = -(-frame['w'] * c['h'] // (8 * hmax))
                c['hib'] = -(-frame['h'] * c['v'] // (8 * vmax))
                c['coef'] = np.zeros((frame['mcuy'] * c['v'], frame['mcux'] * c['h'], 64),
                                     np.int64)
        ns = data[a]
        scan = []
        for i in range(ns):
            cid, tables = data[a + 1 + 2 * i], data[a + 2 + 2 * i]
            c = next(c for c in comps if c['id'] == cid)
            scan.append((c, dc_t[tables >> 4], ac_t[tables & 15]))
        reader = _BitReader(data, a + 1 + 2 * ns + 3)
        if ns == 1:
            c = scan[0][0]
            units = [[(scan[0], by, bx)] for by in range(c['hib']) for bx in range(c['wib'])]
        else:
            units = [[(s, my * s[0]['v'] + yy, mx * s[0]['h'] + xx) for s in scan
                      for yy in range(s[0]['v']) for xx in range(s[0]['h'])]
                     for my in range(frame['mcuy']) for mx in range(frame['mcux'])]
        last = {id(s[0]): 0 for s in scan}
        for u, unit in enumerate(units):
            if restart and u and u % restart == 0:
                reader.restart()
                last = dict.fromkeys(last, 0)
            for (c, dct, act), by, bx in unit:
                blk = np.zeros(64, np.int64)
                s = reader.decode(dct)
                last[id(c)] += _extend(reader.bits(s), s)
                blk[0] = ((last[id(c)] + 32768) & 0xFFFF) - 32768     # a JCOEF (int16)
                k = 1
                while k < 64:
                    rs = reader.decode(act)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        blk[_ZIGZAG[k]] = _extend(reader.bits(s), s)
                    elif r != 15:
                        break
                    else:
                        k += 15
                    k += 1
                c['coef'][by, bx] = blk
        # on to the next marker after the entropy-coded data
        pos = reader.pos
        while pos + 1 < len(data) and not (data[pos] == 0xFF and data[pos + 1] != 0
                                            and not 0xD0 <= data[pos + 1] <= 0xD7):
            pos += 1

    h, w = frame['h'], frame['w']
    channels = []
    for c in comps:
        by, bx = c['coef'].shape[:2]
        px = _idct_islow(c['coef'].reshape(-1, 64), qt[c['tq']]).reshape(by, bx, 8, 8)
        plane = px.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)[:c['dh'], :c['dw']]
        channels.append(_upsample_plain(plane.astype(np.int64), frame['hmax'] // c['h'],
                                        frame['vmax'] // c['v'])[:h, :w])
    if len(channels) == 1:
        return channels[0].astype(np.uint8)
    rgb = (adobe == 0) if (not jfif and adobe is not None) else (
        not jfif and [c['id'] for c in comps] == [82, 71, 66])
    if rgb:
        return np.stack(channels, -1).astype(np.uint8)
    y, cb, cr = channels
    x = np.arange(256, dtype=np.int64) - 128
    cr_r, cb_b = (91881 * x + 32768) >> 16, (116130 * x + 32768) >> 16
    cr_g, cb_g = -46802 * x, -22554 * x + 32768
    out = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], -1)
    return np.clip(out, 0, 255).astype(np.uint8)


def _upsample_plain(p: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """jdsample.c's fancy upsampling (h2v1, h2v2) of a downsampled plane,
    edges clamped; replication for a plane at most 2 wide."""
    dh, dw = p.shape
    if hr == 1:
        return p
    if dw <= 2:
        return np.repeat(np.repeat(p, vr, 0), hr, 1)
    xs = np.arange(dw)
    out = np.empty((vr * dh, 2 * dw), np.int64)
    if vr == 1:
        out[:, 0::2] = (3 * p + p[:, np.maximum(xs - 1, 0)] + 1) >> 2
        out[:, 1::2] = (3 * p + p[:, np.minimum(xs + 1, dw - 1)] + 2) >> 2
        return out
    rows = np.arange(dh)
    for rows_out, other in ((slice(0, None, 2), p[np.maximum(rows - 1, 0)]),
                            (slice(1, None, 2), p[np.minimum(rows + 1, dh - 1)])):
        cs = 3 * p + other
        cl, cr = cs[:, np.maximum(xs - 1, 0)], cs[:, np.minimum(xs + 1, dw - 1)]
        out[rows_out, 0::2] = (3 * cs + cl + 8) >> 4
        out[rows_out, 1::2] = (3 * cs + cr + 7) >> 4
    return out


def unfilter_plain(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The PNG row filters undone in Python (``png_unfilter``)."""
    rows = raw.reshape(h, stride + 1).astype(np.int64)
    out = np.zeros((h, stride), np.int64)
    for y in range(h):
        f, src = rows[y, 0], rows[y, 1:]
        prev = out[y - 1] if y else np.zeros(stride, np.int64)
        if f == 0:
            out[y] = src
        elif f == 2:
            out[y] = (src + prev) & 255
        elif f in (1, 3, 4):
            for i in range(stride):
                a = out[y, i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                out[y, i] = (src[i] + pred) & 255
        else:
            raise ValueError(f'unknown PNG filter type in row {y}')
    return out.astype(np.uint8)


def decode_png_plain(data: bytes) -> Tuple[np.ndarray, str]:
    """``decode_png`` with the rows unfiltered in Python."""
    h, w, ch, mode, raw = _png_parse(data, 'PNG')
    return _png_array(unfilter_plain(raw, h, w * ch, ch).reshape(h, w, ch), ch), mode


def _coefficients(in_size: int, out_size: int, filter: str):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc: (xmin (n,),
    count (n,), int coefficients (n, ksize))."""
    support = 2.0 if filter == 'bicubic' else 1.0
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support *= filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale

    def fn(x):
        x = abs(x)
        if filter == 'bilinear':
            return 1.0 - x if x < 1.0 else 0.0
        a = -0.5
        if x < 1.0:
            return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
        if x < 2.0:
            return (((x - 5) * x + 8) * x - 4) * a
        return 0.0

    xmins, counts, kk = [], [], np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = 0.0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:                                     # in order, as the C loop adds
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        for x, w in enumerate(k):
            kk[xx, x] = int(-0.5 + w * (1 << 22)) if w < 0 else int(0.5 + w * (1 << 22))
        xmins.append(xmin)
        counts.append(xmax)
    return np.array(xmins), np.array(counts), kk


def _convolve_plain(a: np.ndarray, out_size: int, filter: str, axis: int) -> np.ndarray:
    """One pass of ImagingResampleHorizontal / Vertical_8bpc along ``axis``."""
    xmin, _, kk = _coefficients(a.shape[axis], out_size, filter)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1])[None], a.shape[axis] - 1)
    g = np.take(a.astype(np.int64), idx, axis=axis)       # (..., n, ksize, ...)
    shape = [1] * g.ndim
    shape[axis], shape[axis + 1] = kk.shape
    ss = (1 << 21) + (g * kk.reshape(shape)).sum(axis + 1)
    return np.where(ss >= 1 << 30, 255, np.where(ss <= 0, 0, ss >> 22)).astype(np.uint8)


def resample_plain(arr: np.ndarray, size: Tuple[int, int], filter: str = 'bicubic'
                   ) -> np.ndarray:
    """``resample`` in numpy."""
    arr = _check_image(arr)
    ow, oh = (int(s) for s in size)
    ih, iw = arr.shape[:2]
    if filter == 'nearest':
        def table(n_in, n_out):
            a = float(np.float32(n_in)) / n_out
            xo = np.cumsum(np.concatenate([[0.0 + a * 0.5], np.full(n_out - 1, a)]))
            t = np.where(xo < 0, -1, xo.astype(np.int64))
            return np.where((t >= 0) & (t < n_in), t, -1)
        ys, xs = table(ih, oh), table(iw, ow)
        out = arr[np.maximum(ys, 0)][:, np.maximum(xs, 0)]
        valid = (ys[:, None] >= 0) & (xs[None, :] >= 0)
        return np.where(valid if arr.ndim == 2 else valid[..., None], out, 0).astype(np.uint8)
    if (ow, oh) == (iw, ih):
        return arr.copy()
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    a = arr.astype(np.int64)
    if ch in (2, 4):                                    # RGBa / La
        alpha = a[..., -1:]
        t = a[..., :-1] * alpha + 128
        a = np.concatenate([((t >> 8) + t) >> 8, alpha], -1)
    a = a.astype(np.uint8)
    if ow != iw:
        a = _convolve_plain(a, ow, filter, 1)
    if oh != ih:
        a = _convolve_plain(a, oh, filter, 0)
    if ch in (2, 4):
        alpha = a[..., -1:].astype(np.int64)
        color = a[..., :-1].astype(np.int64)
        un = np.minimum(255 * color // np.maximum(alpha, 1), 255)
        color = np.where((alpha == 0) | (alpha == 255), color, un)
        a = np.concatenate([color, alpha], -1).astype(np.uint8)
    return a
