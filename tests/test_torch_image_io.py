"""The port's image I/O (utils/image_io.py on csrc/image_codec.c, built
with the host's C compiler) and its OpenCV stand-ins (utils/resample.py)
against the libraries the JAX package's datasets call, on the CPU.

Tolerances:
  * JPEG: the C decoder and the numpy plain decoder equal Pillow's decode
    (libjpeg-turbo, ISLOW IDCT, fancy upsampling) exactly, 0 levels and 0
    pixels apart, on Pillow-written files: 4:4:4, 4:2:2, 4:2:0 and
    grayscale, with and without restart intervals, optimised Huffman
    tables, random noise and smooth content, odd sizes;
  * PNG: ``read_png`` equals ``np.asarray(PIL.Image.open(path))`` exactly
    (shape, dtype and values) for 'L', 'P', 'LA', 'RGB' and 'RGBA', from
    Pillow's writer and from tests/torch_fake_datasets.py's (every filter
    type);
  * resample: C == numpy == ``PIL.Image.resize`` exactly for nearest,
    bilinear and bicubic over scales 0.25-1.5 and odd sizes, RGBA and LA
    premultiplied as Pillow does; NEAREST on every width pair 100-400;
  * ``fill_poly`` == ``cv2.fillPoly`` exactly on 1,200 random rotated
    boxes and polygons inside a 200x200 grid and across its edges;
  * ``resize_linear_float`` within 1e-5 absolute of ``cv2.resize``
    (INTER_LINEAR, float32), and 0 values that round to another integer;
  * the refused JPEG processes, 12-bit samples, other sampling factors,
    16-bit and interlaced PNGs raise NotImplementedError naming what they
    are.
"""
import hashlib
import io

import cv2
import numpy as np
import pytest
from PIL import Image

import torch_fake_datasets as fake
from stp3_tpu_torch.utils import image_io
from stp3_tpu_torch.utils.resample import fill_poly, resize_linear_float


def _jpeg(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='JPEG', **kw)
    return buf.getvalue()


def _smooth(h, w):
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([128 + 100 * np.sin(x / 7.0 + y / 11.0), 128 + 90 * np.cos(y / 5.0),
                     x * 255.0 / w], -1).astype(np.uint8)


RNG = np.random.RandomState(0)
CONTENT = {'noise': RNG.randint(0, 256, (67, 93, 3), np.uint8),
           'smooth': _smooth(70, 101),
           'noise_mcu': RNG.randint(0, 256, (48, 64, 3), np.uint8)}
SAVE = {'default': {}, 'restarts': {'restart_marker_blocks': 3}, 'q95': {'quality': 95},
        'optimized': {'optimize': True}}


@pytest.mark.parametrize('save', sorted(SAVE))
@pytest.mark.parametrize('sampling', [0, 1, 2], ids=['444', '422', '420'])
@pytest.mark.parametrize('content', sorted(CONTENT))
def test_jpeg_decoders_equal_pillow(content, sampling, save):
    data = _jpeg(CONTENT[content], subsampling=sampling, **SAVE[save])
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = image_io.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if content != 'smooth' or save == 'default':       # the slow plain decoder on a few
        np.testing.assert_array_equal(image_io.decode_jpeg_plain(data), want)


@pytest.mark.parametrize('restarts', [False, True])
def test_grayscale_jpeg_equals_pillow(restarts, tmp_path):
    gray = RNG.randint(0, 256, (45, 77), np.uint8)
    path = tmp_path / 'g.jpg'
    Image.fromarray(gray).save(path, **({'restart_marker_rows': 1} if restarts else {}))
    want = np.asarray(Image.open(path))
    got = image_io.read_jpeg(path)
    assert got.shape == want.shape == (45, 77)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image_io.decode_jpeg_plain(path.read_bytes()), want)


def test_camera_fixture_equals_pillow_and_its_stored_hashes():
    """The committed 1600x900 fixture: the C decode equals Pillow's here and
    the SHA-256 stored beside it, and so does the resize + crop of the
    nuScenes dataset (the numbers chip_smoke.py checks without Pillow)."""
    meta = fake.camera_meta()
    want = np.asarray(Image.open(fake.CAMERA_JPEG))
    got = image_io.read_jpeg(fake.CAMERA_JPEG)
    np.testing.assert_array_equal(got, want)
    assert list(got.shape) == meta['decode']['shape']
    assert hashlib.sha256(got.tobytes()).hexdigest() == meta['decode']['sha256']
    from stp3_tpu_torch.datas.nuscenes_data import resize_and_crop_image
    rs = resize_and_crop_image(got, (480, 270), (0, 46, 480, 270))
    key = 'resize_bilinear_480x270_crop_0_46_480_270'
    assert hashlib.sha256(rs.tobytes()).hexdigest() == meta[key]['sha256']


def _patched(data: bytes, marker: int) -> bytes:
    """The JPEG with its SOF0 marker turned into ``marker``."""
    i = data.index(b'\xff\xc0')
    return data[:i + 1] + bytes([marker]) + data[i + 2:]


@pytest.mark.parametrize('marker,name', [(0xC2, 'SOF2'), (0xC3, 'SOF3'), (0xC9, 'SOF9'),
                                         (0xCA, 'SOF10')])
def test_refused_jpeg_processes_raise(marker, name):
    data = _patched(_jpeg(CONTENT['noise_mcu']), marker)
    with pytest.raises(NotImplementedError, match=name):
        image_io.decode_jpeg(data)
    with pytest.raises(NotImplementedError, match=name):
        image_io.decode_jpeg_plain(data)


def test_other_sampling_factors_raise():
    """4:4:0 (chroma at half height, full width): the luma's sampling byte
    of a 4:4:4 file set to h1 v2."""
    data = bytearray(_jpeg(CONTENT['noise_mcu'], subsampling=0))
    i = data.index(b'\xff\xc0')
    data[i + 11] = 0x12
    for decode in (image_io.decode_jpeg, image_io.decode_jpeg_plain):
        with pytest.raises(NotImplementedError, match='sampling'):
            decode(bytes(data))


def test_progressive_and_12_bit_jpegs_raise():
    with pytest.raises(NotImplementedError, match='SOF2'):
        image_io.decode_jpeg(_jpeg(CONTENT['noise_mcu'], progressive=True))
    data = bytearray(_jpeg(CONTENT['noise_mcu']))
    i = data.index(b'\xff\xc0')
    data[i + 4] = 12                                   # the frame's sample precision
    with pytest.raises(NotImplementedError, match='8-bit'):
        image_io.decode_jpeg(bytes(data))


def _pil_png(tmp_path, arr, mode, name):
    path = tmp_path / f'{name}.png'
    im = Image.fromarray(arr, mode)
    if mode == 'P':
        im.putpalette(list(RNG.randint(0, 256, 768)))
    im.save(path)
    return path


PNG_SHAPES = {'L': (37, 53), 'P': (37, 53), 'LA': (37, 53, 2), 'RGB': (37, 53, 3),
              'RGBA': (37, 53, 4)}


@pytest.mark.parametrize('mode', sorted(PNG_SHAPES))
def test_read_png_equals_pillow(mode, tmp_path):
    """Pillow's writer (adaptive row filters) and the stand-in writer
    (row y with filter y % 5) alike."""
    rng = np.random.RandomState(1)
    smooth = (np.add.outer(np.arange(37), np.arange(53)) * 3 % 256).astype(np.uint8)
    for i, arr in enumerate((rng.randint(0, 256, PNG_SHAPES[mode], np.uint8),
                             np.broadcast_to(smooth.reshape(37, 53, *[1] * (
                                 len(PNG_SHAPES[mode]) - 2)), PNG_SHAPES[mode]))):
        for path in (_pil_png(tmp_path, np.ascontiguousarray(arr), mode, f'pil{i}'),
                     tmp_path / f'ours{i}.png'):
            if path.name.startswith('ours'):
                fake.write_png(str(path), arr, mode, RNG.randint(0, 256, (256, 3)))
            want = np.asarray(Image.open(path))
            got = image_io.read_png(path)
            assert got.dtype == want.dtype and got.shape == want.shape, (got.shape, want.shape)
            np.testing.assert_array_equal(got, want)
            got_plain, got_mode = image_io.decode_png_plain(path.read_bytes())
            assert got_mode == Image.open(path).mode == mode
            np.testing.assert_array_equal(got_plain, want)


def test_refused_pngs_raise(tmp_path):
    path = tmp_path / 'i16.png'
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(path)
    with pytest.raises(NotImplementedError, match='bit depth 16'):
        image_io.read_png(path)
    path = tmp_path / 'adam7.png'
    data = bytearray(fake.png_bytes(np.zeros((4, 4), np.uint8), 'L'))
    data[28] = 1                                       # IHDR's interlace byte
    path.write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match='interlaced'):
        image_io.read_png(path)


RESAMPLE_SHAPES = {'L': (37, 53), 'RGB': (37, 53, 3), 'RGBA': (37, 53, 4), 'LA': (37, 53, 2)}
PIL_FILTERS = {'nearest': Image.NEAREST, 'bilinear': Image.BILINEAR, 'bicubic': Image.BICUBIC}


@pytest.mark.parametrize('mode', sorted(RESAMPLE_SHAPES))
@pytest.mark.parametrize('filt', sorted(PIL_FILTERS))
def test_resample_equals_pillow(mode, filt):
    rng = np.random.RandomState(2)
    arr = rng.randint(0, 256, RESAMPLE_SHAPES[mode], np.uint8)
    if mode in ('RGBA', 'LA'):
        arr[..., -1] = rng.choice([0, 255, 3, 128, 77], arr.shape[:2])
    im = Image.fromarray(arr, mode)
    for scale in (0.25, 0.3, 0.5, 0.77, 1.0, 1.1, 1.5):
        size = (max(1, int(53 * scale)), int(37 * scale) + 1)
        want = np.asarray(im.resize(size, PIL_FILTERS[filt]))
        np.testing.assert_array_equal(image_io.resample(arr, size, filt), want, err_msg=scale)
        np.testing.assert_array_equal(image_io.resample_plain(arr, size, filt), want,
                                      err_msg=scale)


def test_nearest_equals_pillow_on_every_width_pair():
    """NEAREST's source index of every output pixel, for each in / out
    width from 100 to 400 (the index encoded in two channels); a height
    follows the same table."""
    mismatched = []
    for iw in range(100, 401):
        row = np.zeros((1, iw, 3), np.uint8)
        row[0, :, 0], row[0, :, 1] = np.arange(iw) & 255, np.arange(iw) >> 8
        im = Image.fromarray(row)
        for ow in range(100, 401, 3):
            if not np.array_equal(image_io.resample(row, (ow, 1), 'nearest'),
                                  np.asarray(im.resize((ow, 1), Image.NEAREST))):
                mismatched.append((iw, ow))
    assert not mismatched, mismatched[:10]


def _boxes(n, rng):
    """Rotated boxes with rounded int32 corners (the nuScenes labels'
    polygons), every third a random polygon, around a 200x200 grid."""
    for i in range(n):
        if i % 3 == 0:
            yield rng.randint(-30, 230, (rng.randint(3, 8), 2)).astype(np.int32)
            continue
        cx, cy = rng.uniform(-20, 220, 2)
        length, width, th = rng.uniform(0.5, 30), rng.uniform(0.5, 12), rng.uniform(0, 2 * np.pi)
        c, s = np.cos(th), np.sin(th)
        corners = (np.array([[length, width], [length, -width], [-length, -width],
                             [-length, width]]) / 2 @ np.array([[c, s], [-s, c]]) + [cx, cy])
        yield np.round(corners).astype(np.int32)


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_fill_poly_equals_cv2(seed):
    rng = np.random.RandomState(seed)
    for pts in _boxes(300, rng):
        want = np.zeros((200, 200))
        cv2.fillPoly(want, [pts], 7.0)
        got = fill_poly(np.zeros((200, 200)), pts, 7.0)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


@pytest.mark.parametrize('shape,size', [((900, 1600), (480, 270)), ((128, 224), (112, 64)),
                                        ((37, 53), (31, 20)), ((20, 30), (77, 41))])
def test_resize_linear_float_matches_cv2(shape, size):
    rng = np.random.RandomState(3)
    src = (rng.rand(*shape) * 50).astype(np.float32)
    src[rng.rand(*shape) < 0.9] = 0                     # sparse, as a lidar depth map
    want = cv2.resize(src, size, interpolation=cv2.INTER_LINEAR)
    got = resize_linear_float(src, size)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert int((np.round(got) != np.round(want)).sum()) == 0
