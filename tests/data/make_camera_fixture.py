"""Writes camera_1600x900.jpg and camera_1600x900.json beside this file.

The JPEG is a synthetic street scene (sky, road, lane markings, textured
boxes, seeded noise) at nuScenes' camera size, saved by Pillow (over
libjpeg-turbo) as baseline 4:2:0 at quality 85. The JSON holds the shape
and SHA-256 of Pillow's decode of it, and of Pillow's bilinear resize to
480x270 cropped to rows 46:270 (the nuScenes RESIZE_SCALE 0.3 and
TOP_CROP 46), so that a machine without Pillow can hold the port's image
I/O to Pillow's result. Run from the repository root with Pillow:

    python tests/data/make_camera_fixture.py
"""
import hashlib
import io
import json
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))


def scene(h: int = 900, w: int = 1600, seed: int = 0) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w, 3))
    sky = y < 420
    img[..., 0] = np.where(sky, 120 + 60 * (y / 420), 90 + 40 * ((y - 420) / 480))
    img[..., 1] = np.where(sky, 150 + 50 * (y / 420), 90 + 30 * ((y - 420) / 480))
    img[..., 2] = np.where(sky, 200 + 40 * (y / 420), 95 + 25 * ((y - 420) / 480))
    for x0 in (200, 800, 1400):                       # lanes to a vanishing point
        xl = 800 + (x0 - 800) * (y - 420) / 480
        img[(~sky) & (np.abs(x - xl) < 3 + 10 * (y - 420) / 480)] = [235, 235, 220]
    for _ in range(40):                               # buildings and cars
        x0, y0 = rng.randint(0, w - 60), rng.randint(150, 700)
        bw, bh = rng.randint(30, 260), rng.randint(20, 200)
        col = rng.randint(20, 240, 3)
        tex = 12 * np.sin(x[y0:y0 + bh, x0:x0 + bw] / rng.uniform(2, 9))[..., None]
        img[y0:y0 + bh, x0:x0 + bw] = col + tex
    img += rng.randn(h, w, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main():
    buf = io.BytesIO()
    Image.fromarray(scene()).save(buf, format='JPEG', quality=85, subsampling=2)
    data = buf.getvalue()
    with open(os.path.join(HERE, 'camera_1600x900.jpg'), 'wb') as f:
        f.write(data)
    dec = np.asarray(Image.open(io.BytesIO(data)))
    rs = np.asarray(Image.open(io.BytesIO(data)).resize((480, 270), Image.BILINEAR)
                    .crop((0, 46, 480, 270)))
    meta = {'file': 'camera_1600x900.jpg',
            'decode': {'shape': list(dec.shape), 'sha256': sha(dec)},
            'resize_bilinear_480x270_crop_0_46_480_270': {'shape': list(rs.shape),
                                                          'sha256': sha(rs)}}
    with open(os.path.join(HERE, 'camera_1600x900.json'), 'w') as f:
        json.dump(meta, f, indent=1)


if __name__ == '__main__':
    main()
