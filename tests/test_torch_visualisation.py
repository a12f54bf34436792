"""The port's visualisation (stp3_tpu_torch/utils/visualisation.py) against
the JAX package's, on the CPU: seeded numpy labels and outputs through
both, equal uint8 arrays (every panel is integer-valued, so equal means
bit for bit); the port's jet table against matplotlib's bit for bit; the
evaluation figures saved by both read back equal. The port's panels take
tensors too (the trainer's outputs), and import no matplotlib."""
import os
import subprocess
import sys

import matplotlib
import matplotlib.image
import numpy as np
import pytest
import torch

import chip_smoke
from stp3_tpu.config import get_cfg as jax_get_cfg
from stp3_tpu.utils import visualisation as JV
from stp3_tpu_torch.utils import visualisation as V

B, S, H, W = 1, 3, 24, 20


def _cfg():
    return chip_smoke.planning_cfg(tiny=True)


def _data(seed: int, cameras: int = 2):
    """Labels, outputs and a batch with every panel's key, channels-last."""
    rng = np.random.RandomState(seed)
    labels = {'segmentation': rng.randint(0, 2, (B, S, H, W)),
              'pedestrian': rng.randint(0, 2, (B, S, H, W)),
              'instance': rng.randint(0, 4, (B, S, H, W)),
              'centerness': rng.rand(B, S, H, W, 1).astype(np.float32),
              'offset': rng.randn(B, S, H, W, 2).astype(np.float32),
              'flow': rng.randn(B, S, H, W, 2).astype(np.float32),
              'hdmap': rng.randint(0, 2, (B, H, W, 2)),
              'gt_trajectory': np.cumsum(rng.rand(B, 4, 3), 1).astype(np.float32)}
    output = {'segmentation': rng.randn(B, S, H, W, 2).astype(np.float32),
              'pedestrian': rng.randn(B, S, H, W, 2).astype(np.float32),
              'instance_center': rng.rand(B, S, H, W, 1).astype(np.float32),
              'instance_offset': 3 * rng.randn(B, S, H, W, 2).astype(np.float32),
              'instance_flow': rng.randn(B, S, H, W, 2).astype(np.float32),
              'hdmap': rng.randn(B, H, W, 4).astype(np.float32),
              'final_traj': np.cumsum(rng.rand(B, 3, 3), 1).astype(np.float32)}
    batch = {'image': rng.randn(B, 2, cameras, 32, 64, 3).astype(np.float32)}
    return labels, output, batch


def test_jet_table_is_matplotlibs():
    want = matplotlib.colormaps['jet'](np.arange(256))
    assert np.array_equal(V.jet_table(), want)


def test_heatmap_image_equals_jax():
    x = np.random.RandomState(0).uniform(-0.2, 1.2, (33, 31)).astype(np.float32)
    x[0, :5] = [0.0, 1.0, np.nan, 1 / 256, 255 / 256]
    assert np.array_equal(V.heatmap_image(x), JV.heatmap_image(x))
    assert np.array_equal(V.heatmap_image(torch.from_numpy(x)), JV.heatmap_image(x))


@pytest.mark.parametrize('max_flow', [None, 0.5])
def test_flow_and_instances_equal_jax(max_flow):
    labels, _, _ = _data(1)
    flow = labels['flow'][0, 0]
    assert np.array_equal(V.flow_to_image(flow, max_flow), JV.flow_to_image(flow, max_flow))
    inst = labels['instance'][0, 1]
    assert np.array_equal(V.colourise_instances(inst), JV.colourise_instances(inst))
    assert np.array_equal(V.instance_colours(9), JV.instance_colours(9))
    assert np.array_equal(V.make_contour(V.colourise_instances(inst), (1, 2, 3), True),
                          JV.make_contour(JV.colourise_instances(inst), (1, 2, 3), True))


def test_plot_planning_bev_equals_jax():
    labels, output, _ = _data(2)
    cfg, jcfg = _cfg(), jax_get_cfg(cfg_dict=_cfg().convert_to_dict())
    got = V.plot_planning_bev(labels['hdmap'][0], output['final_traj'][0], cfg)
    assert np.array_equal(got, JV.plot_planning_bev(labels['hdmap'][0],
                                                     output['final_traj'][0], jcfg))
    assert (got == np.array([118, 185, 0])).all(-1).any()


@pytest.mark.parametrize('with_cfg', [True, False], ids=['cfg', 'no-cfg'])
def test_visualise_output_equals_jax(with_cfg):
    labels, output, _ = _data(3)
    cfg = _cfg() if with_cfg else None
    jcfg = jax_get_cfg(cfg_dict=cfg.convert_to_dict()) if with_cfg else None
    want = JV.visualise_output(labels, output, jcfg)
    got = V.visualise_output({k: torch.from_numpy(v) for k, v in labels.items()},
                             {k: torch.from_numpy(v) for k, v in output.items()}, cfg)
    assert got.shape == (S, 7 * H, 2 * W, 3) and got.dtype == np.uint8
    assert np.array_equal(got, want)


def test_denormalise_image_equals_jax():
    _, _, batch = _data(4)
    img = batch['image'][0, 0, 0]
    assert np.array_equal(V.denormalise_image(img), JV.denormalise_image(img))
    raw = (np.random.RandomState(4).rand(8, 8, 3) * 255).astype(np.uint8)
    assert np.array_equal(V.denormalise_image(raw), JV.denormalise_image(raw))


@pytest.mark.parametrize('cameras', [2, 6])
def test_save_eval_figure_equals_jax(tmp_path, cameras):
    labels, output, batch = _data(5, cameras)
    cfg = _cfg()
    cfg.IMAGE.NAMES = [f'CAM_{i}' for i in range(cameras)]
    jcfg = jax_get_cfg(cfg_dict=cfg.convert_to_dict())
    (tmp_path / 'port').mkdir()
    (tmp_path / 'jax').mkdir()
    got = V.save_eval_figure(output, labels, batch, 2, 7, str(tmp_path / 'port'), cfg)
    want = JV.save_eval_figure(output, labels, batch, 2, 7, str(tmp_path / 'jax'), jcfg)
    assert got.endswith('0007.png')
    assert np.array_equal(matplotlib.image.imread(got), matplotlib.image.imread(want))


def test_save_eval_panel_equals_jax(tmp_path, monkeypatch):
    """The JAX module's ``save_eval_panel`` calls ``_seg_rgb``, which it
    never defines (a NameError there); the port's is lent to it here."""
    monkeypatch.setattr(JV, '_seg_rgb', V._seg_rgb, raising=False)
    labels, output, _ = _data(6)
    cfg = _cfg()
    jcfg = jax_get_cfg(cfg_dict=cfg.convert_to_dict())
    (tmp_path / 'port').mkdir()
    (tmp_path / 'jax').mkdir()
    got = V.save_eval_panel(output, labels, 2, 3, str(tmp_path / 'port'), cfg)
    want = JV.save_eval_panel(output, labels, 2, 3, str(tmp_path / 'jax'), jcfg)
    assert got.endswith('000003.png')
    assert np.array_equal(matplotlib.image.imread(got), matplotlib.image.imread(want))


def test_panels_import_no_matplotlib():
    """``visualise_output`` in a fresh process leaves matplotlib unimported."""
    code = '\n'.join([
        'import sys', 'import numpy as np', 'import chip_smoke',
        'from stp3_tpu_torch.utils.visualisation import visualise_output',
        'rng = np.random.RandomState(0)',
        "labels = {'segmentation': rng.randint(0, 2, (1, 2, 8, 8)),",
        "          'centerness': rng.rand(1, 2, 8, 8, 1), 'hdmap': rng.randint(0, 2, (1, 8, 8, 2)),",
        "          'gt_trajectory': rng.rand(1, 3, 3)}",
        "output = {'segmentation': rng.randn(1, 2, 8, 8, 2), 'hdmap': rng.randn(1, 8, 8, 4),",
        "          'instance_center': rng.rand(1, 2, 8, 8, 1),",
        "          'instance_offset': rng.randn(1, 2, 8, 8, 2)}",
        'panel = visualise_output(labels, output, chip_smoke.planning_cfg(tiny=True))',
        'assert panel.shape == (2, 56, 16, 3), panel.shape',
        "assert not [m for m in sys.modules if m.split('.')[0] == 'matplotlib']"])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                          cwd=root, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
