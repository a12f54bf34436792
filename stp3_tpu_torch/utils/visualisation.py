"""Visualisation: BEV panels, optical-flow colouring, planning plots (port
of stp3_tpu/utils/visualisation.py; reference stp3/utils/visualisation.py:
flow colorwheel :13-164, ``visualise_output`` video panels :208-322,
``plot_planning`` :331-379, instance palette :381-460). Host-side, for
evaluation and debugging.

The panels are numpy only: ``heatmap_image`` colours through a 256-entry
jet table built here from matplotlib's segment data with matplotlib's
indexing, so ``visualise_output`` needs no matplotlib (the card's machine
has none). Only the figures (``plot_planning`` on a caller's axes,
``save_eval_figure``, ``save_eval_panel``) need it, imported when called.
Inputs may be numpy arrays or tensors on any device.
"""
from __future__ import annotations

import colorsys
import os
from typing import Dict, Optional

import numpy as np

from stp3_tpu_torch.ops.geometry import ego_footprint_grid_pts, gen_dx_bx
from stp3_tpu_torch.utils.device import as_numpy
from stp3_tpu_torch.utils.instance import predict_instance_segmentation_and_trajectories
from stp3_tpu_torch.utils.network import denormalise_image as denormalise_float
from stp3_tpu_torch.utils.rasterize import polygon


# --------------------------------------------------------------------------
# Optical-flow colorwheel (Baker et al. convention, as in the reference)
# --------------------------------------------------------------------------
def _make_colorwheel() -> np.ndarray:
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:col + mr, 0] = 255
    return wheel


_COLORWHEEL = _make_colorwheel()


def flow_to_image(flow: np.ndarray, max_flow: Optional[float] = None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 colour image."""
    flow = as_numpy(flow)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    if max_flow is None:
        max_flow = max(np.max(rad), 1e-6)
    u, v = u / max_flow, v / max_flow
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    ncols = _COLORWHEEL.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for i in range(3):
        col = (1 - f) * (_COLORWHEEL[k0, i] / 255.0) + f * (_COLORWHEEL[k1, i] / 255.0)
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., i] = np.floor(255 * col)
    return img


# --------------------------------------------------------------------------
# Instance palette (stable, distinct colours per id)
# --------------------------------------------------------------------------
def instance_colours(n: int, seed: int = 0) -> np.ndarray:
    """Deterministic distinct palette: golden-ratio hue stepping with
    alternating saturation / value bands (the reference ships a fixed
    70-colour Kelly table, visualisation.py:381-460). Id 0 (background)
    stays black."""
    n = max(n, 1)
    colours = np.zeros((n, 3), np.uint8)
    for i in range(1, n):
        hue = (i * 0.61803398875) % 1.0
        sat = (0.95, 0.6)[i % 2]
        val = (0.95, 0.7)[(i // 2) % 2]
        colours[i] = [int(255 * c) for c in colorsys.hsv_to_rgb(hue, sat, val)]
    return colours


def colourise_instances(instance_map: np.ndarray) -> np.ndarray:
    """(H, W) int -> (H, W, 3) uint8 on a white background (reference
    plot_instance_map, visualisation.py:188-206)."""
    instance_map = as_numpy(instance_map)
    palette = instance_colours(int(instance_map.max()) + 2)
    img = np.full(instance_map.shape + (3,), 255, np.uint8)
    fg = instance_map > 0
    img[fg] = palette[instance_map[fg]]
    return img


# --------------------------------------------------------------------------
# Panels
# --------------------------------------------------------------------------
_SEMANTIC_COLOURS = np.array([[255, 255, 255], [0, 0, 0]], np.uint8)

# matplotlib's 'jet' segment data (matplotlib/_cm.py): per channel rows of
# (x, y below x, y above x)
_JET_SEGMENTS = (
    ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0), (1.0, 0, 0)),
    ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
)


def _segment_table(data, n: int) -> np.ndarray:
    """One channel of an n-entry table, sampled as matplotlib's
    ``_create_lookup_table`` (gamma 1) samples it."""
    a = np.array(data, dtype=float)
    x = a[:, 0] * (n - 1)
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    table = np.concatenate([[a[0, 2]], distance * (a[ind, 1] - a[ind - 1, 2]) + a[ind - 1, 2],
                            [a[-1, 1]]])
    return np.clip(table, 0.0, 1.0)


def jet_table(n: int = 256) -> np.ndarray:
    """(n, 4) float64 RGBA: ``matplotlib.cm.jet``'s lookup table."""
    table = np.ones((n, 4))
    for ch, data in enumerate(_JET_SEGMENTS):
        table[:, ch] = _segment_table(data, n)
    return table


_JET_BYTES = (jet_table()[:, :3] * 255).astype(np.uint8)


def make_contour(img: np.ndarray, colour=(0, 0, 0), double_line: bool = False) -> np.ndarray:
    """Draw a 1-px (or 2-px) border (reference visualisation.py:167-185)."""
    out = img.copy()
    k = 2 if double_line else 1
    out[:k, :] = colour
    out[-k:, :] = colour
    out[:, :k] = colour
    out[:, -k:] = colour
    return out


def heatmap_image(image: np.ndarray) -> np.ndarray:
    """(H, W) in [0, 1] -> jet-coloured (H, W, 3) uint8 (reference
    heatmap_image :68-80), as ``matplotlib.cm.jet`` colours it: the value
    clipped, times 256 in float32, truncated (1 -> the last entry); NaN
    black."""
    x = np.clip(np.asarray(as_numpy(image), np.float32), 0.0, 1.0)
    bad = np.isnan(x)
    idx = np.minimum((np.where(bad, 0, x) * 256).astype(np.int64), 255)
    out = _JET_BYTES[idx]
    out[bad] = 0
    return out


def _draw_polyline(img: np.ndarray, rows: np.ndarray, cols: np.ndarray, colour,
                   thickness: int = 1) -> None:
    """Rasterize a polyline in place (dense interpolation between points)."""
    h, w = img.shape[:2]
    rows = np.asarray(rows, np.float64)
    cols = np.asarray(cols, np.float64)
    for i in range(len(rows) - 1):
        n = int(max(abs(rows[i + 1] - rows[i]), abs(cols[i + 1] - cols[i])) * 2 + 2)
        rr = np.linspace(rows[i], rows[i + 1], n)
        cc = np.linspace(cols[i], cols[i + 1], n)
        for dr in range(-thickness + 1, thickness):
            for dc in range(-thickness + 1, thickness):
                r = np.clip(np.round(rr + dr).astype(int), 0, h - 1)
                c = np.clip(np.round(cc + dc).astype(int), 0, w - 1)
                img[r, c] = colour


def plot_planning_bev(hd_map: np.ndarray, traj: np.ndarray, cfg) -> np.ndarray:
    """HD map + ego box + trajectory as an (H, W, 3) uint8 BEV raster
    (reference plot_planning, visualisation.py:331-379, rasterized in
    numpy). hd_map (H, W, 2) binary [lane_divider, drivable_area]; traj
    (T, 2+) metres in the BEV frame."""
    hd_map = as_numpy(hd_map)
    h, w = hd_map.shape[:2]
    dx, bx, _ = gen_dx_bx(cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)
    dx, bx = dx[:2], bx[:2]

    img = np.full((h, w, 3), 255, np.float32)
    # alpha-0.2 map overlay colours (reference :346-355)
    for ch, c in ((0, (255.0, 127.5, 79.0)), (1, (127.5, 61.2, 117.3))):
        img[hd_map[..., ch] > 0] = 0.8 * 255.0 + 0.2 * np.asarray(c)

    # ego footprint, NVIDIA green (reference :360-371)
    pts = ego_footprint_grid_pts(cfg.EGO.WIDTH, cfg.EGO.HEIGHT, bx, dx)
    rr, cc = polygon(pts[:, 1], pts[:, 0], shape=(h, w))
    img[rr, cc] = (118, 185, 0)

    if traj is not None and len(traj):
        g = (as_numpy(traj)[:, :2] - bx) / dx
        _draw_polyline(img, g[:, 1], g[:, 0], (31, 119, 180), thickness=2)

    # the reference displays x reversed and y upward (plt.xlim (w, 0), ylim
    # (0, h)): a flip of both axes of the raster
    return img[::-1, ::-1].astype(np.uint8)


def visualise_output(labels: Dict, output: Dict, cfg) -> np.ndarray:
    """GT-vs-prediction panel video, the reference layout
    (visualisation.py:208-322): per frame two columns (GT | prediction),
    each a stack of [instance ids, future flow, vehicle segmentation,
    centerness, offset, pedestrian, planning (HD map + trajectory)].
    Returns (T, 7H, 2W, 3) uint8. Channels-last inputs; cfg may be None
    (the key-gated panels only)."""
    def get(d, key):
        v = d.get(key)
        return None if v is None else as_numpy(v)

    seg_gt = get(labels, 'segmentation')[0]                           # (S, H, W)
    seg_pred = get(output, 'segmentation').argmax(-1)[0]
    s, h, w = seg_gt.shape
    blank = np.zeros((h, w, 3), np.uint8)

    has_instance = output.get('instance_center') is not None
    consistent = (predict_instance_segmentation_and_trajectories(output)[0]
                  if has_instance else None)

    def seg_panel(seg_t):
        return make_contour(_SEMANTIC_COLOURS[np.asarray(seg_t, int)[::-1, ::-1]])

    def vector_panel(field_t, seg_t):
        """offset / flow coloured where the vehicle mask is on (:242-245)"""
        f = np.array(field_t, np.float32)
        f[np.asarray(seg_t) != 1] = 0
        return make_contour(flow_to_image(f)[::-1, ::-1])

    def planning_panel(hdmap_2ch, traj):
        if cfg is None or hdmap_2ch is None:
            return blank
        return make_contour(plot_planning_bev(hdmap_2ch, traj, cfg))

    gt_hdmap = pred_hdmap = None
    if cfg is not None and 'hdmap' in labels and output.get('hdmap') is not None:
        gt_hdmap = get(labels, 'hdmap')[0]                            # (H, W, n)
        ph = get(output, 'hdmap')[0]                                  # (H, W, 2n)
        pred_hdmap = np.stack([ph[..., 2 * i:2 * i + 2].argmax(-1)
                               for i in range(ph.shape[-1] // 2)], axis=-1)
    gt_traj = get(labels, 'gt_trajectory')
    gt_traj = None if gt_traj is None else gt_traj[0]
    final = get(output, 'final_traj')
    pred_traj = gt_traj if final is None else final[0]
    lab = {k: get(labels, k) for k in ('instance', 'flow', 'centerness', 'offset',
                                        'pedestrian')}
    out = {k: get(output, k) for k in ('instance_flow', 'instance_center', 'instance_offset',
                                        'pedestrian')}

    video = []
    for t in range(s):
        gt_column = [
            (make_contour(colourise_instances(lab['instance'][0, t])[::-1, ::-1])
             if lab['instance'] is not None else blank),
            vector_panel(lab['flow'][0, t], seg_gt[t]) if lab['flow'] is not None else blank,
            seg_panel(seg_gt[t]),
            (make_contour(heatmap_image(lab['centerness'][0, t, :, :, 0])[::-1, ::-1])
             if lab['centerness'] is not None else blank),
            (vector_panel(lab['offset'][0, t], seg_gt[t])
             if lab['offset'] is not None else blank),
            seg_panel(lab['pedestrian'][0, t]) if lab['pedestrian'] is not None else blank,
            planning_panel(gt_hdmap, gt_traj)]
        pred_column = [
            (make_contour(colourise_instances(consistent[t])[::-1, ::-1])
             if consistent is not None else blank),
            (vector_panel(out['instance_flow'][0, t], seg_pred[t])
             if out['instance_flow'] is not None else blank),
            seg_panel(seg_pred[t]),
            (make_contour(heatmap_image(out['instance_center'][0, t, :, :, 0])[::-1, ::-1])
             if has_instance else blank),
            (vector_panel(out['instance_offset'][0, t], seg_pred[t])
             if out['instance_offset'] is not None else blank),
            (seg_panel(out['pedestrian'].argmax(-1)[0, t])
             if out['pedestrian'] is not None else blank),
            planning_panel(pred_hdmap, pred_traj)]
        video.append(np.concatenate([np.concatenate(gt_column, 0),
                                     np.concatenate(pred_column, 0)], 1))  # (7H, 2W, 3)
    return np.stack(video)                                                 # (T, 7H, 2W, 3)


def plot_planning(ax, trajs: np.ndarray, gt_traj: np.ndarray,
                  occupancy: Optional[np.ndarray] = None, bev_extent: float = 50.0):
    """Planning plot on matplotlib axes: the plan red, the GT green
    (reference plot_planning :331-379)."""
    if occupancy is not None:
        ax.imshow(occupancy, extent=[-bev_extent, bev_extent, -bev_extent, bev_extent],
                  origin='lower', cmap='Greys')
    if trajs is not None:
        ax.plot(trajs[:, 0], trajs[:, 1], 'r-o', markersize=2, label='plan')
    ax.plot(gt_traj[:, 0], gt_traj[:, 1], 'g-o', markersize=2, label='GT')
    ax.legend(loc='upper right', fontsize=6)
    ax.set_xlabel('x (m)')
    ax.set_ylabel('y (m)')


def denormalise_image(img: np.ndarray) -> np.ndarray:
    """A channels-last normalised image -> uint8 RGB (reference
    NormalizeInverse + ToPILImage, evaluate.py:178-181); a uint8
    wire-format image passes through."""
    img = as_numpy(img)
    if img.dtype == np.uint8:
        return img
    return (denormalise_float(img) * 255).astype(np.uint8)


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported here: only the
    figures need matplotlib."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def save_eval_figure(output: Dict, labels: Dict, batch: Dict, n_present: int,
                     frame: int, save_path: str, cfg) -> str:
    """The reference evaluation figure (evaluate.py:171-272): a 2x4 grid of
    the six denormalised present-frame camera images (back row mirrored)
    and a combined BEV panel (drivable area, lane, vehicle segmentation,
    pedestrians, ego box, GT trajectory). Fewer than six cameras fill
    fewer panels. Returns the PNG's path."""
    plt = _pyplot()
    import matplotlib.gridspec

    images = as_numpy(batch['image'])                    # (B, S, N, H, W, 3)
    n_cam = images.shape[2]
    cam_names = list(cfg.IMAGE.NAMES)
    img_h, img_w = images.shape[3], images.shape[4]

    val_w = 2.99
    val_h = val_w * (img_h / img_w)
    fig = plt.figure(figsize=(4 * val_w, 2 * val_h))
    gs = matplotlib.gridspec.GridSpec(2, 4, width_ratios=(val_w,) * 4)
    gs.update(wspace=0.0, hspace=0.0, left=0.0, right=1.0, top=1.0, bottom=0.0)

    # camera panels: the first half on the top row, the second half below,
    # mirrored (the reference flips its back cameras, evaluate.py:205-224)
    for i in range(min(n_cam, 6)):
        row, col = (0, i) if i < 3 else (1, i - 3)
        ax = fig.add_subplot(gs[row, col])
        img = denormalise_image(images[0, n_present - 1, i])
        if i >= n_cam // 2 and n_cam > 1:
            img = img[:, ::-1]
        ax.imshow(img)
        name = cam_names[i] if i < len(cam_names) else f'CAM{i}'
        ax.annotate(name.replace('CAM_', '').replace('_', ' '), (0.01, 0.87), c='white',
                    xycoords='axes fraction', fontsize=14)
        ax.axis('off')

    # the combined BEV panel (reference evaluate.py:227-271)
    ax = fig.add_subplot(gs[:, 3])
    seg = as_numpy(output['segmentation'])[0, n_present - 1].argmax(-1)
    h, w = seg.shape
    showing = np.full((h, w, 3), np.array([219, 215, 215]) / 255.0)
    if output.get('hdmap') is not None:
        hd = as_numpy(output['hdmap'])[0]
        if hd.shape[-1] >= 4:
            showing[hd[..., 2:4].argmax(-1) > 0] = np.array([161, 158, 158]) / 255.0
        showing[hd[..., 0:2].argmax(-1) > 0] = np.array([84, 70, 70]) / 255.0
    showing[seg > 0] = np.array([255, 128, 0]) / 255.0
    if output.get('pedestrian') is not None:
        ped = as_numpy(output['pedestrian'])[0, n_present - 1].argmax(-1)
        showing[ped > 0] = np.array([28, 81, 227]) / 255.0
    ax.imshow(make_contour(showing))
    ax.axis('off')

    dx, bx, _ = gen_dx_bx(cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)
    dx, bx = dx[:2], bx[:2]
    pts = ego_footprint_grid_pts(cfg.EGO.WIDTH, cfg.EGO.HEIGHT, bx, dx)
    ax.fill(pts[:, 0], pts[:, 1], '#76b900')
    ax.set_xlim(w, 0)
    ax.set_ylim(0, h)
    gt = np.array(as_numpy(labels['gt_trajectory'])[0, :, :2])
    gt[:, 0] *= -1                                       # reference :269
    gt = (gt - bx) / dx
    ax.plot(gt[:, 0], gt[:, 1], linewidth=3.0)

    out = os.path.join(str(save_path), f'{frame:04d}.png')
    fig.savefig(out)
    plt.close(fig)
    return out


def _seg_rgb(seg: np.ndarray) -> np.ndarray:
    """(H, W) class ids -> (H, W, 3) uint8: background white, vehicles black."""
    return _SEMANTIC_COLOURS[np.asarray(seg, int)]


def save_eval_panel(output: Dict, labels: Dict, n_present: int, index: int,
                    save_path: str, cfg) -> str:
    """One evaluation panel (reference evaluate.py :171-272): GT and
    predicted segmentation of the present frame and the planning plot.
    Returns the PNG's path."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    seg_pred = as_numpy(output['segmentation']).argmax(-1)[0, n_present - 1]
    seg_gt = as_numpy(labels['segmentation'])[0, n_present - 1]
    axes[0].imshow(_seg_rgb(seg_gt))
    axes[0].set_title('GT segmentation')
    axes[1].imshow(_seg_rgb(seg_pred))
    axes[1].set_title('pred segmentation')
    gt_traj = as_numpy(labels['gt_trajectory'])[0]
    final = (as_numpy(output['final_traj'])[0]
             if output.get('final_traj') is not None else None)
    plot_planning(axes[2], final, gt_traj, bev_extent=cfg.LIFT.X_BOUND[1])
    axes[2].set_title('planning')
    out = os.path.join(save_path, f'{index:06d}.png')
    fig.tight_layout()
    fig.savefig(out, dpi=100)
    plt.close(fig)
    return out
