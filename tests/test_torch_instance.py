"""The port's instance decoding against the JAX package's, on the CPU:
``decode_instances`` (utils/instance_jit.py, on the tensors' device)
against JAX's ``decode_instances`` and against the host loop of both
packages, id for id, including frames with more than 100 NMS survivors
(the first 100 in row-major order are kept), empty frames and frames
whose foreground holds no center; then the temporally consistent ids
(Hungarian matching) and the matched centers of
``predict_instance_segmentation_and_trajectories``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stp3_tpu.utils import instance as ji
from stp3_tpu.utils.instance_jit import decode_instances as jax_decode
from stp3_tpu_torch.utils import instance as ti
from stp3_tpu_torch.utils import instance_jit


def _scene(rng, h, w, n_blobs):
    """Decoder-like outputs: gaussian center blobs, offsets pointing at the
    nearest blob, a foreground disc per blob."""
    center = np.zeros((h, w), np.float32)
    offset = rng.randn(h, w, 2).astype(np.float32) * 0.3
    fg = np.zeros((h, w), bool)
    gx, gy = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    for ci, cj in zip(rng.randint(3, h - 3, n_blobs), rng.randint(3, w - 3, n_blobs)):
        d2 = (gx - ci) ** 2 + (gy - cj) ** 2
        center = np.maximum(center, np.exp(-d2 / 4.0))
        mask = d2 <= 9
        fg |= mask
        offset[mask] = np.stack([ci - gx[mask], cj - gy[mask]], -1)
    return center, offset, fg


def _crowded(rng, h, w):
    """More than 100 isolated peaks of random confidence (a 3-pixel
    lattice), random offsets, foreground everywhere but a ring."""
    center = np.zeros((h, w), np.float32)
    for i in range(1, h - 1, 3):
        for j in range(1, w - 1, 3):
            center[i, j] = 0.2 + 0.8 * rng.rand()
    offset = (rng.randn(h, w, 2) * 2.0).astype(np.float32)
    fg = np.zeros((h, w), bool)
    fg[1:-1, 1:-1] = True
    return center, offset, fg


def _batch(seed, b=2, t=3, h=48, w=44):
    """(logits (B,T,H,W,2), centers (B,T,H,W,1), offsets (B,T,H,W,2), fg):
    frame (0, 0) crowded, frame (0, 1) empty, frame (1, 2) centers but no
    foreground, the rest blob scenes."""
    rng = np.random.RandomState(seed)
    logits = np.zeros((b, t, h, w, 2), np.float32)
    centers = np.zeros((b, t, h, w, 1), np.float32)
    offsets = np.zeros((b, t, h, w, 2), np.float32)
    for i in range(b):
        for j in range(t):
            if (i, j) == (0, 0):
                c, o, fg = _crowded(rng, h, w)
            elif (i, j) == (0, 1):
                c, o, fg = np.zeros((h, w), np.float32), np.zeros((h, w, 2), np.float32), \
                    np.zeros((h, w), bool)
            else:
                c, o, fg = _scene(rng, h, w, rng.randint(1, 7))
                if (i, j) == (1, 2):
                    fg[:] = False
            centers[i, j, ..., 0] = c
            offsets[i, j] = o
            logits[i, j, ..., 1] = np.where(fg, 5.0, -5.0) + rng.randn(h, w).astype(np.float32)
    return logits, centers, offsets


def _host_ids(mod, logits, centers, offsets):
    fg = logits.argmax(-1) == 1
    out = np.zeros(logits.shape[:4], np.int64)
    for i in range(out.shape[0]):
        for j in range(out.shape[1]):
            out[i, j] = mod.get_instance_segmentation_and_centers(
                centers[i, j, ..., 0], offsets[i, j], fg[i, j])[0]
    return out


@pytest.mark.parametrize('seed', [0, 1])
def test_decode_instances_matches_jax_and_the_host_loops(seed):
    logits, centers, offsets = _batch(seed)
    got = instance_jit.decode_instances(*(torch.from_numpy(a) for a in
                                          (logits, centers, offsets))).numpy()
    want_jax = np.asarray(jax_decode(jnp.asarray(logits), jnp.asarray(centers),
                                     jnp.asarray(offsets)))
    host_t, host_j = _host_ids(ti, logits, centers, offsets), _host_ids(ji, logits, centers, offsets)
    np.testing.assert_array_equal(host_t, host_j)
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, host_t)
    # the crowded frame holds the cap's 100 ids, the empty one none
    assert got[0, 0].max() == 100 and got[0, 1].max() == 0 and got[1, 2].max() == 0


def test_decode_over_a_small_cap_and_in_chunks(monkeypatch):
    """``max_instances`` below the survivors keeps the first ones in
    row-major order; a chunked decode (one frame a chunk) equals the
    whole."""
    logits, centers, offsets = _batch(2)
    args = [torch.from_numpy(a) for a in (logits, centers, offsets)]
    whole = instance_jit.decode_instances(*args, max_instances=7).numpy()
    want = np.asarray(jax_decode(jnp.asarray(logits), jnp.asarray(centers),
                                 jnp.asarray(offsets), max_instances=7))
    np.testing.assert_array_equal(whole, want)
    monkeypatch.setattr(instance_jit, 'DISTANCE_CHUNK_ELEMENTS', 1)
    np.testing.assert_array_equal(instance_jit.decode_instances(*args, max_instances=7).numpy(),
                                  whole)


def _sequence(seed, t=5, hw=40, n=5):
    """Per-frame consecutive ids of moving blobs, with ids shuffled per
    frame, and a flow that points each pixel at its blob's next position."""
    rng = np.random.RandomState(seed)
    pos = rng.randint(6, hw - 6, (n, 2)).astype(np.float32)
    vel = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    inst = np.zeros((t, hw, hw), np.int64)
    flow = np.zeros((t, hw, hw, 2), np.float32)
    gx, gy = np.meshgrid(np.arange(hw), np.arange(hw), indexing='ij')
    for j in range(t):
        perm = rng.permutation(n) + 1
        for k in range(n):
            if j == 3 and k == 0:
                continue                          # a blob missing for a frame
            c = np.clip(pos[k] + j * vel[k], 3, hw - 4)
            mask = (gx - c[0]) ** 2 + (gy - c[1]) ** 2 <= 6
            inst[j][mask] = perm[k]
            flow[j][mask] = vel[k]
        inst[j] = ti.make_instance_seg_consecutive(inst[j])
    return inst, flow


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_temporally_consistent_ids_match_jax(seed):
    inst, flow = _sequence(seed)
    got = ti.make_instance_id_temporally_consistent(inst, flow)
    np.testing.assert_array_equal(got, ji.make_instance_id_temporally_consistent(inst, flow))
    assert got.max() > inst.max()             # a re-appearing blob got a new id


@pytest.mark.parametrize('jit_decode', [True, False])
def test_predict_instance_segmentation_and_matched_centers_match_jax(jit_decode):
    """Batch 1 (the matched centers need it): the consistent ids and every
    instance's centers per frame, from port tensors against JAX numpy."""
    logits, centers, offsets = _batch(3, b=1, t=4)
    flow = np.random.RandomState(3).randn(*offsets.shape).astype(np.float32)
    ours = {'segmentation': logits, 'instance_center': centers, 'instance_offset': offsets,
            'instance_flow': flow}
    got, got_centers = ti.predict_instance_segmentation_and_trajectories(
        {k: torch.from_numpy(v) for k, v in ours.items()}, compute_matched_centers=True,
        jit_decode=jit_decode)
    want, want_centers = ji.predict_instance_segmentation_and_trajectories(
        ours, compute_matched_centers=True, jit_decode=jit_decode)
    np.testing.assert_array_equal(got, want)
    assert sorted(got_centers) == sorted(want_centers) and len(want_centers) > 3
    for key, value in want_centers.items():
        np.testing.assert_array_equal(got_centers[key], value)
    # no flow head: linking on a zero flow, as in JAX
    del ours['instance_flow']
    np.testing.assert_array_equal(
        ti.predict_instance_segmentation_and_trajectories(ours, jit_decode=jit_decode),
        ji.predict_instance_segmentation_and_trajectories(ours, jit_decode=jit_decode))


def test_decode_of_a_frame_without_background_follows_the_host_path():
    """Foreground everywhere: the host path's np.unique renumbering (the
    reference's torch.unique) gives the first instance id 0; the port's
    device decode does the same. JAX's device decode keeps it at 1 there,
    unlike its own host path, so only the host paths are held here."""
    rng = np.random.RandomState(5)
    c, o, _ = _scene(rng, 32, 32, 4)
    logits = np.zeros((1, 1, 32, 32, 2), np.float32)
    logits[..., 1] = 1.0
    args = (logits, c[None, None, :, :, None], o[None, None])
    got = instance_jit.decode_instances(*(torch.from_numpy(a) for a in args)).numpy()
    host_t, host_j = _host_ids(ti, *args), _host_ids(ji, *args)
    np.testing.assert_array_equal(host_t, host_j)
    np.testing.assert_array_equal(got, host_t)
    assert got.min() == 0 and got.max() == 3
    assert np.asarray(jax_decode(*(jnp.asarray(a) for a in args))).min() == 1
