"""Synthetic dataset emitting the canonical batch contract, and the
batching loader (the port's own copy of stp3_tpu/datas/synthetic.py's
``SyntheticDataset``, ``collate`` and ``NumpyLoader``: numpy only, the
same RNG draws in the same order, so one seed gives the same batch byte
for byte in either package, and the same index order and ``valid``
masks).

Per sample, channels-last:

  image            (S_past, N, H, W, 3) uint8 raw RGB (normalised on the
                   device by utils/network.prepare_image)
  intrinsics       (S_past, N, 3, 3)
  extrinsics       (S_past, N, 4, 4) camera->ego
  depths           (S_past, N, H, W) float32 (only if gt_depth)
  segmentation     (S_total, Hb, Wb) int32 {0,1}
  pedestrian       (S_total, Hb, Wb) int32
  instance         (S_total, Hb, Wb) int32 (persistent ids)
  centerness       (S_total, Hb, Wb, 1) float32
  offset / flow    (S_total, Hb, Wb, 2) float32 (ignore_index outside)
  hdmap            (S_total, Hb, Wb, E) int32
  future_egomotion (S_total, 6)
  gt_trajectory    (n_future+1, 3)
  command          int32 (0 LEFT / 1 FORWARD / 2 RIGHT)
  sample_trajectory (sample_num, n_future+1, 3)
  target_point     (2,)

Scenes hold a few box "vehicles"/"pedestrians" moving at constant BEV
velocity while the ego drives forward; the labels are consistent with
the motion, so the losses behave as on real data.
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from stp3_tpu_torch.ops.geometry import calculate_birds_eye_view_parameters
from stp3_tpu_torch.utils.instance import convert_instance_mask_to_center_and_offset_label
from stp3_tpu_torch.utils.sampler import sample_trajectories


class SyntheticDataset:
    def __init__(self, cfg, n_samples: int = 64, seed: int = 0):
        self.cfg = cfg
        self.n_samples = n_samples
        self.seed = seed
        self.rf = cfg.TIME_RECEPTIVE_FIELD
        self.n_future = cfg.N_FUTURE_FRAMES
        self.s_total = self.rf + self.n_future
        self.h, self.w = cfg.IMAGE.FINAL_DIM
        self.n_cam = len(cfg.IMAGE.NAMES)
        res, start, dim = calculate_birds_eye_view_parameters(
            cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)
        self.bev_res, self.bev_start, self.bev_dim = res, start, dim
        self.hb, self.wb = int(dim[0]), int(dim[1])
        self.spatial_extent = (cfg.LIFT.X_BOUND[1], cfg.LIFT.Y_BOUND[1])
        self.ignore_index = cfg.DATASET.IGNORE_INDEX
        self.n_hdmap = len(cfg.SEMANTIC_SEG.HDMAP.ELEMENTS)

    def __len__(self) -> int:
        return self.n_samples

    def _cell(self, x: float, y: float):
        """metres (forward x, side y) -> integer BEV cell (row, col)."""
        i = int((x - (self.bev_start[0] - self.bev_res[0] / 2)) / self.bev_res[0])
        j = int((y - (self.bev_start[1] - self.bev_res[1] / 2)) / self.bev_res[1])
        return i, j

    def _draw_box(self, grid: np.ndarray, x: float, y: float, half_l: float,
                  half_w: float, value: int):
        i0, j0 = self._cell(x - half_l, y - half_w)
        i1, j1 = self._cell(x + half_l, y + half_w)
        i0, i1 = max(i0, 0), min(i1 + 1, self.hb)
        j0, j1 = max(j0, 0), min(j1 + 1, self.wb)
        if i0 < i1 and j0 < j1:
            grid[i0:i1, j0:j1] = value

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 100003 + index)
        cfg = self.cfg
        s, rf = self.s_total, self.rf

        # ego motion: constant forward speed + slight yaw rate, as
        # vec(inv(e_{t+1}) @ e_t): forward motion is a NEGATIVE x translation
        v_ego = 4.0 + 4.0 * rng.rand()
        yaw_rate = 0.04 * rng.randn()
        dt = 0.5
        ego = np.zeros((s, 6), np.float32)
        ego[:, 0] = -v_ego * dt
        ego[:, 5] = -yaw_rate * dt

        # actors: boxes with constant world velocity, in the PRESENT frame
        n_veh = rng.randint(2, 6)
        n_ped = rng.randint(0, 3)
        actors = []
        for a in range(n_veh + n_ped):
            is_ped = a >= n_veh
            actors.append({
                'pos': np.array([rng.uniform(-30, 30), rng.uniform(-20, 20)]),
                'vel': np.array([rng.uniform(-4, 4), rng.uniform(-1.5, 1.5)]),
                'half': (0.5, 0.4) if is_ped else (2.3, 1.0),
                'ped': is_ped,
                'id': a + 1,
            })

        # ego position in the present frame at each t (labels are per-frame
        # ego-centric); the ego moves forward by +v*dt per step
        ego_x = np.cumsum(np.concatenate([[0.0], np.full(s - 1, v_ego * dt)]))
        present_x = ego_x[rf - 1]

        seg = np.zeros((s, self.hb, self.wb), np.int32)
        ped = np.zeros_like(seg)
        inst = np.zeros_like(seg)
        for t in range(s):
            t_rel = (t - (rf - 1)) * dt
            frame_origin = ego_x[t] - present_x
            for a in actors:
                px = a['pos'][0] + a['vel'][0] * t_rel - frame_origin
                py = a['pos'][1] + a['vel'][1] * t_rel
                if a['ped']:
                    self._draw_box(ped[t], px, py, *a['half'], 1)
                else:
                    self._draw_box(seg[t], px, py, *a['half'], 1)
                    self._draw_box(inst[t], px, py, *a['half'], a['id'])

        # hdmap: a straight drivable corridor + a lane divider line
        hdmap = np.zeros((s, self.hb, self.wb, self.n_hdmap), np.int32)
        _, j_lo = self._cell(0, -6.0)
        _, j_hi = self._cell(0, 6.0)
        _, j_mid = self._cell(0, 0.0)
        if self.n_hdmap >= 2:
            hdmap[:, :, max(j_mid - 1, 0):j_mid + 1, 0] = 1        # lane divider
            hdmap[:, :, max(j_lo, 0):min(j_hi + 1, self.wb), 1] = 1  # drivable
        else:
            hdmap[:, :, max(j_lo, 0):min(j_hi + 1, self.wb), 0] = 1

        centerness, offset, flow = convert_instance_mask_to_center_and_offset_label(
            inst, ego, num_instances=n_veh, ignore_index=self.ignore_index,
            subtract_egomotion=True, spatial_extent=self.spatial_extent)

        # camera rig: N cameras at yaw angles around the ego
        fx = 0.5 * self.w
        K = np.zeros((rf, self.n_cam, 3, 3), np.float32)
        E = np.zeros((rf, self.n_cam, 4, 4), np.float32)
        for n in range(self.n_cam):
            yaw = 2 * np.pi * n / self.n_cam
            c_, s_ = np.cos(yaw), np.sin(yaw)
            # camera->ego: camera +z (depth) points along heading yaw
            rot = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
            yawm = np.array([[c_, -s_, 0], [s_, c_, 0], [0, 0, 1]], np.float32)
            for t in range(rf):
                K[t, n] = np.array([[fx, 0, self.w / 2],
                                    [0, fx, self.h / 2], [0, 0, 1]], np.float32)
                E[t, n, :3, :3] = yawm @ rot
                E[t, n, :3, 3] = [1.5 * c_, 1.5 * s_, 1.6]
                E[t, n, 3, 3] = 1.0

        # uint8 wire format: a quarter of the bytes of fp32
        image = rng.randint(0, 256, (rf, self.n_cam, self.h, self.w, 3),
                            dtype=np.uint8)

        # GT trajectory in the planner frame (x lateral, y forward)
        gt = np.zeros((self.n_future + 1, 3), np.float32)
        tts = np.arange(self.n_future + 1) * dt
        gt[:, 1] = v_ego * tts
        gt[:, 0] = -np.sin(yaw_rate * tts) * v_ego * tts * 0.5
        gt[:, 2] = yaw_rate * tts
        if gt[-1, 0] >= 2:
            command = 2  # RIGHT
        elif gt[-1, 0] <= -2:
            command = 0  # LEFT
        else:
            command = 1  # FORWARD

        trajs = sample_trajectories(
            v_ego, steering=yaw_rate, n_future=self.n_future,
            n_samples=cfg.PLANNING.SAMPLE_NUM, rng=rng).astype(np.float32)

        data = {
            'image': image,
            'intrinsics': K,
            'extrinsics': E,
            'segmentation': seg,
            'pedestrian': ped,
            'instance': inst,
            'centerness': centerness.astype(np.float32),
            'offset': offset.astype(np.float32),
            'flow': flow.astype(np.float32),
            'hdmap': hdmap,
            'future_egomotion': ego,
            'gt_trajectory': gt,
            'command': np.int32(command),
            'sample_trajectory': trajs,
            'target_point': np.zeros(2, np.float32),
        }
        if cfg.LIFT.GT_DEPTH:
            data['depths'] = rng.uniform(
                cfg.LIFT.D_BOUND[0], cfg.LIFT.D_BOUND[1],
                (rf, self.n_cam, self.h, self.w)).astype(np.float32)
        return data


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


# the dataset of a process-pool worker (pickled in once by the pool's initializer)
_WORKER_DATASET = None


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _load_worker_sample(idx: int):
    return _WORKER_DATASET[idx]


class NumpyLoader:
    """Batching iterator over an indexable dataset, on the host.

    ``num_workers > 0`` loads the samples of ``prefetch`` batches ahead in
    a pool: threads by default (no IPC; right when a sample's work
    releases the GIL or is cheap, as the synthetic set's is), or spawned
    processes (``use_processes``), each holding one pickled copy of the
    dataset. Batches come out in order.

    ``rank`` / ``world``: the split of a multi-process run (torch's
    DistributedSampler): ``batch_size`` is per process, each epoch's index
    list is cut into global batches of ``batch_size * world`` rows, and
    process ``rank`` takes the rank-th contiguous ``batch_size`` rows of
    each, so every process yields as many batches. Without ``drop_last``
    a ragged tail is padded with wrap-around duplicates, and
    ``with_valid_mask`` adds a per-row bool ``valid`` key that is False
    on them, for ``Trainer.val_step`` to leave out.

    Its owner calls ``close()``, which stops the pool: a process pool with
    ``close()`` and ``join()``, letting its workers finish what was handed
    to them (``Pool.terminate()`` is the suspect of a hang in the JAX
    package's tests)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 2, use_processes: bool = False, rank: int = 0,
                 world: int = 1, with_valid_mask: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.use_processes = use_processes
        self.rank = rank
        self.world = world
        self.with_valid_mask = with_valid_mask
        self._pool = None

    def _get_pool(self):
        if self._pool is None:
            if self.use_processes:
                import multiprocessing as mp
                self._pool = mp.get_context('spawn').Pool(
                    self.num_workers, initializer=_worker_init, initargs=(self.dataset,))
            else:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        return self._pool

    def close(self):
        pool, self._pool = self._pool, None
        if pool is None:
            return
        if self.use_processes:
            pool.close()
            pool.join()
        else:
            pool.shutdown(wait=True, cancel_futures=True)

    def __len__(self) -> int:
        n, gb = len(self.dataset), self.batch_size * self.world
        return n // gb if self.drop_last else -(-n // gb)

    def _batches(self):
        """(index chunks, per-row validity masks) of the next epoch. A row
        is invalid iff it is a wrap-around padding duplicate."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        if self.world > 1:
            gb = self.batch_size * self.world
            if self.drop_last:
                idx = idx[:len(idx) // gb * gb]
            n_real = len(idx)
            pad = 0 if self.drop_last else (-len(idx)) % gb
            if pad:
                reps = -(-pad // max(len(idx), 1))
                idx = np.concatenate([idx, np.tile(idx, reps)[:pad]])
            lo = self.rank * self.batch_size
            chunks, masks = [], []
            for i in range(0, len(idx), gb):
                chunks.append(idx[i + lo:i + lo + self.batch_size])
                masks.append(np.arange(i + lo, i + lo + self.batch_size) < n_real)
            return chunks, masks
        end = len(idx) // self.batch_size * self.batch_size if self.drop_last else len(idx)
        chunks = [idx[i:i + self.batch_size] for i in range(0, end, self.batch_size)]
        return chunks, [np.ones(len(c), bool) for c in chunks]

    def _finish(self, samples, mask):
        batch = collate(samples)
        if self.with_valid_mask:
            batch['valid'] = mask
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches, masks = self._batches()
        if self.num_workers <= 0:
            for chunk, mask in zip(batches, masks):
                yield self._finish([self.dataset[int(j)] for j in chunk], mask)
            return
        pool = self._get_pool()
        if self.use_processes:
            def submit(chunk):
                return [pool.apply_async(_load_worker_sample, (int(j),)) for j in chunk]

            def result(handle):
                return handle.get()
        else:
            def submit(chunk):
                return [pool.submit(self.dataset.__getitem__, int(j)) for j in chunk]

            def result(handle):
                return handle.result()
        # one handle a sample, ``prefetch`` batches in flight (at least one)
        pending, it = [], iter(zip(batches, masks))
        for chunk, mask in it:
            pending.append((submit(chunk), mask))
            if len(pending) >= max(self.prefetch, 1):
                break
        while pending:
            handles, mask = pending.pop(0)
            nxt = next(it, None)
            if nxt is not None:
                pending.append((submit(nxt[0]), nxt[1]))
            yield self._finish([result(h) for h in handles], mask)
