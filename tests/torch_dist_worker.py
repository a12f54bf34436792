"""One rank of the port's multi-process tests on the CPU (gloo), started by
``stp3_tpu_torch.parallel.launch.run_ranks`` (torchrun's environment):

    python tests/torch_dist_worker.py train OUT_DIR    # 2 ranks
    python tests/torch_dist_worker.py cam OUT_DIR      # 3 ranks

Each rank writes what it computed to OUT_DIR/rank<r>.pt; the tests
(tests/test_torch_distributed.py, tests/test_torch_cam_parallel.py)
compute the same in one process and compare. The helpers here are
shared by both sides. No JAX: the ranks import the port only.
"""
from __future__ import annotations

import functools
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from stp3_tpu_torch import losses  # noqa: E402
from stp3_tpu_torch import train as ttrain  # noqa: E402
from stp3_tpu_torch.datas.synthetic import NumpyLoader, SyntheticDataset, collate  # noqa: E402
from stp3_tpu_torch.ops.static_splat import build_column_splat_plan  # noqa: E402
from stp3_tpu_torch.parallel import mesh, serving  # noqa: E402
from stp3_tpu_torch.training.trainer import Trainer, batch_to_device  # noqa: E402

GLOBAL_BATCH = 2
SEED = 0


# ------------------------------------------------------------------ training
def dp_cfg(norm: str):
    """The Prediction stage (instance and flow heads: spatial regression
    losses; GAUSSIAN latent; REMAT 'encoder') at TINY's widths, float64."""
    return chip_smoke.stage_cfg('prediction', True, {'MODEL': {'NORM': norm},
                                                     'PRECISION': 64})


def global_batch(cfg):
    """The global batch (host numpy) and its fixed latent draw."""
    ds = SyntheticDataset(cfg, n_samples=GLOBAL_BATCH, seed=SEED)
    batch = collate([ds[i] for i in range(GLOBAL_BATCH)])
    noise = np.random.RandomState(SEED).randn(
        GLOBAL_BATCH, 1, cfg.MODEL.DISTRIBUTION.LATENT_DIM).astype(np.float64)
    return batch, noise


def regression_counts(cfg, batch) -> list:
    """Each sample's count of unmasked offset pixels after the label warp."""
    trainer = Trainer(cfg, device='cpu', seed=SEED)
    labels = trainer.prepare_future_labels(batch_to_device(batch, 'cpu'))
    mask = labels['offset'][..., 0] != cfg.DATASET.IGNORE_INDEX
    return mask.flatten(1).sum(1).tolist()


def dp_step(cfg, group=None) -> dict:
    """One step of the seeded model, dropout off, the fixed draw: on the
    global batch without a group, on this rank's rows with one. The loss
    terms, the gradients (after the all-reduce), the updated parameters
    and the 'bn' running statistics."""
    batch, noise = global_batch(cfg)
    trainer = Trainer(cfg, device='cpu', seed=SEED, group=group)
    batch['noise'] = noise
    batch = mesh.shard_batch(batch, 'cpu', group) if group is not None else (
        batch_to_device(batch, 'cpu'))
    noise = batch.pop('noise')
    loss = trainer.compute_gradients(batch, noise, dropout=False)
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None}
    trainer.apply_gradients()
    return {'loss': {k: v.item() for k, v in loss.items()}, 'grads': grads,
            'params': {n: p.detach().clone() for n, p in trainer.model.named_parameters()},
            'stats': chip_smoke.running_stats(trainer.model)}


def val_metrics(cfg, batch_size: int, group=None) -> dict:
    """``compute_metrics`` of the seeded model over 5 validation samples
    (a ragged tail over a global batch of 4), each rank on its rows."""
    trainer = Trainer(cfg, device='cpu', seed=SEED, group=group)
    loader = NumpyLoader(SyntheticDataset(cfg, n_samples=5, seed=1), batch_size,
                         shuffle=False, drop_last=False, num_workers=0,
                         rank=mesh.process_index(group), world=mesh.process_count(group),
                         with_valid_mask=True)
    for batch in loader:
        trainer.val_step(batch_to_device(batch, 'cpu'))
    return trainer.compute_metrics()


def regression_case():
    """(prediction, target) of a global batch of 2 for
    ``spatial_regression_loss``; the second sample is all ignored, so
    rank 1 of 2 holds no unmasked pixel."""
    rng = np.random.RandomState(SEED)
    pred = torch.from_numpy(rng.randn(2, 3, 4, 4, 2))
    target = torch.from_numpy(rng.randn(2, 3, 4, 4, 2))
    target[0, :, :2, :, 0] = 255.0
    target[1] = 255.0
    return pred, target


def regression_loss(group=None):
    """(loss, d loss / d prediction) on the global case, or on this rank's rows."""
    pred, target = regression_case()
    if group is not None:
        rows = mesh.shard_batch({'p': pred, 't': target}, 'cpu', group)
        pred, target = rows['p'], rows['t']
    pred = pred.clone().requires_grad_(True)
    loss = losses.spatial_regression_loss(pred, target, 1, 2, 0.9, group=group)
    loss.backward()
    return loss.detach(), pred.grad


def cli_cfg(log_dir: str, batch_size: int, epochs: int = 1, resume: str = ''):
    """``train.run``'s config: the tiny Prediction stage without a latent
    draw, float64, 'mini' synthetic data (10 training samples: 2 steps an
    epoch at a global batch of 4), 5 validation samples (a ragged tail)."""
    return chip_smoke.stage_cfg('prediction', True, {
        'PRECISION': 64, 'BATCHSIZE': batch_size, 'EPOCHS': epochs, 'LOG_DIR': log_dir,
        'N_WORKERS': 0, 'PROBABILISTIC': {'ENABLED': False},
        'PRETRAINED': {'LOAD_WEIGHTS': False},
        'DATASET': {'NAME': 'synthetic', 'VERSION': 'mini', 'VAL_SAMPLES': 5},
        'CHECKPOINT': {'RESUME': resume}})


def cli_runs(log_dir: str, batch_size: int) -> list:
    """Epoch 1 of ``train.run`` (save_dir named by rank 0), then a resume
    to epoch 2 in the same directory. The steps take no dropout mask:
    the ranks' masks cannot equal one process's."""
    first = ttrain.run(cli_cfg(log_dir, batch_size), 'cpu', log=print)
    second = ttrain.run(cli_cfg(log_dir, batch_size, 2, first['last']), 'cpu',
                        save_dir=first['save_dir'], log=print)
    keep = ('save_dir', 'last', 'start_step', 'step', 'best_iou', 'metrics')
    return [{**{k: r[k] for k in keep}, 'loss': {k: v.item() for k, v in r['loss'].items()}}
            for r in (first, second)]


def no_dropout():
    """``Trainer.train_step`` without dropout masks, in this process."""
    Trainer.train_step = functools.partialmethod(Trainer.train_step, dropout=False)


def train_rank(out_dir: str) -> dict:
    mesh.maybe_initialize_multihost('cpu')
    group = mesh.data_group()
    rank = mesh.process_index(group)
    result = {
        'string': mesh.broadcast_string(f'from rank {rank}'),
        'tree': mesh.allreduce_host_tree({'count': np.arange(3, dtype=np.int64) * (rank + 1),
                                          'sum': np.float64(0.5 + rank), 'total': rank + 1}),
        'regression': regression_loss(group),
        'gn': dp_step(dp_cfg('gn'), group),
        'bn': dp_step(dp_cfg('bn'), group),
        'metrics': val_metrics(dp_cfg('gn'), 2, group),
    }
    mesh.coordination_barrier()
    no_dropout()
    result['cli'] = cli_runs(os.path.join(out_dir, 'runs'), 2)
    return result


# ------------------------------------------------------------ camera parallel
def cam_cfg():
    """The tiny flagship with 6 cameras, the front one fourth (its owner
    is rank 1 at 2 and at 3 ranks), fp32."""
    names = ['CAM_FRONT_LEFT', 'CAM_BACK_LEFT', 'CAM_BACK', 'CAM_FRONT', 'CAM_BACK_RIGHT',
             'CAM_FRONT_RIGHT']
    return chip_smoke.make_cfg(chip_smoke.FLAGSHIP, chip_smoke.TINY,
                               {'IMAGE': {'FINAL_DIM': (32, 64), 'NAMES': names}})


def cam_inputs(model, cfg, device='cpu', dtype=torch.float32):
    """The forward's (image, K, E, ego), the planner's (trajs, gt_trajs,
    commands, target_points) and a seeded BEV cache of the past frames."""
    (image, k, e, ego), ex = chip_smoke.example_inputs(cfg)
    fwd = chip_smoke.to_torch((image, k, e, ego), device)
    fwd[0] = fwd[0].to(dtype)
    plan = chip_smoke.to_torch((ex['trajs'], ex['gt_trajs'], ex['commands'],
                                ex['target_points']), device, dtype)
    nx, ny = model.cfg.bev_size
    cache = torch.from_numpy(np.random.RandomState(SEED + 1).randn(
        1, model.cfg.receptive_field - 1, nx, ny, model.cfg.encoder_out_channels)
        .astype(np.float32)).to(device, dtype)
    return fwd, plan, cache


def cam_calls(model, cfg, group) -> dict:
    """Every camera-parallel entry point on the same inputs (or, without a
    group, the one-process model's own calls)."""
    (image, k, e, ego), (trajs, gt, cmd, target), cache = cam_inputs(model, cfg)
    present = (image[:, -1], k[:, -1], e[:, -1])
    if group is None:
        arrays = build_column_splat_plan(model.frustum, k[0, -1].numpy(), e[0, -1].numpy(),
                                         model.bev_resolution, model.bev_start_position,
                                         model.bev_dimension).device_arrays('cpu')
        with torch.no_grad():
            return {'forward': model(image, k, e, ego),
                    'plan': chip_smoke.plan_step(model, image, k, e, ego, trajs, gt, cmd,
                                                 target)[1],
                    'serve': model.serve_step(*present, ego, cache, trajs, cmd, target),
                    'static': model.serve_step_static(image[:, -1], ego, cache, trajs, cmd,
                                                      target, arrays)}
    return {
        'forward': serving.make_cam_parallel_forward(model, group)(image, k, e, ego),
        'plan': serving.make_cam_parallel_plan_step(model, group)(image, k, e, ego, trajs,
                                                                  gt, cmd, target),
        'serve': serving.make_cam_parallel_serve_step(model, group)(*present, ego, cache,
                                                                    trajs, cmd, target),
        'static': serving.make_cam_parallel_serve_step_static(
            model, group, k[0, -1].numpy(), e[0, -1].numpy())(image[:, -1], ego, cache,
                                                              trajs, cmd, target),
    }


def cam_rank(out_dir: str) -> dict:
    mesh.maybe_initialize_multihost('cpu')
    rank = mesh.process_index(mesh.data_group())
    cfg = cam_cfg()
    model = chip_smoke.build_model(cfg)
    result = {}
    for k in (2, 3):
        group = serving.cam_mesh(k)
        if rank < k:
            result[k] = cam_calls(model, cfg, group)
    # 4 cameras over 3 ranks: every rank raises before any collective
    (image, kk, e, ego), _, _ = cam_inputs(model, cfg)
    errors = []
    for call in (lambda: serving.make_cam_parallel_forward(model, mesh.data_group())(
                     image[:, :, :4], kk[:, :, :4], e[:, :, :4], ego),
                 lambda: serving.make_cam_parallel_serve_step_static(
                     model, mesh.data_group(), kk[0, -1, :4].numpy(), e[0, -1, :4].numpy())):
        try:
            call()
        except ValueError as exc:
            errors.append(str(exc))
    result['indivisible'] = errors
    mesh.coordination_barrier()
    return result


def main() -> None:
    scenario, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    result = {'train': train_rank, 'cam': cam_rank}[scenario](out_dir)
    rank = int(os.environ['RANK'])
    torch.save(result, os.path.join(out_dir, f'rank{rank}.pt'))


if __name__ == '__main__':
    main()
