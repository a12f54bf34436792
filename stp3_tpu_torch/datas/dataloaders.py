"""Dataloader factory (counterpart of stp3_tpu/datas/dataloaders.py;
reference stp3/datas/dataloaders.py:8-42).

``cfg.DATASET.NAME``:
  * 'synthetic': procedural scenes, no external data; ``DATASET.VERSION
    mini`` gives 10 training samples (else 64), ``DATASET.VAL_SAMPLES``
    sets the validation set's size (0: max(4, n_train // 4));
  * 'nuscenes': ``datas/nuscenes_data.py`` over ``DATASET.DATAROOT``
    (``v1.0-{DATASET.VERSION}``) and the maps under ``DATASET.MAP_FOLDER``;
    needs the nuscenes-devkit. ``DATASET.VERSION mini`` keeps the first
    10 training windows;
  * 'carla': ``datas/carla_data.py`` over the route dumps under
    ``DATASET.DATAROOT``.
"""
from __future__ import annotations

from stp3_tpu_torch.datas.synthetic import NumpyLoader, SyntheticDataset


def prepare_dataloaders(cfg, return_dataset: bool = False, split: str = 'both',
                        rank: int = 0, world: int = 1):
    """(trainloader or None, valloader[, traindata, valdata]). ``split``:
    'both' | 'val' (evaluation needs the validation set only). ``rank`` /
    ``world``: this process's share of a multi-process run
    (``cfg.BATCHSIZE`` is per process)."""
    name = cfg.DATASET.NAME
    need_train = split != 'val'
    traindata = None
    if name == 'synthetic':
        n_train = 10 if cfg.DATASET.VERSION == 'mini' else 64
        if need_train:
            traindata = SyntheticDataset(cfg, n_samples=n_train, seed=0)
        n_val = int(cfg.DATASET.get('VAL_SAMPLES', 0)) or max(4, n_train // 4)
        valdata = SyntheticDataset(cfg, n_samples=n_val, seed=1)
    elif name == 'nuscenes':
        from stp3_tpu_torch.datas.nuscenes_data import FuturePredictionDataset, make_nusc
        nusc = make_nusc(cfg)
        if need_train:
            traindata = FuturePredictionDataset(nusc, 0, cfg)
            if cfg.DATASET.VERSION == 'mini':
                traindata.indices = traindata.indices[:10]
        valdata = FuturePredictionDataset(nusc, 1, cfg)
    elif name == 'carla':
        from stp3_tpu_torch.datas.carla_data import CarlaDataset
        if need_train:
            traindata = CarlaDataset(cfg.DATASET.DATAROOT, True, cfg)
        valdata = CarlaDataset(cfg.DATASET.DATAROOT, False, cfg)
    else:
        raise NotImplementedError(f'DATASET.NAME {name!r}')

    kw = dict(num_workers=int(cfg.N_WORKERS), use_processes=cfg.WORKER_KIND == 'process',
              rank=rank, world=world)
    trainloader = (NumpyLoader(traindata, cfg.BATCHSIZE, shuffle=True, drop_last=True, **kw)
                   if traindata is not None else None)
    valloader = NumpyLoader(valdata, cfg.BATCHSIZE, shuffle=False, drop_last=False,
                            with_valid_mask=True, **kw)
    if return_dataset:
        return trainloader, valloader, traindata, valdata
    return trainloader, valloader
