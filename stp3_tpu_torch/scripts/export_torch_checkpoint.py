"""Export a checkpoint of this package to the reference ST-P3
(PyTorch-Lightning) format (counterpart of scripts/export_torch_checkpoint.py).

    python -m stp3_tpu_torch.scripts.export_torch_checkpoint \
        --checkpoint ./runs/.../checkpoints --output ./exported.ckpt [KEY VALUE ...]

The inverse of ``import_torch_checkpoint``: ``torch.load(out)['state_dict']``
has the reference TrainingModule's key layout (``model.*``, reference
trainer.py:40), and ``hyper_parameters`` holds the config as a plain dict
in the reference schema (the keys only this repository has are stripped:
the reference's yacs rehydration, config.py:173-189, refuses unknown keys).

The reference format stores BatchNorm running statistics at every norm
site, so the checkpoint must come from MODEL.NORM 'bn_frozen' (imported
weights, frozen fine-tune) or 'bn' (whose running statistics are folded in
with ``training.checkpoint.merge_bn_to_frozen``); a 'gn' or 'ln' model
cannot be expressed and raises. The grid constants the reference registers
as parameters (``model.frustum``, ``model.bev_*``, reference
stp3.py:23-25,130) are rebuilt from the same formulas (ops/geometry.py) and
``num_batches_tracked`` is written as zeros. The Cost_Function's constant
buffers (``model.planning.cost_function.*``) are not: its constructor
rebuilds them, so load the file with ``strict=False`` (as the reference's
own curriculum loads do, reference train.py:21-29). Host-side: nothing
runs on a device.
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from stp3_tpu_torch.config import get_cfg, strip_tpu_only_keys
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from stp3_tpu_torch.ops.geometry import calculate_birds_eye_view_parameters, create_frustum
from stp3_tpu_torch.training import checkpoint as ckpt_lib
from stp3_tpu_torch.utils import torch_import as ti
from stp3_tpu_torch.utils.from_flax import to_flax


def export_checkpoint(checkpoint: str, output: str, opts: Optional[Sequence[str]] = None,
                      log: Callable[[str], None] = print) -> Dict[str, torch.Tensor]:
    """Write ``checkpoint`` (a checkpoint root, step directory or pointer
    file) to ``output`` as a Lightning-style .ckpt; returns its state_dict."""
    cfg_dict = ckpt_lib.load_config_dict(checkpoint)
    if cfg_dict is None:
        raise FileNotFoundError(f'no config.json beside checkpoint {checkpoint}')
    cfg = get_cfg(cfg_dict=cfg_dict)
    if opts:
        cfg.merge_from_list(list(opts))
    state = ckpt_lib.load_checkpoint(checkpoint)['model']

    norm = cfg.MODEL.get('NORM', 'gn')
    if norm == 'bn':
        params, stats = ckpt_lib.split_frozen_bn(state)
        if not stats:
            raise SystemExit('MODEL.NORM=bn checkpoint holds no running statistics: cannot '
                             'recover them')
        state = ckpt_lib.merge_bn_to_frozen(params, stats)
        cfg.MODEL.NORM = 'bn_frozen'
    elif norm != 'bn_frozen':
        raise SystemExit(
            f'MODEL.NORM={norm!r}: the reference format stores BatchNorm running statistics '
            f'at every norm site; only bn / bn_frozen checkpoints are expressible. Train or '
            f'fine-tune with MODEL.NORM=bn to export.')

    mcfg = STP3Config.from_cfg(cfg)
    model = STP3(mcfg)
    model.load_state_dict(state)
    sd = ti.export_state_dict(to_flax(model)['params'], mcfg)

    res, start, dim = calculate_birds_eye_view_parameters(mcfg.x_bound, mcfg.y_bound,
                                                          mcfg.z_bound)
    sd['model.bev_resolution'] = res
    sd['model.bev_start_position'] = start
    sd['model.bev_dimension'] = dim
    sd['model.frustum'] = np.asarray(
        create_frustum(mcfg.final_dim, mcfg.encoder_downsample, mcfg.d_bound), np.float32)
    # the BN bookkeeping the reference's strict load expects beside the statistics
    for key in [k for k in sd if k.endswith('.running_mean')]:
        sd[key[:-len('running_mean')] + 'num_batches_tracked'] = np.zeros((), np.int64)

    state_dict = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    torch.save({'state_dict': state_dict,
                'hyper_parameters': strip_tpu_only_keys(cfg.convert_to_dict())}, output)
    log(f'exported {len(state_dict)} tensors to {output} (reference-side load: strict=False; '
        f'the Cost_Function constant buffers are rebuilt by its constructor)')
    return state_dict


def main(argv=None) -> Dict[str, torch.Tensor]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--checkpoint', required=True,
                        help='checkpoint root, step directory or pointer file (last, best)')
    parser.add_argument('--output', required=True, help='output .ckpt path (torch.save format)')
    parser.add_argument('opts', nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)
    return export_checkpoint(args.checkpoint, args.output, args.opts)


if __name__ == '__main__':
    main()
