"""Import a reference ST-P3 (PyTorch-Lightning) checkpoint into a
checkpoint of this package (counterpart of scripts/import_torch_checkpoint.py).

    python -m stp3_tpu_torch.scripts.import_torch_checkpoint \
        --checkpoint /path/to/reference.ckpt --output ./imported \
        [--config-file stp3_tpu/configs/nuscenes/Planning.yml] [KEY VALUE ...]

The config is rehydrated from the .ckpt's ``hyper_parameters`` (reference
trainer.py:19-22), then ``--config-file`` and the KEY VALUE overrides
apply. The model is built with MODEL.NORM 'bn_frozen', so the reference's
BatchNorm running statistics travel as buffers; on a rig whose front
camera is not at index 1 (CARLA) PLANNING.CAM_FRONT_PARITY is set and
saved in the config. The file is read with ``torch.load(weights_only=True)``:
a .ckpt that pickles a Lightning ``AttributeDict`` is refused (README.md
says how to get past it). The result, ``<output>/step_0`` in the format of
training/checkpoint.py, is a ``PRETRAINED.PATH`` for a warm start or a
``--checkpoint`` of ``stp3_tpu_torch.evaluate`` and of the CARLA agent.
The conversion is host-side: nothing runs on a device.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence, Tuple

import torch

from stp3_tpu_torch.config import get_cfg
from stp3_tpu_torch.layers.base import init_parameters
from stp3_tpu_torch.models.stp3 import STP3, STP3Config
from stp3_tpu_torch.training import checkpoint as ckpt_lib
from stp3_tpu_torch.utils import torch_import as ti
from stp3_tpu_torch.utils.from_flax import (flatten_tree, load_flax_params, to_flax,
                                            unflatten_tree)

CAM_FRONT_NOTE = ('NOTE: the rig\'s front camera is not at index 1 (CARLA order): '
                  'PLANNING.CAM_FRONT_PARITY=True was set (and saved in the checkpoint\'s '
                  'config), so the imported planner consumes the camera feature the '
                  'reference fed it (reference stp3.py:203 hardcodes index 1; see PARITY.md)')


def import_checkpoint(checkpoint: str, output: str, config_file: str = '',
                      opts: Optional[Sequence[str]] = None,
                      log: Callable[[str], None] = print) -> Tuple[str, ti.ImportReport]:
    """Convert ``checkpoint`` and save it under ``output``; returns (the
    saved step directory, the import report). Missing or unexpected keys
    are reported, not raised: a leaf the file lacks keeps the seeded init."""
    blob = ti.load_reference_blob(checkpoint)
    hparams = (dict(blob['hyper_parameters'])
               if isinstance(blob, dict) and 'hyper_parameters' in blob else None)
    sd = ti.reference_state_dict(blob)

    cfg = get_cfg(argparse.Namespace(config_file=config_file, opts=list(opts or [])),
                  cfg_dict=hparams or None)
    cfg.MODEL.NORM = 'bn_frozen'
    if ti.apply_cam_front_parity(cfg):
        log(CAM_FRONT_NOTE)
    mcfg = STP3Config.from_cfg(cfg)

    params, report = ti.import_state_dict(sd, mcfg, strict=False)
    log(f'converted {report.converted} tensors; ignored {len(report.ignored)} bookkeeping keys')
    if report.missing:
        log(f'WARNING: {len(report.missing)} expected torch keys missing, '
            f'e.g. {report.missing[:5]}')
    if report.unexpected:
        log(f'WARNING: {len(report.unexpected)} unmapped model keys, '
            f'e.g. {report.unexpected[:5]}')

    # the structure against a freshly built model (catches a config that
    # does not match the file)
    model = STP3(mcfg)
    fresh = flatten_tree(to_flax(model)['params'])
    got = flatten_tree(params)
    wrong = sorted(k for k in got if k in fresh and got[k].shape != fresh[k].shape)
    if fresh.keys() != got.keys() or wrong:
        log(f'WARNING: param tree mismatch: {len(fresh.keys() - got.keys())} leaves missing '
            f'(kept at the seeded init), {len(got.keys() - fresh.keys())} extra and '
            f'{len(wrong)} of another shape (dropped), e.g. '
            f'{sorted(fresh.keys() ^ got.keys())[:3] + wrong[:3]}')
        fresh = flatten_tree(to_flax(init_parameters(
            model, torch.Generator().manual_seed(0)))['params'])
        params = unflatten_tree({k: got[k] if k in got and got[k].shape == v.shape else v
                                 for k, v in fresh.items()})
    load_flax_params(model, params)
    path = ckpt_lib.save_checkpoint(output, 0, model.state_dict(),
                                    cfg_dict=cfg.convert_to_dict())
    log(f'saved imported checkpoint to {path}')
    return path, report


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--checkpoint', required=True,
                        help='reference Lightning .ckpt (or raw torch state_dict)')
    parser.add_argument('--output', required=True, help='output checkpoint directory')
    parser.add_argument('--config-file', default='', metavar='FILE')
    parser.add_argument('opts', nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)
    return import_checkpoint(args.checkpoint, args.output, args.config_file, args.opts)[0]


if __name__ == '__main__':
    main()
