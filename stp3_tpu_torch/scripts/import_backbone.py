"""Import a bare efficientnet-pytorch ImageNet .pth into a checkpoint of
this package, for PRETRAINED.PATH (counterpart of scripts/import_backbone.py).

    python -m stp3_tpu_torch.scripts.import_backbone \
        --weights /path/to/efficientnet-b4-*.pth --output ./imagenet_init \
        [--config-file stp3_tpu/configs/nuscenes/Perception.yml] [KEY VALUE ...]

The reference's encoder starts from EfficientNet.from_pretrained(cfg.NAME)
(reference stp3/models/encoder.py:18): every published metric assumes an
ImageNet backbone. This maps the file's _conv_stem/_bn0/_blocks.N.*
tensors onto the encoder trunk ('bn_frozen' Norms carrying the ImageNet
running statistics), leaves every other module at the seeded init, and
writes ``<output>/step_0``. With ``PRETRAINED.LOAD_WEIGHTS True`` and
``PRETRAINED.PATH`` pointing at it, ``stp3_tpu_torch.train`` takes every
entry whose name and shape match (``filter_warm_start_params``). The file
is read with ``torch.load(weights_only=True)``. Host-side: nothing runs on
a device.
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
from stp3_tpu_torch.utils.from_flax import load_flax_params, to_flax


def import_backbone(weights: str, output: str, config_file: str = '',
                    opts: Optional[Sequence[str]] = None,
                    log: Callable[[str], None] = print) -> Tuple[str, ti.ImportReport]:
    """Convert ``weights`` and save the model under ``output``; returns
    (the saved step directory, the import report)."""
    cfg = get_cfg(argparse.Namespace(config_file=config_file, opts=list(opts or [])))
    cfg.MODEL.NORM = 'bn_frozen'           # carry the ImageNet running statistics
    mcfg = STP3Config.from_cfg(cfg)

    subtree, report = ti.import_backbone_state_dict(
        ti.reference_state_dict(ti.load_reference_blob(weights)), mcfg.encoder_name,
        strict=False)
    log(f'converted {report.converted} tensors; ignored {len(report.ignored)} '
        f'classifier / truncated keys')
    if report.missing:
        log(f'WARNING: {len(report.missing)} expected keys missing, e.g. {report.missing[:5]}')
    if report.unexpected:
        log(f'WARNING: {len(report.unexpected)} unknown keys, e.g. {report.unexpected[:5]}')

    model = init_parameters(STP3(mcfg), torch.Generator().manual_seed(0))
    load_flax_params(model, ti.merge_backbone(to_flax(model)['params'], subtree))
    path = ckpt_lib.save_checkpoint(output, 0, model.state_dict(),
                                    cfg_dict=cfg.convert_to_dict())
    log(f'saved ImageNet-initialised checkpoint to {path}')
    return path, report


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--weights', required=True,
                        help='bare efficientnet-pytorch state_dict (.pth)')
    parser.add_argument('--output', required=True, help='output checkpoint directory')
    parser.add_argument('--config-file', default='', metavar='FILE')
    parser.add_argument('opts', nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)
    return import_backbone(args.weights, args.output, args.config_file, args.opts)[0]


if __name__ == '__main__':
    main()
