"""The port's one-command checkpoint-import dress rehearsal
(stp3_tpu_torch/scripts/dress_rehearsal.py) on the CPU: a synthesised
reference-format .ckpt through the import CLI, then ``evaluate`` on the
stand-in nuScenes tree of tests/torch_fake_datasets.py with its figures.
It prints the JAX rehearsal's result keys (those of the JAX package's
``evaluate`` for the configuration, which tests/test_torch_eval.py holds
the port's to), each finite; the stand-in devkit is gone afterwards (the modules named
'nuscenes' are those before the call). The stage scripts
(stp3_tpu_torch/scripts/*.sh) pass the JAX package's scripts' arguments
to the port's CLIs."""
import glob
import os
import re
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
from stp3_tpu_torch.config import get_cfg
from stp3_tpu_torch.scripts import dress_rehearsal

torch.set_num_threads(2)


def test_dress_rehearsal_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)              # the figures go to ./imgs_eval/<TAG>
    devkit = {k: v for k, v in sys.modules.items() if k.split('.')[0] == 'nuscenes'}
    results = dress_rehearsal.main(str(tmp_path / 'work'), keep_visualisations=True,
                                   device='cpu')
    out = capsys.readouterr().out
    cfg = get_cfg(cfg_dict=None)
    cfg.merge_from_list(dress_rehearsal.tiny_cfg_opts(''))
    keys = set(chip_smoke.planning_result_keys(cfg))           # evaluate.py:126-140
    keys |= {f'vehicle_{k}' for k in ('pq', 'sq', 'rq')} if cfg.INSTANCE_SEG.ENABLED else set()
    assert set(results) == keys and any(k.startswith('plan_L2') for k in keys)
    assert all(np.isfinite(v) for v in results.values())
    printed = {line.split(' : ')[0] for line in out.splitlines() if ' : ' in line}
    assert printed == keys
    assert '[3/3] evaluate produced' in out and 'dress rehearsal OK' in out
    assert os.path.isfile(tmp_path / 'work' / 'imported' / 'step_0' / 'config.json')
    assert os.path.isfile(tmp_path / 'imgs_eval' / cfg.TAG / '0000.png')
    assert {k: v for k, v in sys.modules.items() if k.split('.')[0] == 'nuscenes'} == devkit


def test_stage_scripts_run_the_ports_clis_with_the_jax_scripts_arguments():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ours = sorted(glob.glob(os.path.join(root, 'stp3_tpu_torch', 'scripts', '*.sh')))
    assert [os.path.basename(p) for p in ours] == [
        'eval_plan.sh', 'train_perceive.sh', 'train_plan.sh', 'train_prediction.sh']

    def command(path):
        text = open(path).read().replace('\\\n', ' ')
        line, = [ln for ln in text.splitlines() if ln.startswith('python')]
        return line.split(None, 2)

    for path in ours:
        assert subprocess.run(['bash', '-n', path]).returncode == 0, path
        name = os.path.basename(path)
        _, module, args = command(path)
        _, _, jax_args = command(os.path.join(root, 'scripts', name))
        _, script, _ = command(os.path.join(root, 'scripts', name))
        want = {'train.py': 'stp3_tpu_torch.train', 'evaluate.py': 'stp3_tpu_torch.evaluate'}
        assert module == '-m' and args.split(None, 1)[0] == want[script], name
        assert re.sub(r'\s+', ' ', args.split(None, 1)[1]) == re.sub(r'\s+', ' ', jax_args), name
