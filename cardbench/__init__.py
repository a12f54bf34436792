"""The benchmark of the PyTorch and CUDA port (``stp3_tpu_torch``) on one or
more NVIDIA GPUs.

``python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything that
belongs to one configuration, traffic mix, cell or per-layer metric sits
in a file of its own, found by its name:

- ``configs/<config>.json``: the stage configuration as run, with its
  source, precision, the keys changed from the source and the sizes
  assumed;
- ``traffic/<traffic>.json``: the parameters that ``generate.py`` reads;
- ``workloads/<cell>.json``: the entry kind, the sample the comparison
  draws, the traced steps and each compared number's limit;
- ``entries/<kind>.py``: set-up, one timed step, and what the comparison
  is handed;
- ``metrics/<metric>.py``: reads one per-layer metric from the traced
  window;
- ``reference/``: the plain PyTorch reference and the comparison;
- ``counts/``: operation and byte counts, computed from shapes.
"""
