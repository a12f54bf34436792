"""The port's weight-interchange CLIs, run as
``python -m stp3_tpu_torch.scripts.<name>``: ``import_torch_checkpoint``,
``export_torch_checkpoint`` and ``import_backbone``."""
