"""Multi-process data parallel (``mesh``) and camera-parallel serving
(``serving``) on ``torch.distributed``, one process per card;
``launch`` starts a group of ranks on one host with a deadline."""
