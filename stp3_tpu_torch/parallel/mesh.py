"""Multi-process data parallel on ``torch.distributed`` (counterpart of
stp3_tpu/parallel/mesh.py; the reference trains with Lightning DDP, one
process per GPU, reference train.py:43-56).

One process per card: ``torchrun --nproc_per_node N -m
stp3_tpu_torch.train ...`` starts N ranks, each on ``cuda:LOCAL_RANK``,
with NCCL between cards (gloo on the CPU). Each rank loads its own
contiguous rows of every global batch (``NumpyLoader``'s rank / world
split; ``BATCHSIZE`` is per process, as in stp3_tpu) and takes one step on
them; what one jitted program over a batch-sharded mesh gives stp3_tpu
for free is made explicit here and in its callers:

  * the gradients: one flat all-reduce per dtype, SUM then divide by the
    world (``allreduce_gradients``; ``Trainer.compute_gradients``), before
    the clip, which so sees the global gradient;
  * the loss denominators: ``losses.spatial_regression_loss`` divides by
    the mask count over the global batch (``group=``);
  * the BatchNorm statistics: 'bn' sites sum Σx, Σx² and the count over
    the ranks with a differentiable all-reduce
    (``layers.base.Norm._batch_stats``, ``differentiable_all_reduce``);
  * the metric states: summed at ``compute()`` (``allreduce_host_tree``);
  * the starting parameters: rank 0's, broadcast at start, after a warm
    start and after a resume (``broadcast_module``).

The step goes through ``functional_call`` on bf16 copies of the
parameters, which ``DistributedDataParallel``'s hooks never see, so the
gradients are reduced by hand, after the backward, in one flat buffer a
dtype: at 10.6 M parameters one 42 MB call, no bucket overlap with the
backward (a host-bound step leaves the card idle most of the time
anyway).

Not ported, because one process per card has no use for them: ``make_mesh``,
``batch_sharding`` and ``replicated`` (a rank's tensors are its own; the
process group is the mesh), ``process_local``, ``host_value`` and
``host_tree`` (every tensor a rank holds is addressable: its rows, or a
replicated value after a collective).
"""
from __future__ import annotations

import collections
import datetime
import itertools
import os
from typing import Any, Dict, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from stp3_tpu_torch.utils.device import resolve_device

# torchrun's environment: a process started without it is a run of one
_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')
# the longest a collective waits for the other ranks (stp3_tpu's barrier's
# 30 minutes: ranks may be minutes apart around a first step's set-up)
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=30)


def maybe_initialize_multihost(device=None, backend: Optional[str] = None) -> torch.device:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) and return this
    rank's device: ``device`` if named, else ``cuda:LOCAL_RANK``. The
    backend is ``backend`` if named, else NCCL for a CUDA device and gloo
    for the CPU; a failed start raises (no other backend is tried). Every
    collective waits at most ``COLLECTIVE_TIMEOUT``. Without ``RANK`` in the
    environment (a run of one process) only the device is resolved; a
    group already up is kept."""
    if 'RANK' not in os.environ:
        return resolve_device(device)
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f'RANK is set but not {missing}: start the ranks with torchrun')
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU (gloo)")
        device = torch.device('cuda', int(os.environ['LOCAL_RANK']))
    device = torch.device(device)
    if dist.is_initialized():
        return device
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
    kw = {'device_id': device} if backend == 'nccl' else {}
    dist.init_process_group(backend, init_method='env://',
                            rank=int(os.environ['RANK']),
                            world_size=int(os.environ['WORLD_SIZE']),
                            timeout=COLLECTIVE_TIMEOUT, **kw)
    return device


def data_group():
    """The default process group once one is up, else None (a run of one
    process, which no collective touches)."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def process_index(group=None) -> int:
    return dist.get_rank(group) if group is not None else 0


def process_count(group=None) -> int:
    return dist.get_world_size(group) if group is not None else 1


def is_main_process() -> bool:
    """True on the process that owns side effects (checkpoint writes,
    the ``best`` pointer, the log): rank 0, Lightning's convention."""
    return process_index(data_group()) == 0


def rank_seed(seed: int, rank: int) -> int:
    """This rank's seed for its ``torch.Generator``: ``seed`` on rank 0
    (a run of one rank draws what a run of one process draws), a value
    derived from (seed, rank) elsewhere."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence((int(seed), int(rank))).generate_state(1)[0])


def collective_device(group) -> torch.device:
    """Where a host value goes for a collective of ``group``: the current
    card under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def coordination_barrier(group=None) -> None:
    """Every rank of ``group`` (default: the default group) waits here;
    no-op without a process group. Bounded by the group's timeout."""
    group = group if group is not None else data_group()
    if group is None:
        return
    if dist.get_backend(group) == 'nccl':
        dist.barrier(group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group)


def broadcast_string(s: str, group=None) -> str:
    """Rank 0's string on every rank (the run directory must be one
    directory); ``s`` itself without a process group."""
    group = group if group is not None else data_group()
    if group is None:
        return s
    box = [s]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group,
                               device=collective_device(group))
    return box[0]


def allreduce_host_tree(tree: Mapping[str, Any], group=None) -> Dict[str, np.ndarray]:
    """A dict of additive host values (metric states: int64 counts,
    float64 sums) summed over the ranks of ``group``, each leaf with its
    dtype and shape (Lightning's ``dist_reduce_fx='sum'``, reference
    stp3/metrics.py:32-35). Without a group, the values themselves."""
    group = group if group is not None else data_group()
    if group is None:
        return {k: np.asarray(v) for k, v in tree.items()}
    dev = collective_device(group)
    out = {}
    for k, v in tree.items():
        a = np.asarray(v)
        t = torch.as_tensor(np.ascontiguousarray(a)).to(dev)
        dist.all_reduce(t, group=group)
        out[k] = t.cpu().numpy().astype(a.dtype).reshape(a.shape)
    return out


def broadcast_module(module: torch.nn.Module, group) -> None:
    """Rank 0's parameters and buffers into every rank's ``module``, in
    place, one flat broadcast per dtype."""
    tensors = [t for t in itertools.chain(module.parameters(), module.buffers())]
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for same in _by_dtype(tensors):
            flat = torch.cat([t.reshape(-1) for t in same])
            dist.broadcast(flat, src=src, group=group)
            _unflatten_into(flat, same)


def allreduce_gradients(parameters: Iterable[torch.nn.Parameter], group) -> None:
    """Every parameter's gradient replaced by its mean over the ranks of
    ``group``: one flat all-reduce (SUM) per dtype, then a division by the
    world size. Parameters without a gradient are left alone; every rank
    runs the same graph, so the same ones have none."""
    grads = [p.grad for p in parameters if p.grad is not None]
    world = dist.get_world_size(group)
    for same in _by_dtype(grads):
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        _unflatten_into(flat, same)


def allreduce_mean(values: Mapping[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """A dict of scalar tensors of one dtype and device averaged over the
    ranks (the per-rank loss terms -> the global batch's), in one call."""
    keys = list(values)
    flat = torch.stack([values[k].reshape(()) for k in keys])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    return dict(zip(keys, flat.unbind()))


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks; its gradient is the SUM of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def differentiable_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, differentiable (the
    backward sums the ranks' gradients, as SyncBatchNorm's does)."""
    return _AllReduceSum.apply(x, group)


def shard_batch(batch: Mapping[str, Any], device, group=None) -> Dict[str, Any]:
    """This rank's rows of a GLOBAL host batch, on ``device``: the
    rank-th contiguous block, the rows ``NumpyLoader(rank=, world=)``
    gives that rank. A batch that does not divide over the ranks raises,
    as stp3_tpu's ``shard_batch`` does (the loaders pad every rank to equal
    batches, so a mismatch is a wiring fault)."""
    group = group if group is not None else data_group()
    rank, world = process_index(group), process_count(group)
    n = len(next(iter(batch.values())))
    if n % world:
        raise ValueError(f'global batch {n} does not divide over {world} ranks')
    lo, hi = rank * n // world, (rank + 1) * n // world
    return batch_to_device({k: np.asarray(v)[lo:hi] for k, v in batch.items()}, device)


def batch_to_device(batch: Mapping[str, Any], device) -> Dict[str, Any]:
    """The batch's arrays as tensors on ``device``; the loader's per-row
    ``valid`` mask stays a host numpy array (``Trainer.val_step`` reads it
    on the host)."""
    return {k: np.asarray(v) if k == 'valid' else torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def default_prefetch_size(device) -> int:
    """Batches in flight ahead of the consumer: 2 on a card (one copying
    while one waits), 0 on the CPU (nothing to overlap). stp3_tpu keeps 0
    by default because its prefetch is a host thread that took the
    loader's only core; this one starts no thread: the copies run on a
    side CUDA stream."""
    return 2 if torch.device(device).type == 'cuda' else 0


def prefetch_to_device(iterator: Iterable[Mapping[str, Any]],
                       device) -> Iterator[Dict[str, Any]]:
    """The host batches of ``iterator`` on ``device``,
    ``default_prefetch_size`` batches ahead of the consumer: each batch's
    arrays are pinned and copied on a side CUDA stream, and the consumer's
    stream waits on an event recorded after the copies, so the copy
    overlaps the step before it instead of waiting for the stream to
    drain. On the CPU, a plain copy on the caller's thread."""
    device = torch.device(device)
    size = default_prefetch_size(device)
    if size == 0:
        for batch in iterator:
            yield batch_to_device(batch, device)
        return
    side = torch.cuda.Stream(device)

    def issue(batch):
        # the pinned buffers may go once the copies are queued: the host
        # allocator keeps a block until the copy that reads it has run
        host = {k: np.asarray(v) if k == 'valid' else
                torch.as_tensor(np.asarray(v)).pin_memory() for k, v in batch.items()}
        with torch.cuda.stream(side):
            dev = {k: v if k == 'valid' else v.to(device, non_blocking=True)
                   for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return dev, ready

    it = iter(iterator)
    queue = collections.deque(issue(b) for b in itertools.islice(it, size))
    while queue:
        dev, ready = queue.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(ready)
        for v in dev.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(consumer)          # made on the side stream
        nxt = next(it, None)
        if nxt is not None:
            queue.append(issue(nxt))
        yield dev


def _by_dtype(tensors):
    """The tensors grouped by (dtype, device), in order of first appearance."""
    groups: Dict[Any, list] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


def _unflatten_into(flat: torch.Tensor, tensors) -> None:
    """Copy consecutive pieces of ``flat`` into ``tensors``."""
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n
