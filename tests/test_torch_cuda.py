"""The port's hand-written kernels (K1 with its v1 / v2 entries, K2, K3,
K4) and their autograd wirings against their plain versions on an NVIDIA
GPU. Imports no jax, so it runs on a machine with the card (and
no jax: --noconftest skips tests/conftest.py, which sets jax up):

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

Without a card every test skips (the decision is taken inside the
fixture, never at import).
"""
import pytest
import torch

from stp3_tpu_torch.ops.kernels import bev_splat as K1
from stp3_tpu_torch.ops.kernels import convnext_mlp as K2
from stp3_tpu_torch.ops.kernels import lift_splat as K4

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernels have no CPU or interpret mode)')
    return torch.device('cuda', 0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c', [8, 40, 64])
def test_bev_splat_kernel_matches_plain(cuda, dtype, c):
    gen = torch.Generator().manual_seed(c)
    f, p, ncells = 3, 1001, 97          # P not a multiple of a block's 8 warps
    feats = torch.randn(f, p, c, generator=gen).to(cuda, dtype)
    ranks = torch.randint(0, ncells + 1, (f, p), generator=gen, dtype=torch.int32).to(cuda)
    n = K1.bev_splat_accumulate.launches
    got = K1.bev_splat_accumulate(feats, ranks, ncells)
    assert K1.bev_splat_accumulate.launches == n + 1
    want = K1.bev_splat_accumulate_plain(feats, ranks, ncells)
    torch.cuda.synchronize()
    # fp32 on both sides; the atomics only reorder the sums
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', ['one_rank', 'all_invalid', 'ragged'])
@pytest.mark.parametrize('c', [3, 16, 64])
def test_bev_splat_kernel_edge_cases_match_plain(cuda, dtype, case, c):
    """Every point on one rank (one run a tile: maximum contention), every
    point dropped, and P = 2 x 4096 + 77 (a ragged last tile of 77
    points), over both row paths: 16-byte vectors (C = 16, 64) and scalars
    (C = 3). Ranks stay in [0, ncells], the plain version's domain."""
    gen = torch.Generator().manual_seed(c)
    f, p, ncells = 2, 2 * 4096 + 77, 97
    feats = torch.randn(f, p, c, generator=gen).to(cuda, dtype)
    ranks = {'one_rank': torch.full((f, p), 5, dtype=torch.int32),
             'all_invalid': torch.full((f, p), ncells, dtype=torch.int32),
             'ragged': torch.randint(0, ncells + 1, (f, p), generator=gen, dtype=torch.int32),
             }[case].to(cuda)
    n = K1.bev_splat_accumulate.launches
    got = K1.bev_splat_accumulate(feats, ranks, ncells)
    assert K1.bev_splat_accumulate.launches == n + 1
    want = K1.bev_splat_accumulate_plain(feats, ranks, ncells)
    torch.cuda.synchronize()
    # fp32 sums on both sides, in another order (runs of up to 1,024 rows)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    if case == 'all_invalid':
        assert not got.any()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n', [1, 63, 64, 65, 500, 2049, 240000])
def test_convnext_mlp_kernel_matches_plain(cuda, dtype, n):
    gen = torch.Generator().manual_seed(n)
    c = 64

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(cuda)

    h, x = rnd(n, c).to(dtype), rnd(n, c).to(dtype)
    weights = (rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1), rnd(c, 4 * c, scale=0.125),
               rnd(4 * c, scale=0.1), rnd(4 * c, c, scale=0.0625), rnd(c, scale=0.1),
               rnd(c, scale=0.5))
    k = K2.convnext_mlp.launches
    got = K2.convnext_mlp(h, x, *weights)
    assert K2.convnext_mlp.launches == k + 1 and got.dtype == dtype
    want = K2.convnext_mlp_plain(h, x, *weights)
    # the bf16 matmul operands can round one ULP apart (tests/test_convnext_kernel.py)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize('c', [16, 32])
def test_convnext_mlp_kernel_refuses_a_width_it_was_not_built_for(cuda, c):
    gen = torch.Generator().manual_seed(c)
    args = [torch.randn(*shape, generator=gen).to(cuda) for shape in (
        (100, c), (100, c), (c,), (c,), (c, 4 * c), (4 * c,), (4 * c, c), (c,), (c,))]
    args[:2] = [a.to(torch.bfloat16) for a in args[:2]]
    n = K2.convnext_mlp.launches
    with pytest.raises(ValueError, match='built for C=64'):
        K2.convnext_mlp(*args)
    assert K2.convnext_mlp.launches == n


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c', [8, 40, 64, 3])
def test_gather_rows_kernel_equals_plain(cuda, dtype, c):
    """16-byte vectors (C = 8, 40, 64), 4-byte (C = 3, fp32), 2-byte
    (C = 3, bf16); ranks outside [0, ncells) give zeros."""
    gen = torch.Generator().manual_seed(c)
    f, p, ncells = 3, 1001, 97
    table = torch.randn(f, ncells, c, generator=gen).to(cuda, dtype)
    ranks = torch.randint(-2, ncells + 3, (f, p), generator=gen, dtype=torch.int32).to(cuda)
    n = K1.gather_rows.launches
    got = K1.gather_rows(table, ranks)
    assert K1.gather_rows.launches == n + 1 and got.dtype == dtype
    want = K1.gather_rows_plain(table, ranks)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not got[(ranks < 0) | (ranks >= ncells)].any()


def test_gather_rows_kernel_refuses_what_it_cannot_launch(cuda):
    table = torch.zeros(2, 5, 8, device=cuda)
    with pytest.raises(TypeError):
        K1.gather_rows(table.double(), torch.zeros(2, 3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        K1.gather_rows(table.transpose(1, 2), torch.zeros(2, 3, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bev_splat_backward_is_k3(cuda, dtype):
    gen = torch.Generator().manual_seed(1)
    f, p, c, ncells = 3, 1001, 64, 97
    feats = torch.randn(f, p, c, generator=gen).to(cuda, dtype)
    ranks = torch.randint(0, ncells + 1, (f, p), generator=gen, dtype=torch.int32).to(cuda)
    g = torch.randn(f, ncells, c, generator=gen).to(cuda, dtype)
    grads = []
    for splat in (K1.bev_splat, K1.bev_splat_plain):
        x = feats.clone().requires_grad_(True)
        n = K1.gather_rows.launches
        splat(x, ranks, ncells).backward(g)
        grads.append((x.grad, K1.gather_rows.launches - n))
    torch.cuda.synchronize()
    (got, k3), (want, none) = grads
    assert (k3, none) == (1, 0) and got.dtype == dtype
    assert torch.equal(got, want)


def test_convnext_mlp_backward_matches_plain_autograd(cuda):
    gen = torch.Generator().manual_seed(2)
    n, c = 2049, 64

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(cuda, torch.bfloat16)

    inputs = (rnd(n, c), rnd(n, c), rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
              rnd(c, 4 * c, scale=0.125), rnd(4 * c, scale=0.1), rnd(4 * c, c, scale=0.0625),
              rnd(c, scale=0.1), rnd(c, scale=0.5))
    gy = rnd(n, c)
    grads = []
    for fn in (K2.convnext_mlp, K2.convnext_mlp_plain):
        args = [t.clone().requires_grad_(True) for t in inputs]
        fn(*args).backward(gy)
        grads.append([a.grad.float() for a in args])
    # the Function's backward is autograd through the same plain version
    for got, want in zip(*grads):
        assert (got - want).norm() <= 1e-3 * want.norm()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('entry', ['bev_pool_v1', 'bev_pool_v2'])
def test_per_frame_entries_launch_k1_and_match_plain(cuda, entry, dtype):
    fn = getattr(K1, entry)
    gen = torch.Generator().manual_seed(5)
    p, c, ncells = 1001, 64, 97
    feats = torch.randn(p, c, generator=gen).to(cuda, dtype).requires_grad_(True)
    ranks = torch.randint(0, ncells + 1, (p,), generator=gen, dtype=torch.int32).to(cuda)
    g = torch.randn(ncells, c, generator=gen).to(cuda, dtype)
    counts = (fn.launches, K1.bev_splat_accumulate.launches, K1.gather_rows.launches)
    got = fn(feats, ranks, ncells)
    got.backward(g)
    assert (fn.launches, K1.bev_splat_accumulate.launches, K1.gather_rows.launches) == (
        counts[0] + 1, counts[1], counts[2] + 1)
    want = K1.bev_splat_plain(feats.detach()[None], ranks[None], ncells)[0]
    torch.cuda.synchronize()
    assert got.dtype == feats.grad.dtype == dtype
    # fp32 sums on both sides, reordered by the atomics; bf16 outputs may
    # then round one ULP apart
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.detach().float(), want.float(), **tol)
    want_grad = K1.gather_rows_plain(g[None], ranks[None])[0]
    assert torch.equal(feats.grad, want_grad)


@pytest.mark.parametrize('dtypes', [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize('c', [8, 64, 40])
def test_lift_splat_kernel_matches_plain(cuda, dtypes, c):
    ctx_dt, dp_dt = dtypes
    gen = torch.Generator().manual_seed(c)
    f, r, p, ncells = 3, 37, 1001, 97
    ctx = torch.randn(f, r, c, generator=gen).to(cuda, ctx_dt)
    dp = torch.rand(f, p, generator=gen).to(cuda, dp_dt)
    ranks = torch.randint(0, ncells + 1, (f, p), generator=gen, dtype=torch.int32).to(cuda)
    rays = torch.randint(0, r, (p,), generator=gen, dtype=torch.int32).to(cuda)
    n = K4.lift_splat_accumulate.launches
    got = K4.lift_splat_accumulate(ctx, dp, ranks, rays, ncells)
    assert K4.lift_splat_accumulate.launches == n + 1
    want = K4.lift_splat_accumulate_plain(ctx, dp, ranks, rays, ncells)
    torch.cuda.synchronize()
    # fp32 on both sides; the atomics only reorder the sums
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dtypes', [(torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.float32)])
@pytest.mark.parametrize('case', ['one_rank', 'all_invalid', 'ragged'])
@pytest.mark.parametrize('c', [3, 16, 64])
def test_lift_splat_kernel_edge_cases_match_plain(cuda, dtypes, case, c):
    """K4's tile sort at its edges, as K1's: every point on one rank (one
    run a tile: maximum contention), every point dropped, and P = 2 x 4096
    + 77 (a ragged last tile of 77 points), over both row paths: 16-byte
    vectors (C = 16, 64) and scalars (C = 3); every 97th point reads the
    table's last row (ray id R - 1). Ranks stay in [0, ncells] and ray ids
    in [0, R), the plain version's domain."""
    ctx_dt, dp_dt = dtypes
    gen = torch.Generator().manual_seed(c)
    f, r, p, ncells = 2, 37, 2 * 4096 + 77, 97
    ctx = torch.randn(f, r, c, generator=gen).to(cuda, ctx_dt)
    dp = torch.rand(f, p, generator=gen).to(cuda, dp_dt)
    ranks = {'one_rank': torch.full((f, p), 5, dtype=torch.int32),
             'all_invalid': torch.full((f, p), ncells, dtype=torch.int32),
             'ragged': torch.randint(0, ncells + 1, (f, p), generator=gen, dtype=torch.int32),
             }[case].to(cuda)
    rays = torch.randint(0, r, (p,), generator=gen, dtype=torch.int32)
    rays[::97] = r - 1
    rays = rays.to(cuda)
    n = K4.lift_splat_accumulate.launches
    got = K4.lift_splat_accumulate(ctx, dp, ranks, rays, ncells)
    assert K4.lift_splat_accumulate.launches == n + 1
    want = K4.lift_splat_accumulate_plain(ctx, dp, ranks, rays, ncells)
    torch.cuda.synchronize()
    # fp32 sums on both sides, in another order (runs of up to 1,024 rows)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    if case == 'all_invalid':
        assert not got.any()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_lift_splat_backward_matches_plain_autograd(cuda, dtype):
    """LiftSplat (K4 forward; _ls_bwd's backward with K3's row gather)
    against autograd through the plain version; both reorder fp32 sums
    (index_add_ over ray ids), hence a tolerance."""
    gen = torch.Generator().manual_seed(3)
    f, r, p, c, ncells = 3, 37, 1001, 64, 97
    ctx = torch.randn(f, r, c, generator=gen).to(cuda, dtype)
    dp = torch.rand(f, p, generator=gen).to(cuda, dtype)
    ranks = torch.randint(0, ncells + 1, (f, p), generator=gen, dtype=torch.int32).to(cuda)
    rays = torch.randint(0, r, (p,), generator=gen, dtype=torch.int32).to(cuda)
    g = torch.randn(f, ncells, c, generator=gen).to(cuda, dtype)
    grads = []
    for fn in (K4.lift_splat_frames, K4.lift_splat_plain):
        a, b = ctx.clone().requires_grad_(True), dp.clone().requires_grad_(True)
        k3 = K1.gather_rows.launches
        fn(a, b, ranks, rays, ncells).backward(g)
        grads.append((a.grad, b.grad, K1.gather_rows.launches - k3))
    torch.cuda.synchronize()
    (ga, gb, k3), (wa, wb, none) = grads
    assert (k3, none) == (1, 0) and ga.dtype == gb.dtype == dtype
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(ga.float(), wa.float(), **tol)
    torch.testing.assert_close(gb.float(), wb.float(), **tol)


def _out_of_range_ranks(f, p, ncells, gen):
    """Ranks over [-3, ncells + 3): about a tenth of them outside [0, ncells)."""
    return torch.randint(-3, ncells + 3, (f, p), generator=gen, dtype=torch.int32)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('entry', ['bev_splat', 'bev_pool_v1', 'bev_pool_v2'])
def test_k1_drops_out_of_range_ranks_as_plain(cuda, entry, dtype):
    """K1 and its per-frame entries against the plain version on ranks
    below 0 and at or above ncells, which both drop."""
    gen = torch.Generator().manual_seed(21)
    f, p, c, ncells = (3 if entry == 'bev_splat' else 1), 4096 + 77, 64, 61
    feats = torch.randn(f, p, c, generator=gen).to(cuda, dtype)
    ranks = _out_of_range_ranks(f, p, ncells, gen).to(cuda)
    want = K1.bev_splat_accumulate_plain(feats, ranks, ncells)
    if entry == 'bev_splat':
        got = K1.bev_splat_accumulate(feats, ranks, ncells)
    else:
        got = getattr(K1, entry)(feats[0], ranks[0], ncells)[None].float()
        want = want.to(dtype).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_k4_drops_out_of_range_ranks_and_ray_ids_as_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(22)
    f, r, p, c, ncells = 2, 300, 4096 + 77, 64, 61
    ctx = torch.randn(f, r, c, generator=gen).to(cuda, dtype)
    dp = torch.rand(f, p, generator=gen).to(cuda, dtype)
    ranks = _out_of_range_ranks(f, p, ncells, gen).to(cuda)
    rays = torch.randint(-5, r + 5, (p,), generator=gen, dtype=torch.int32).to(cuda)
    got = K4.lift_splat_accumulate(ctx, dp, ranks, rays, ncells)
    want = K4.lift_splat_accumulate_plain(ctx, dp, ranks, rays, ncells)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize('f,p', [(9, 483840), (18, 196608)])
def test_k1_and_k3_at_the_perception_shapes_match_plain(cuda, f, p):
    """K1 and its backward K3 at the Perception train steps' splats:
    nuScenes at batch 3 (F = 9 frames of 483,840 points) and CARLA at
    batch 6 (F = 18 of 196,608), 64 bf16 channels onto 200 x 200 cells,
    about half the points outside the grid (rank ncells)."""
    gen = torch.Generator().manual_seed(f)
    c, ncells = 64, 40000
    feats = torch.randn(f, p, c, generator=gen).to(cuda, torch.bfloat16)
    ranks = torch.randint(0, 2 * ncells, (f, p), generator=gen, dtype=torch.int32)
    ranks = torch.where(ranks < ncells, ranks, ncells).to(cuda)
    got = K1.bev_splat_accumulate(feats, ranks, ncells)
    want = K1.bev_splat_accumulate_plain(feats, ranks, ncells)
    table = torch.randn(f, ncells, c, generator=gen).to(cuda, torch.bfloat16)
    rows = K1.gather_rows(table, ranks)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    assert torch.equal(rows, K1.gather_rows_plain(table, ranks))


@pytest.mark.parametrize('kind', ['bn', 'bn_frozen'])
def test_batch_norm_model_on_the_card_matches_the_cpu(cuda, kind):
    """The tiny Perception model under MODEL.NORM 'bn' / 'bn_frozen' in
    fp32 (TF32 off), the same seeded weights on both devices: the
    train-mode forward (batch statistics; 'bn' moves its running
    statistics once) and then the eval forward on the running statistics,
    every head at atol 2e-3, rtol 1e-3, the running statistics at rtol
    1e-4, atol 1e-5."""
    import copy

    import torch_fixtures
    from stp3_tpu_torch.layers.base import init_parameters
    from stp3_tpu_torch.models.stp3 import STP3, STP3Config
    from stp3_tpu_torch.utils.precision import pin_fp32_math
    pin_fp32_math()
    cfg = torch_fixtures.stage_cfg('perception', True, {'MODEL': {'NORM': kind}})
    cpu = init_parameters(STP3(STP3Config.from_cfg(cfg)), torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(cuda)
    inputs = torch_fixtures.example_inputs(cfg, b=2)[0]
    outs = {}
    for name, model, dev in (('cpu', cpu, 'cpu'), ('cuda', gpu, cuda)):
        args = [torch.as_tensor(a, device=dev) for a in inputs]
        with torch.no_grad():
            model.train()
            trained = model(*args, train=True, dropout=False)
            model.eval()
            evaluated = model(*args)
        outs[name] = (trained, evaluated, {n: b.cpu() for n, b in model.named_buffers()
                                           if n.endswith(('.mean', '.var'))})
    for want, got in zip(outs['cpu'][:2], outs['cuda'][:2]):
        for key in ('segmentation', 'pedestrian', 'hdmap'):
            torch.testing.assert_close(got[key].cpu(), want[key], atol=2e-3, rtol=1e-3)
    for name, want in outs['cpu'][2].items():
        torch.testing.assert_close(outs['cuda'][2][name], want, rtol=1e-4, atol=1e-5)


def test_imported_reference_checkpoint_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A seeded reference-format .ckpt of the tiny Planning stage through
    import_torch_checkpoint, loaded on both devices in fp32 (TF32 off):
    every head at atol 2e-3, rtol 1e-3, and the planner's refined
    trajectory on the same arguments."""
    import torch_fixtures
    from stp3_tpu_torch.config import get_cfg
    from stp3_tpu_torch.models.stp3 import STP3, STP3Config
    from stp3_tpu_torch.scripts.import_torch_checkpoint import import_checkpoint
    from stp3_tpu_torch.training import checkpoint as ckpt_lib
    from stp3_tpu_torch.utils.precision import pin_fp32_math
    pin_fp32_math()
    cfg = torch_fixtures.make_cfg(torch_fixtures.PLANNING_STAGE, torch_fixtures.TINY_WIDTHS,
                                  {'PRECISION': 32})
    torch_fixtures.write_reference_checkpoint(cfg, str(tmp_path / 'ref.ckpt'))
    path, report = import_checkpoint(str(tmp_path / 'ref.ckpt'), str(tmp_path / 'out'),
                                     log=lambda msg: None)
    assert report.ok()
    mcfg = STP3Config.from_cfg(get_cfg(cfg_dict=ckpt_lib.load_config_dict(path)))
    assert mcfg.norm == 'bn_frozen'
    (image, k, e, ego), ex = torch_fixtures.example_inputs(cfg)
    rf = cfg.TIME_RECEPTIVE_FIELD
    outs = {}
    for dev in ('cpu', cuda):
        model = STP3(mcfg)
        model.load_state_dict(ckpt_lib.load_checkpoint(path)['model'])
        model = model.to(dev).eval()
        with torch.no_grad():
            out = model(*(torch.as_tensor(a, device=dev) for a in (image, k, e, ego)))
            if 'cpu' in outs:       # the planner on the CPU's arguments
                args = [a.to(dev) for a in outs['cpu'][1]]
            else:
                occ = torch.logical_or(out['segmentation'].argmax(-1),
                                       out['pedestrian'].argmax(-1)).float()[:, rf:]
                args = [out['cam_front'], torch.as_tensor(ex['trajs']),
                        torch.as_tensor(ex['gt_trajs']), out['costvolume'][:, rf:], occ,
                        out['hdmap'], torch.tensor([1]), torch.as_tensor(ex['target_points'])]
            _, traj = model.plan(*args)
        outs['cpu' if dev == 'cpu' else 'cuda'] = (out, args, traj)
    for key in ('segmentation', 'pedestrian', 'hdmap', 'costvolume', 'cam_front'):
        torch.testing.assert_close(outs['cuda'][0][key].cpu(), outs['cpu'][0][key],
                                   atol=2e-3, rtol=1e-3)
    torch.testing.assert_close(outs['cuda'][2].cpu(), outs['cpu'][2], atol=2e-3, rtol=1e-3)


def _decode_case(seed, b=2, t=3, h=64, w=56):
    """Decoder-like heads: gaussian center blobs with offsets toward them
    and foreground discs, plus one crowded frame (more than 100 isolated
    peaks on a lattice) and one all-foreground frame."""
    import numpy as np
    rng = np.random.RandomState(seed)
    logits = np.zeros((b, t, h, w, 2), np.float32)
    centers = np.zeros((b, t, h, w, 1), np.float32)
    offsets = (rng.randn(b, t, h, w, 2) * 0.3).astype(np.float32)
    gx, gy = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    for i in range(b):
        for j in range(t):
            fg = np.zeros((h, w), bool)
            if (i, j) == (0, 0):
                centers[i, j, 1:-1:3, 1:-1:3, 0] = 0.2 + 0.8 * rng.rand(*gx[1:-1:3, 1:-1:3].shape)
                offsets[i, j] *= 6.0
                fg[1:-1, 1:-1] = True
            else:
                for ci, cj in zip(rng.randint(3, h - 3, 5), rng.randint(3, w - 3, 5)):
                    d2 = (gx - ci) ** 2 + (gy - cj) ** 2
                    centers[i, j, ..., 0] = np.maximum(centers[i, j, ..., 0], np.exp(-d2 / 4.0))
                    mask = d2 <= 9
                    fg |= mask
                    offsets[i, j][mask] = np.stack([ci - gx[mask], cj - gy[mask]], -1)
                if (i, j) == (1, 1):
                    fg[:] = True
            logits[i, j, ..., 1] = np.where(fg, 5.0, -5.0)
    return logits, centers, offsets


@pytest.mark.parametrize('seed', [0, 1])
def test_device_decode_on_the_card_matches_the_host_loop(cuda, seed):
    """utils/instance_jit.py on the card against the host numpy loop, id
    for id (crowded, all-foreground and blob frames)."""
    import numpy as np
    from stp3_tpu_torch.utils import instance as ti
    from stp3_tpu_torch.utils.instance_jit import decode_instances
    logits, centers, offsets = _decode_case(seed)
    got = decode_instances(*(torch.from_numpy(a).to(cuda) for a in
                             (logits, centers, offsets))).cpu().numpy()
    fg = logits.argmax(-1) == 1
    want = np.stack([np.stack([ti.get_instance_segmentation_and_centers(
        centers[i, j, ..., 0], offsets[i, j], fg[i, j])[0] for j in range(logits.shape[1])])
        for i in range(logits.shape[0])])
    np.testing.assert_array_equal(got, want)
    assert got[0, 0].max() == 100


def test_metric_increments_on_the_card_equal_the_cpus(cuda):
    """IoU counts and the planning metric's increments (trajectories off
    the grid on every side, occupancy blocks) computed on the card equal
    the CPU's: counts exactly, the L2 sums at rtol 1e-6."""
    import numpy as np
    from stp3_tpu_torch.config import get_cfg
    from stp3_tpu_torch.metrics import IoUMetric, PlanningMetric
    rng = np.random.RandomState(0)
    pred = torch.from_numpy(rng.randint(-1, 3, (2, 4, 50, 60)))
    target = torch.from_numpy(rng.randint(0, 3, (2, 4, 50, 60)))
    states = []
    for dev in ('cpu', cuda):
        m = IoUMetric(3)
        m.update(pred.to(dev), target.to(dev))
        states.append(m.state)
    for key, want in states[0].items():
        np.testing.assert_array_equal(states[1][key], want, err_msg=key)

    trajs = (rng.randn(4, 6, 3) * 30).astype(np.float32)
    gt = trajs + rng.randn(4, 6, 3).astype(np.float32)
    seg = torch.from_numpy((rng.rand(4, 6, 200, 200) > 0.99).astype(np.int64))
    incs = [PlanningMetric(get_cfg(), 6).increments(torch.from_numpy(trajs).to(dev),
                                                    torch.from_numpy(gt).to(dev),
                                                    seg.to(dev)).cpu()
            for dev in ('cpu', cuda)]
    assert torch.equal(incs[1][:2], incs[0][:2])
    torch.testing.assert_close(incs[1][2], incs[0][2], rtol=1e-6, atol=0)
    assert incs[0][1].sum() > 0


# ------------------------------------------------- compiled calls (CUDA graphs)
@pytest.fixture(scope='module')
def tiny_agent():
    """The tiny agent of tests/test_torch_agent.py (4 cameras at 64x64 at
    the JAX test config's widths, GRU state 2, fp32) on the card, seeded
    weights; TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA graphs have no CPU mode)')
    import torch_fixtures
    from stp3_tpu_torch.layers.base import init_parameters
    from stp3_tpu_torch.models.stp3 import STP3, STP3Config
    from stp3_tpu_torch.utils.precision import pin_fp32_math
    pin_fp32_math()
    cfg = torch_fixtures.make_cfg(torch_fixtures.TINY, {
        'BATCHSIZE': 1, 'PRECISION': 32,
        'IMAGE': {'FINAL_DIM': (64, 64), 'NAMES': ['A', 'B', 'C', 'D']}})
    model = init_parameters(STP3(STP3Config.from_cfg(cfg)), torch.Generator().manual_seed(0))
    return cfg, model.to('cuda').eval()


def _tick_inputs(cfg, device, full: bool):
    import numpy as np
    rng = np.random.RandomState(3)
    rf, h = cfg.TIME_RECEPTIVE_FIELD, cfg.IMAGE.FINAL_DIM[0]
    frames = torch.as_tensor(rng.randint(0, 256, (1, rf, 4, h, h, 3), np.uint8), device=device)
    ego = torch.as_tensor(np.tile(np.array([2.0, 0, 0, 0, 0, 0.01], np.float32), (1, rf, 1)),
                          device=device)
    trajs = torch.as_tensor(rng.randn(1, cfg.PLANNING.SAMPLE_NUM, cfg.N_FUTURE_FRAMES, 3),
                            dtype=torch.float32, device=device)
    cmd = torch.tensor([1], dtype=torch.int32, device=device)
    tp = torch.tensor([[0.0, 5.0]], device=device)
    return frames if full else frames[:, -1], frames, ego, trajs, cmd, tp


@pytest.mark.parametrize('mode', ['full', 'incremental', 'static'])
def test_agent_tick_graphs_equal_eager(tiny_agent, mode):
    """Each tick mode's compiled call (captured in AgentCore's warm-up) on
    one tick's arguments against the function it captured, run eagerly:
    the refined trajectory, the segmentation logits and the new BEV cache
    at rtol 1e-4, atol 1e-5 (K1 adds in fp32 atomics); the launches in the
    graph equal the eager call's; replays launch nothing."""
    from stp3_tpu_torch.deploy.agent_core import AgentCore
    from stp3_tpu_torch.ops.kernels import launch_counters
    cfg, model = tiny_agent
    kw = {'full': dict(incremental=False), 'incremental': dict(static_geometry=False),
          'static': {}}[mode]
    core = AgentCore(cfg, model, device='cuda', **kw)
    call = core._infer if mode == 'full' else core._serve
    assert call.captures == 1
    img, frames, ego, trajs, cmd, tp = _tick_inputs(cfg, 'cuda', mode == 'full')
    if mode == 'full':
        args = (img, ego, trajs, cmd, tp)
    else:
        cache = torch.stack([core._splat(frames[:, t])
                             for t in range(cfg.TIME_RECEPTIVE_FIELD - 1)], 1)
        args = (img, ego, cache, trajs, cmd, tp)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        want = call.fn(*args)
    eager = {name: fn.launches for name, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    got = call(*args)
    assert call.captures == 1
    assert all(fn.launches == 0 for fn in counters.values())
    assert call.launches_per_call == eager
    assert eager['bev_splat'] == (0 if mode == 'static' else 1)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[1]['segmentation'], want[1]['segmentation'],
                               rtol=1e-4, atol=1e-5)
    if mode != 'full':
        torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-5)


def test_a_capture_that_synchronises_raises(cuda):
    """A function that reads a value back to the host cannot be captured:
    the compiled call raises (no eager run on the card) and the device
    stays usable."""
    from stp3_tpu_torch.utils import graphs
    call = graphs.compiled(lambda x: x * x.sum().item())
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError, match='CUDA graph capture of .* failed'):
        call(x)
    assert call.captures == 0
    assert torch.cuda.current_stream(cuda) == torch.cuda.default_stream(cuda)
    assert torch.equal(x + 1, torch.full((4,), 2.0, device=cuda))
    assert torch.randn(3, device=cuda).isfinite().all()      # the generator left its capture
    with pytest.raises(ValueError, match='CUDA tensors only'):
        call(x, torch.ones(1))


def test_compiled_parameters_new_shapes_and_moved_storage(cuda):
    """A graph reads its module's parameters where they lay at capture:
    an in-place update (load_state_dict) is read, a new input shape
    captures a second graph, a parameter whose storage moved raises."""
    from stp3_tpu_torch.utils import graphs
    layer = torch.nn.Linear(8, 8).to(cuda)
    call = graphs.compiled(layer, layer)
    x = torch.randn(2, 8, device=cuda)
    with torch.no_grad():
        torch.testing.assert_close(call(x), layer(x))
        layer.load_state_dict({k: v * 2 for k, v in layer.state_dict().items()})
        torch.testing.assert_close(call(x), layer(x))
        torch.testing.assert_close(call(x[:1]), layer(x[:1]))
    assert call.captures == 2
    layer.weight.data = layer.weight.data.clone()
    with pytest.raises(RuntimeError, match='moved'):
        call(x)


# ------------------------------------- compiled training calls (CUDA graphs)
def _train_cfg(precision: int = 32, remat: str = 'encoder'):
    """The tiny Planning stage (torch_fixtures.planning_cfg(tiny=True)); in bf16
    with the temporal width at 64, K2's."""
    import torch_fixtures
    cfg = torch_fixtures.planning_cfg(tiny=True)
    cfg.PRECISION = precision
    cfg.MODEL.REMAT = remat
    if precision == 16:
        cfg.MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS = 64
    return cfg


@pytest.fixture(scope='module')
def tiny_train():
    """Seeded weights of the tiny fp32 and bf16 Planning stages and two
    synthetic batches of each on the card; TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA graphs have no CPU mode)')
    import torch_fixtures
    from stp3_tpu_torch.layers.base import init_parameters
    from stp3_tpu_torch.models.stp3 import STP3, STP3Config
    from stp3_tpu_torch.utils.precision import pin_fp32_math
    pin_fp32_math()
    out = {}
    for precision in (32, 16):
        cfg = _train_cfg(precision)
        model = init_parameters(STP3(STP3Config.from_cfg(cfg)), torch.Generator().manual_seed(0))
        out[precision] = ({k: v.clone() for k, v in model.state_dict().items()},
                          torch_fixtures.synthetic_batches(cfg, 2, 'cuda'))
    return out


def _trainer(cfg, weights, seed: int = 3):
    from stp3_tpu_torch.models.stp3 import STP3, STP3Config
    from stp3_tpu_torch.training.trainer import Trainer
    model = STP3(STP3Config.from_cfg(cfg))
    model.load_state_dict(weights)
    return Trainer(cfg, device='cuda', seed=seed, model=model)


def _steps(trainer, batches, n: int, eager: bool):
    """(loss terms of each of ``n`` steps, the parameters after them)."""
    losses = []
    for i in range(n):
        if eager:
            out = trainer.compute_gradients(batches[i % 2])
            trainer.apply_gradients()
        else:
            out = trainer.train_step(batches[i % 2])
        losses.append({k: v.item() for k, v in out.items()})
    return losses, [p.detach().clone() for p in trainer.model.parameters()]


def _distance(got, want, start):
    """(the loss terms' largest difference relative to the step's total
    loss, the parameter updates' worst relative L2)."""
    loss = max(abs(g[k] - w[k]) / max(abs(w['total']), 1e-12)
               for g, w in zip(got[0], want[0]) for k in w)
    upd = max(((g - w).norm() / (w - s).norm().clamp_min(1e-30)).item()
              for g, w, s in zip(got[1], want[1], start))
    return loss, upd


@pytest.mark.parametrize('remat', ['encoder', 'encoder+temporal+decoder+cells', 'future+cells'])
def test_compiled_train_step_against_eager(tiny_train, remat):
    """The tiny fp32 step (dropout on, the latent from the generator) through
    the compiled train step, 3 replays after its warm-up steps and capture,
    against eager steps of a twin of the same seed: loss terms and parameter
    updates within 2x the larger distance of two more eager twins from it
    (or 1e-6), the generators equal (the replays drew what the eager steps
    drew)."""
    from stp3_tpu_torch.utils.graphs import WARMUP_CALLS
    cfg = _train_cfg(32, remat)
    weights, batches = tiny_train[32]
    n = WARMUP_CALLS + 1 + 3
    graphed, twins = _trainer(cfg, weights), [_trainer(cfg, weights) for _ in range(3)]
    start = [p.detach().clone() for p in graphed.model.parameters()]
    got = _steps(graphed, batches, n, eager=False)
    want, *reruns = (_steps(t, batches, n, eager=True) for t in twins)
    assert graphed.graphs['gradients'].captures == graphed.graphs['update'].captures == 1
    assert graphed.graphs['gradients'].eager_calls == WARMUP_CALLS
    d_got = _distance(got, want, start)
    d_yard = [max(m) for m in zip(*(_distance(r, want, start) for r in reruns))]
    for g, y in zip(d_got, d_yard):
        assert g <= max(2 * y, 1e-6), (d_got, d_yard)
    assert all(torch.equal(graphed.generator.get_state(), t.generator.get_state())
               for t in twins)


def test_compiled_train_step_launches_k1_k3_and_k2_in_its_graph(tiny_train):
    """In bf16: K1 and K3 once and K2 twice in the gradients' graph, nothing
    in the update's; a replay moves no launch counter."""
    from stp3_tpu_torch.ops.kernels import launch_counters
    cfg = _train_cfg(16)
    weights, batches = tiny_train[16]
    trainer = _trainer(cfg, weights)
    while not trainer.graphs['update'].captures:
        trainer.train_step(batches[0])
    want = {name: 0 for name in launch_counters()}
    assert trainer.graphs['gradients'].launches_per_call == dict(
        want, bev_splat=1, gather_rows=1, convnext_mlp=2)
    assert trainer.graphs['update'].launches_per_call == want
    for fn in launch_counters().values():
        fn.launches = 0
    loss = trainer.train_step(batches[1])
    assert all(fn.launches == 0 for fn in launch_counters().values())
    assert all(torch.isfinite(v) for v in loss.values())


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16's numbers at |v| (v in fp64, nonzero)."""
    return torch.ldexp(torch.full_like(v, torch.finfo(torch.bfloat16).eps),
                       torch.frexp(v.abs())[1] - 1)


def _interpolate(x, hw):
    return torch.nn.functional.interpolate(x, size=hw, mode='bilinear', align_corners=False)


def test_resize_bilinear_from_1x1_is_the_broadcast_on_the_card(cuda, monkeypatch):
    """bf16 (12, 23, 1, 1) -> (200, 200), the Planning pyramid's shape (2 x 6
    frames): the broadcast equals ``F.interpolate`` bit for bit and its
    gradient lies within one bf16 rounding of the fp64 plane sum (the
    interpolation's backward adds 160,000 bf16 atomics into each element,
    four a pixel).
    A bf16 TemporalBlock at the pyramid's 200x200 keeps the interpolation's
    strides: the pyramid's output (bit for bit), the aggregation's input
    and the block's output."""
    from stp3_tpu_torch.layers import base, temporal
    from stp3_tpu_torch.layers.convolutions import resize_bilinear
    gen = torch.Generator().manual_seed(12)
    x = (torch.randn(12, 23, 1, 1, generator=gen) * 10).to(cuda, torch.bfloat16)
    x.requires_grad_(True)
    g = torch.randn(12, 23, 200, 200, generator=gen).to(cuda, torch.bfloat16)
    n = resize_bilinear.broadcasts
    y = resize_bilinear(x, (200, 200))
    assert resize_bilinear.broadcasts == n + 1
    assert torch.equal(y, _interpolate(x, (200, 200)))
    got, = torch.autograd.grad(y, x, g)
    plane_sum = g.double().sum((-2, -1), keepdim=True)
    assert ((got.double() - plane_sum).abs() <= _bf16_ulp(plane_sum)).all()

    torch.manual_seed(0)
    block = temporal.TemporalBlock(64, 64, True, [(2, 200, 200)]).to(cuda, torch.bfloat16)
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.1)
    xs = base.to_first(torch.randn(2, 3, 200, 200, 64, device=cuda).to(torch.bfloat16))
    agg = block.Conv1x1x1NormActivated_3
    seen = []
    monkeypatch.setattr(agg, 'nchw', lambda v, f=agg.nchw: seen.append(v) or f(v))

    def outputs():
        with torch.no_grad():
            return block.PyramidSpatioTemporalPooling_0.nchw(xs), block.nchw(xs), seen.pop()
    got = outputs()
    with monkeypatch.context() as m:
        m.setattr(temporal, 'resize_bilinear', _interpolate)
        want = outputs()
    assert [v.stride() for v in got] == [v.stride() for v in want]
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2)


def test_compiled_train_step_captures_and_replays_the_broadcast(tiny_train):
    """The tiny bf16 Planning step: every warm-up call and the capture take
    the broadcast route once per pyramid; a replay moves no counter and
    steps to finite losses."""
    from stp3_tpu_torch.layers import temporal
    from stp3_tpu_torch.layers.convolutions import resize_bilinear
    cfg = _train_cfg(16)
    weights, batches = tiny_train[16]
    trainer = _trainer(cfg, weights)
    pyramids = sum(isinstance(m, temporal.TemporalBlock) and m.use_pyramid_pooling
                   for m in trainer.model.modules())
    assert pyramids
    n = resize_bilinear.broadcasts
    while not trainer.graphs['update'].captures:
        trainer.train_step(batches[0])
    graph = trainer.graphs['gradients']
    assert graph.captures == 1
    assert resize_bilinear.broadcasts == n + pyramids * (graph.eager_calls + 1)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    n = resize_bilinear.broadcasts
    losses = [trainer.train_step(batches[i % 2]) for i in range(2)]
    assert resize_bilinear.broadcasts == n and graph.captures == 1
    assert all(torch.isfinite(v).all() for loss in losses for v in loss.values())
    assert any(not torch.equal(p, q) for p, q in zip(trainer.model.parameters(), before))


def test_replays_draw_new_masks_as_eager_steps_do(tiny_train):
    """Two replays on one batch draw new dropout masks and latents (their
    loss terms differ) and draw what an eager twin of the same seed draws:
    their loss terms lie within 2x the distance between two eager twins
    (fp32 atomics), 10x closer than a twin of another seed, and the
    generators are equal after every step."""
    cfg = _train_cfg(32)
    weights, batches = tiny_train[32]
    graphed = _trainer(cfg, weights)
    twin, rerun, other = (_trainer(cfg, weights, seed) for seed in (3, 3, 4))
    eager = (twin, rerun, other)
    while not graphed.graphs['update'].captures:
        graphed.train_step(batches[0])
        for t in eager:
            t.compute_gradients(batches[0])
            t.apply_gradients()
    got, want = [], {t: [] for t in eager}
    for _ in range(2):
        got.append(graphed.train_step(batches[1]))
        for t in eager:
            want[t].append(t.compute_gradients(batches[1]))
            t.apply_gradients()
        assert torch.equal(graphed.generator.get_state(), twin.generator.get_state())

    def dist(a, b):
        return max(abs(x[k] - y[k]).item() / abs(y['total']).item()
                   for x, y in zip(a, b) for k in y)

    assert got[0]['total'] != got[1]['total']
    d, yard = dist(got, want[twin]), dist(want[rerun], want[twin])
    assert d <= max(2 * yard, 1e-6), (d, yard)
    assert dist(want[other], want[twin]) > 10 * d


def test_replaced_optimizer_state_after_a_capture_raises(tiny_train):
    import copy
    cfg = _train_cfg(32)
    weights, batches = tiny_train[32]
    trainer = _trainer(cfg, weights)
    while not trainer.graphs['update'].captures:
        trainer.train_step(batches[0])
    trainer.optimizer.load_state_dict(copy.deepcopy(trainer.optimizer.state_dict()))
    with pytest.raises(RuntimeError, match='replaced'):
        trainer.train_step(batches[0])


def test_a_failed_training_capture_leaves_stream_and_generators_usable(cuda):
    """A compiled training call that reads back to the host inside a
    generator's rewind: its eager warm-up calls run, its capture raises, and
    afterwards the caller's stream is current and the registered generator
    and the default one draw again."""
    from stp3_tpu_torch.utils import graphs, rng
    g = torch.Generator(cuda).manual_seed(0)
    w = torch.ones(4, device=cuda, requires_grad=True)

    def step(x):
        snap = rng.snapshot(g)
        y = (w * x * torch.rand(4, generator=g, device=cuda)).sum()
        y.backward()
        with rng.rewound([g], [snap]):
            again = torch.rand(4, generator=g, device=cuda)
            scale = again.sum().item()
        return y.detach() * scale

    call = graphs.compiled_step(step, generators=(g,), device=cuda)
    x = torch.ones(4, device=cuda)
    for _ in range(graphs.WARMUP_CALLS):
        call(x)
    with pytest.raises(RuntimeError, match='CUDA graph capture of .* failed'):
        call(x)
    assert call.captures == 0
    assert torch.cuda.current_stream(cuda) == torch.cuda.default_stream(cuda)
    assert torch.rand(3, generator=g, device=cuda).isfinite().all()
    assert torch.randn(3, device=cuda).isfinite().all()


def test_compiled_val_increments_equal_the_eager_ones(tiny_train):
    """``validate``'s increments (the compiled call, one read back) against
    the validation function run eagerly: integer counts exactly, the L2
    sums at rtol 1e-5; a second call replays the graph."""
    import numpy as np
    from stp3_tpu_torch.utils.device import to_host
    cfg = _train_cfg(32)
    weights, batches = tiny_train[32]
    trainer = _trainer(cfg, weights)
    _, _, host = trainer.validate(batches[0])
    _, _, again = trainer.validate(batches[0])
    assert trainer.graphs['val'].captures == 1
    with torch.no_grad():
        eager = to_host(trainer._validate(batches[0], None)[2])
    assert host.keys() - {'valid', 'samples'} == eager.keys()
    for key, want in eager.items():
        for got in (host[key], again[key]):
            if key == 'planning':
                assert (got[:2] == want[:2]).all()
                np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=0)
            else:
                assert (got == want).all(), key


# ---------------------------------------- stage stamps (utils/profiling.stage)
def _two_stage_call(cuda):
    """A compiled call of two stages, captured (its first call) and
    replayed once, untraced."""
    from stp3_tpu_torch.utils import graphs, profiling

    def fn(x):
        with profiling.stage('test.first', x):
            y = torch.sin(x) * 2.0
        with profiling.stage('test.second', y):
            z = torch.cos(y).cumsum(0)
        return z

    call = graphs.compiled(fn)
    x = torch.randn(1 << 22, device=cuda)
    call(x)
    assert call.captures == 1
    return call, x


def _profiled(fn):
    """The ``torch.profiler`` (CPU and CUDA) of ``fn`` and a sync."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def test_stages_survive_replay_and_untraced_replays_record_nothing(cuda):
    """N replays under a profiler: N x 2 spans on the device, in order,
    each of positive length, and N ``graph.replay`` host ranges; N replays
    without one: the stamps run (the ring's count moves) and no span is
    recorded."""
    from stp3_tpu_torch.utils import profiling
    call, x = _two_stage_call(cuda)
    n = 7
    ring = profiling._RECORDER.rings[cuda.index]
    before, issued = profiling.window_spans(), ring.issued
    for _ in range(n):
        call(x)
    assert profiling.window_spans() == before
    assert ring.issued == issued + 4 * n and int(ring.words[0]) == ring.issued
    prof = _profiled(lambda: [call(x) for _ in range(n)])
    spans = profiling.window_spans()
    assert [s.name for s in spans] == ['test.first', 'test.second'] * n
    assert all(s.device == f'cuda:{cuda.index}' and s.end_ns > s.start_ns for s in spans)
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
    cpu = torch.autograd.DeviceType.CPU
    assert sum(e.name == 'graph.replay' and e.device_type == cpu for e in prof.events()) == n


def test_replays_make_no_synchronising_call_traced_or_not(cuda):
    from torch.profiler import ProfilerActivity, profile
    from stp3_tpu_torch.utils import profiling
    call, x = _two_stage_call(cuda)
    torch.cuda.synchronize()

    def replays():
        torch.cuda.set_sync_debug_mode('error')
        try:
            for _ in range(3):
                call(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    replays()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        replays()
        torch.cuda.synchronize()
    assert len(profiling.window_spans()) == 6


def test_the_compiled_train_step_with_two_steps_in_flight_loses_no_span(tiny_train):
    """The tiny fp32 train step, replayed 6 times under a profiler with at
    most two steps in flight (the benchmark's throughput window): each step
    gives its forward, backward and update, the model's six stages inside
    its forward."""
    from stp3_tpu_torch.utils import profiling
    from stp3_tpu_torch.utils.graphs import WARMUP_CALLS
    cfg = _train_cfg(32)
    weights, batches = tiny_train[32]
    trainer = _trainer(cfg, weights)
    for i in range(WARMUP_CALLS + 1):
        trainer.train_step(batches[i % 2])
    assert trainer.graphs['gradients'].captures == trainer.graphs['update'].captures == 1
    n, events = 6, []

    def steps():
        for i in range(n):
            if len(events) >= 2:
                events.pop(0).synchronize()
            trainer.train_step(batches[i % 2])
            events.append(torch.cuda.Event())
            events[-1].record()

    _profiled(steps)
    spans = profiling.window_spans()
    stages = ('stp3.encoder', 'stp3.splat', 'stp3.temporal', 'stp3.future', 'stp3.decoder',
              'stp3.planner')
    counts = {}
    for s in spans:
        counts[s.name] = counts.get(s.name, 0) + 1
    assert counts == {**{k: n for k in stages}, 'train.forward': n, 'train.backward': n,
                      'train.update': n}
    outer = [s for s in spans if s.name.startswith('train.')]
    assert [s.name for s in outer] == ['train.forward', 'train.backward', 'train.update'] * n
    assert all(a.end_ns <= b.start_ns for a, b in zip(outer, outer[1:]))
    forwards = [s for s in outer if s.name == 'train.forward']
    for s in spans:
        if s.name in stages:
            assert any(f.start_ns <= s.start_ns and s.end_ns <= f.end_ns for f in forwards)


def test_the_stamp_kernels_in_the_trace_match_the_ring_on_one_clock(cuda):
    """Each stamp kernel the profiler saw is one ring entry, and the
    intervals between consecutive stamps agree within 2 us: the device
    spans and the device trace share one clock."""
    import numpy as np
    from stp3_tpu_torch.utils import profiling
    call, x = _two_stage_call(cuda)
    n = 10
    prof = _profiled(lambda: [call(x) for _ in range(n)])
    spans = profiling.window_spans()
    ring_ns = sorted(t for s in spans for t in (s.start_ns, s.end_ns))
    kernels = sorted(e.time_range.start for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and 'stage_stamp' in e.name)
    assert len(kernels) == len(ring_ns) == 4 * n
    gaps = np.abs(np.diff(ring_ns) / 1e3 - np.diff(kernels))
    assert gaps.max() <= 2.0, gaps
