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

    import chip_smoke
    from stp3_tpu_torch.layers.base import init_parameters
    from stp3_tpu_torch.models.stp3 import STP3, STP3Config
    from stp3_tpu_torch.utils.precision import pin_fp32_math
    pin_fp32_math()
    cfg = chip_smoke.stage_cfg('perception', True, {'MODEL': {'NORM': kind}})
    cpu = init_parameters(STP3(STP3Config.from_cfg(cfg)), torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(cuda)
    inputs = chip_smoke.example_inputs(cfg, b=2)[0]
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
    import chip_smoke
    from stp3_tpu_torch.config import get_cfg
    from stp3_tpu_torch.models.stp3 import STP3, STP3Config
    from stp3_tpu_torch.scripts.import_torch_checkpoint import import_checkpoint
    from stp3_tpu_torch.training import checkpoint as ckpt_lib
    from stp3_tpu_torch.utils.precision import pin_fp32_math
    pin_fp32_math()
    cfg = chip_smoke.make_cfg(chip_smoke.PLANNING_STAGE, chip_smoke.TINY_WIDTHS,
                              {'PRECISION': 32})
    chip_smoke.write_reference_checkpoint(cfg, str(tmp_path / 'ref.ckpt'))
    path, report = import_checkpoint(str(tmp_path / 'ref.ckpt'), str(tmp_path / 'out'),
                                     log=lambda msg: None)
    assert report.ok()
    mcfg = STP3Config.from_cfg(get_cfg(cfg_dict=ckpt_lib.load_config_dict(path)))
    assert mcfg.norm == 'bn_frozen'
    (image, k, e, ego), ex = chip_smoke.example_inputs(cfg)
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
