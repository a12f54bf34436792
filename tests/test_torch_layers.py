"""Per-module parity: every module of the port's serving slice against its
stp3_tpu (flax) counterpart, with the flax params loaded through
stp3_tpu_torch.utils.from_flax and the same numpy inputs. fp32 on the CPU
at rtol=atol=1e-4 unless a test says why not."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stp3_tpu.layers import convolutions as JC
from stp3_tpu.layers import temporal as JT
from stp3_tpu.models import efficientnet as JE
from stp3_tpu_torch.layers import base as TB
from stp3_tpu_torch.layers import convolutions as TC
from stp3_tpu_torch.layers import temporal as TT
from stp3_tpu_torch.models import efficientnet as TE
from stp3_tpu_torch.utils.from_flax import load_flax_params

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _flax_default_norm_gn():
    """flax Norm() reads a process-wide default; pin it to the port's 'gn'."""
    prev = JC.default_norm()
    JC.set_default_norm('gn')
    yield
    JC.set_default_norm(prev)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def run_both(jmod, tmod, inputs, call=None, tweak=None, method=None, **kw):
    """flax init + apply (jitted) on ``inputs``; load the params into
    ``tmod``; return (torch output, flax output, params)."""
    jin = [jnp.asarray(a) for a in inputs]
    extra = dict(kw, **({'method': method} if method else {}))
    params = jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, **extra))(*jin)
    params = params.get('params', {})        # a param-free module has none
    if tweak is not None:
        params = tweak(params)
    want = jax.jit(lambda p, *a: jmod.apply({'params': p}, *a, **extra))(params, *jin)
    load_flax_params(tmod, jax.tree.map(np.asarray, params))
    tin = [torch.from_numpy(np.asarray(a)) for a in inputs]
    with torch.no_grad():
        got = call(*tin) if call is not None else tmod(*tin)
    return got, want, params


def close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize('kind,shape', [('gn', (2, 7, 9, 16)), ('gn', (2, 3, 5, 6, 12)),
                                        ('ln', (2, 5, 6, 16)), ('none', (2, 5, 6, 16))])
def test_norm(kind, shape):
    x = _rand(*shape) * 3 + 1.5
    tm = TB.Norm(shape[-1], kind)

    def tweak(p):        # non-trivial scale/bias so the affine part is checked
        return jax.tree.map(lambda a: jnp.asarray(_rand(*a.shape, seed=1)), p)

    got, want, _ = run_both(JC.Norm(kind), tm, [x], tweak=tweak,
                            call=lambda t: TB.to_last(tm(TB.to_first(t))))
    close(got, want)


@pytest.mark.parametrize('hw,cout,down', [((7, 9), 16, True), ((8, 8), 8, True),
                                          ((6, 10), 4, False), ((6, 10), 12, False)])
def test_bottleneck(hw, cout, down):
    """Downsampling on an odd size exercises the zero-pad-then-max-pool skip."""
    x = _rand(2, *hw, 12)
    got, want, _ = run_both(JC.Bottleneck(cout, downsample=down),
                            TC.Bottleneck(12, cout, downsample=down), [x])
    close(got, want)


@pytest.mark.parametrize('hw', [(5, 7), (16, 30)])
def test_aspp_and_deeplab_head(hw):
    """(5, 7) is smaller than every atrous rate (12, 24, 36): only centre
    taps survive; at (16, 30) rate 12 is a full 3x3, rate 24 a 1x3."""
    x = _rand(2, *hw, 12)
    got, want, _ = run_both(JC.ASPP(16), TC.ASPP(12, 16), [x])
    close(got, want)
    got, want, _ = run_both(JC.DeepLabHead(num_classes=8, hidden_channel=16),
                            TC.DeepLabHead(12, 8, 16), [x])
    close(got, want)


def test_conv_block():
    x = _rand(2, 9, 11, 6)
    got, want, _ = run_both(JC.ConvBlock(10, stride=2), TC.ConvBlock(6, 10, stride=2), [x])
    close(got, want)


def test_upsampling_concat_and_add():
    up, skip = _rand(2, 4, 6, 12), _rand(2, 8, 12, 6, seed=1)
    got, want, _ = run_both(JC.UpsamplingConcat(10), TC.UpsamplingConcat(12, 6, 10),
                            [up, skip])
    close(got, want)
    skip = _rand(2, 8, 12, 10, seed=2)
    got, want, _ = run_both(JC.UpsamplingAdd(10), TC.UpsamplingAdd(12, 10), [up, skip])
    close(got, want)
    with pytest.raises(ValueError, match='downscale'):
        TC.resize_bilinear(torch.zeros(1, 2, 8, 8), (4, 8))


@pytest.mark.parametrize('arch', ['efficientnet-b0', 'efficientnet-b4'])
def test_efficientnet_block_plan(arch):
    assert TE.block_plan(arch) == JE.block_plan(arch)


def test_efficientnet_b0_endpoints():
    """Stride-2 stem and strided depthwise convs pad TF-style (asymmetric)."""
    x = _rand(2, 32, 64, 3)
    got, want, _ = run_both(JE.EfficientNetFeatures(arch='efficientnet-b0'),
                            TE.EfficientNetFeatures('efficientnet-b0'), [x])
    assert sorted(got) == sorted(want) == [f'reduction_{i}' for i in range(1, 5)]
    for key in want:
        close(got[key], want[key])


def _random_gamma(p):
    p = dict(p)
    p['gamma'] = jnp.asarray(np.random.RandomState(7).rand(p['gamma'].shape[0]) + 0.5,
                             jnp.float32)
    return p


def test_convnext_block_fp32_unfused_erf():
    x = _rand(2, 9, 10, 16)
    got, want, _ = run_both(JC.ConvNeXtBlock(), TC.ConvNeXtBlock(16), [x],
                            tweak=_random_gamma)
    close(got, want)


def test_convnext_block_bf16_routes_through_k2(monkeypatch):
    """bf16 input: the port's block runs the K2 path (its plain version on
    the CPU). The JAX block is forced onto its Pallas kernel (interpret
    mode), which computes the same function. bf16 tolerance, as in
    tests/test_convnext_kernel.py."""
    from jax.experimental.pallas import tpu as pltpu
    from stp3_tpu_torch.ops.kernels import convnext_mlp as K2
    monkeypatch.setenv('STP3_CONVNEXT', 'pallas')
    x = _rand(2, 9, 10, 16)
    jmod, tmod = JC.ConvNeXtBlock(), TC.ConvNeXtBlock(16)
    params = jax.jit(lambda a: jmod.init(jax.random.PRNGKey(0), a))(jnp.asarray(x))['params']
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), _random_gamma(params))
    xb = jnp.asarray(x, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = jmod.apply({'params': params}, xb)
    load_flax_params(tmod, jax.tree.map(lambda a: np.asarray(a, np.float32), params))
    tmod = tmod.to(torch.bfloat16)
    calls = []
    monkeypatch.setattr(TC, 'convnext_mlp', lambda *a: calls.append(1) or K2.convnext_mlp(*a))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).to(torch.bfloat16))
    assert calls == [1] and got.dtype == torch.bfloat16
    close(got, want, rtol=1e-2, atol=1e-2)


def test_bottleblock():
    x = _rand(2, 8, 10, 12)
    got, want, _ = run_both(JC.Bottleblock(8), TC.Bottleblock(12, 8), [x])
    close(got, want)


def test_conv_gru_cell_and_latent_gru_cell():
    x, s = _rand(2, 6, 7, 4), _rand(2, 6, 7, 8, seed=1)
    got, want, _ = run_both(JT.ConvGRUCell(8), TT.ConvGRUCell(4, 8), [x, s])
    close(got, want)
    got, want, _ = run_both(JT._LatentGRUCell(8, 4), TT.LatentGRUCell(8, 4), [x, s],
                            method=lambda m, a, b: m(m.x_maps(a), b))
    close(got, want)


def test_spatial_gru():
    x, s = _rand(2, 3, 6, 7, 8), _rand(2, 6, 7, 8, seed=1)
    got, want, _ = run_both(JT.SpatialGRU(8, 8), TT.SpatialGRU(8, 8), [x, s])
    close(got, want)


def test_dual_gru():
    """Warm-up over 3 past states, 4-step rollout, trust-gate mixing."""
    x, s = _rand(2, 1, 6, 7, 4), _rand(2, 3, 6, 7, 8, seed=1)
    got, want, _ = run_both(JT.DualGRU(4, 8, n_future=4), TT.DualGRU(4, 8, 4), [x, s])
    assert tuple(got.shape) == (2, 4, 6, 7, 8)
    close(got, want)


@pytest.mark.parametrize('ks,dil', [((2, 3, 3), (1, 1, 1)), ((3, 3, 3), (2, 1, 1)),
                                    ((1, 3, 3), (1, 1, 1))])
def test_causal_conv3d(ks, dil):
    x = _rand(2, 5, 6, 7, 6)
    got, want, _ = run_both(JT.CausalConv3d(8, ks, dil), TT.CausalConv3d(6, 8, ks, dil), [x])
    close(got, want)


def test_temporal_block_with_pyramid_pooling():
    x = _rand(1, 3, 8, 8, 22)
    got, want, _ = run_both(JT.TemporalBlock(16, use_pyramid_pooling=True,
                                             pool_sizes=[(2, 8, 8)]),
                            TT.TemporalBlock(22, 16, True, [(2, 8, 8)]), [x])
    close(got, want)


def _interpolate(x, hw):
    """``F.interpolate``'s half-pixel bilinear upsample, the route of every
    map but a 1x1 one."""
    return torch.nn.functional.interpolate(x, size=hw, mode='bilinear', align_corners=False)


def _ulp(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``dtype``'s numbers at |v| (v in fp64, nonzero)."""
    return torch.ldexp(torch.full_like(v, torch.finfo(dtype).eps), torch.frexp(v.abs())[1] - 1)


@pytest.mark.parametrize('channels_last', [False, True])
@pytest.mark.parametrize('src,hw', [((1, 1, 1, 1), (200, 200)), ((1, 1, 1, 1), (7, 5)),
                                    ((1, 1, 1, 1), (1, 9)), ((6, 23, 1, 1), (200, 200)),
                                    ((6, 23, 1, 1), (7, 5)), ((6, 23, 1, 1), (1, 9)),
                                    ((3, 4, 5, 6), (10, 12)), ((3, 4, 5, 6), (7, 9))])
def test_resize_bilinear_from_1x1_is_the_broadcast(src, hw, channels_last):
    """From 1x1, in bf16, fp32 and fp64: the broadcast (bf16: the
    interpolation in fp32 rounded once, bit for bit; fp32 within 4 ulp of
    the interpolation), the fp64 gradient the plane sum, the bf16 gradient
    within one bf16 rounding of the fp64 plane sum of the same gradients,
    and ``broadcasts`` raised once a call. A 2x and a non-integer upsample
    still equal ``F.interpolate`` bit for bit, gradients too, and move no
    counter. (CPU's bf16 interpolation of a single plane is off by a bf16
    ulp at some pixels: the card's kernel, which accumulates in fp32, is
    compared bit for bit in tests/test_torch_cuda.py.)"""
    gen = torch.Generator().manual_seed(hw[0] * 1000 + hw[1] + src[1])
    base = torch.randn(*src, generator=gen, dtype=torch.float64) * 10
    grad = torch.randn(*src[:2], *hw, generator=gen, dtype=torch.float64)
    broadcast = src[-2:] == (1, 1)
    for dtype in (torch.bfloat16, torch.float32, torch.float64):
        x = base.to(dtype)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        x.requires_grad_(True)
        g = grad.to(dtype)
        n = TC.resize_bilinear.broadcasts
        y = TC.resize_bilinear(x, hw)
        assert TC.resize_bilinear.broadcasts == n + broadcast
        got, = torch.autograd.grad(y, x, g)
        if not broadcast:
            want = _interpolate(x, hw)
            assert torch.equal(y, want)
            assert torch.equal(got, torch.autograd.grad(want, x, g)[0])
            continue
        want = _interpolate(x.detach().float(), hw).double()
        if dtype == torch.bfloat16:
            assert torch.equal(y, want.to(dtype))
        else:
            assert ((y.double() - want).abs() <= 4 * _ulp(want, torch.float32)).all()
        plane_sum = g.double().sum((-2, -1), keepdim=True)
        if dtype == torch.float64:
            assert torch.equal(got, plane_sum)
        elif dtype == torch.bfloat16:
            assert ((got.double() - plane_sum).abs() <= _ulp(plane_sum, dtype)).all()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('layout', ['channels_last', 'contiguous'])
def test_pyramid_outputs_keep_the_interpolations_strides(monkeypatch, dtype, layout):
    """PyramidSpatioTemporalPooling's output, TemporalBlock's concat (the
    aggregation's input) and its output have the strides and the values
    (bf16: bit for bit) that ``F.interpolate`` gave them, on the model's
    channels-last views and on contiguous NCTHW input."""
    b, t, h, w, c = 2, 3, 12, 10, 24
    torch.manual_seed(0)
    block = TT.TemporalBlock(c, 16, True, [(2, h, w)]).to(dtype)
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.2)
    x = torch.randn(b, t, h, w, c).to(dtype)
    x = TB.to_first(x) if layout == 'channels_last' else TB.to_first(x).contiguous()
    agg = block.Conv1x1x1NormActivated_3
    seen = []
    monkeypatch.setattr(agg, 'nchw', lambda v, f=agg.nchw: seen.append(v) or f(v))

    def outputs():
        with torch.no_grad():
            return block.PyramidSpatioTemporalPooling_0.nchw(x), block.nchw(x)
    got = outputs() + (seen.pop(),)
    with monkeypatch.context() as m:
        m.setattr(TT, 'resize_bilinear', _interpolate)
        want = outputs() + (seen.pop(),)
    for g, v in zip(got, want):
        assert g.stride() == v.stride()
        if dtype == torch.bfloat16:
            assert torch.equal(g, v)
        else:
            torch.testing.assert_close(g, v, rtol=1e-6, atol=1e-6)


def test_planning_forward_broadcasts_once_per_pyramid():
    """The Planning stage (TINY's widths, receptive field 3: two
    TemporalBlocks with pyramid pooling over the whole BEV) takes the
    broadcast route twice a forward, once in each pyramid; the encoder,
    the decoder and every 2x upsample take ``F.interpolate``."""
    import torch_fixtures
    from stp3_tpu_torch.layers.base import init_parameters
    from stp3_tpu_torch.models.stp3 import STP3, STP3Config
    cfg = torch_fixtures.make_cfg(torch_fixtures.PLANNING_STAGE, torch_fixtures.TINY_WIDTHS,
                                  {'PRECISION': 32})
    model = init_parameters(STP3(STP3Config.from_cfg(cfg)), torch.Generator().manual_seed(0))
    batch, = torch_fixtures.synthetic_batches(cfg, 1, 'cpu')
    pyramids = [m for m in model.modules()
                if isinstance(m, TT.TemporalBlock) and m.use_pyramid_pooling]
    assert len(pyramids) == 2
    inside = []
    temporal = model.temporal_model

    def counted(*a, f=temporal.nchw):
        n = TC.resize_bilinear.broadcasts
        out = f(*a)
        inside.append(TC.resize_bilinear.broadcasts - n)
        return out
    temporal.nchw = counted
    n = TC.resize_bilinear.broadcasts
    with torch.no_grad():
        model.eval()(batch['image'], batch['intrinsics'], batch['extrinsics'],
                     batch['future_egomotion'])
    assert inside == [2] and TC.resize_bilinear.broadcasts == n + 2


def test_pyramid_pooling_same_padding_and_bottleneck3d():
    """A (3, 3) window does not tile 8x8: flax pads SAME, counting the pad."""
    x = _rand(2, 3, 8, 8, 12)
    got, want, _ = run_both(JT.PyramidSpatioTemporalPooling(4, [(2, 3, 3), (2, 4, 4)]),
                            TT.PyramidSpatioTemporalPooling(12, 4, [(2, 3, 3), (2, 4, 4)]),
                            [x])
    close(got, want)
    got, want, _ = run_both(JT.Bottleneck3D(8), TT.Bottleneck3D(12, 8), [x])
    close(got, want)
