"""The compiled fixed-shape calls of the port (stp3_tpu_torch/utils/graphs.py)
on the CPU, where a compiled call runs its function eagerly: equal values,
fresh outputs, no autograd graph, the signature a graph is kept under, and
the per-device constants that make the serving path capturable. On the
card the same calls capture and replay CUDA graphs
(tests/test_torch_cuda.py, chip_smoke.py's [graphs] phase)."""
import numpy as np
import pytest
import torch

from stp3_tpu_torch.models.cost import CostConfig, CostFunction
from stp3_tpu_torch.ops.bev_pool import voxelize_coords
from stp3_tpu_torch.utils import graphs
from stp3_tpu_torch.utils.device import constant
from stp3_tpu_torch.utils.network import IMAGENET_MEAN, IMAGENET_STD, prepare_image


@pytest.fixture(scope='module')
def layer():
    torch.manual_seed(0)
    return torch.nn.Linear(6, 4)


def test_a_call_on_the_cpu_is_eager_with_equal_values(layer):
    def step(x, scale, extra):
        return {'y': layer(x) * scale, 'pair': (x.sum(), extra['bias'] + 1)}

    call = graphs.compiled(step, layer)
    x = torch.randn(3, 6)
    extra = {'bias': torch.ones(2)}
    got = call(x, 2.0, extra)
    with torch.no_grad():
        want = step(x, 2.0, extra)
    assert torch.equal(got['y'], want['y'])
    assert torch.equal(got['pair'][0], want['pair'][0])
    assert torch.equal(got['pair'][1], want['pair'][1])
    assert isinstance(got['pair'], tuple)
    assert call.captures == 0 and call.launches_per_call == {}
    # forward-only: no autograd graph, though the layer's parameters want one
    assert not got['y'].requires_grad


def test_outputs_are_fresh_tensors(layer):
    """An output that is an input, a view of one or a parameter comes back
    as a new tensor, as a JAX call returns fresh arrays."""
    call = graphs.compiled(lambda x, cache: (x, cache[:, 1:], layer.weight, None, 3), layer)
    x, cache = torch.randn(2, 6), torch.randn(1, 3, 4)
    out_x, out_cache, out_w, none, three = call(x, cache)
    for got, src in ((out_x, x), (out_cache, cache), (out_w, layer.weight)):
        assert got.untyped_storage().data_ptr() != src.untyped_storage().data_ptr()
    assert torch.equal(out_x, x) and torch.equal(out_cache, cache[:, 1:])
    assert torch.equal(out_w, layer.weight.detach())
    assert none is None and three == 3
    out_x.add_(1.0)
    out_cache.zero_()
    assert not torch.equal(out_x, x) and cache.abs().sum() > 0


def test_non_tensor_arguments_are_part_of_the_signature():
    a, b = torch.zeros(2, 3), torch.ones(2, 3)
    key = graphs.signature(a, 'static', k=1)
    # a tensor's values are not: its shape, dtype and device are
    assert graphs.signature(b, 'static', k=1) == key
    for other in (graphs.signature(torch.zeros(3, 2), 'static', k=1),
                  graphs.signature(a.double(), 'static', k=1),
                  graphs.signature(a, 'dynamic', k=1),
                  graphs.signature(a, 'static', k=2),
                  graphs.signature(a, 'static', k=1.0),
                  graphs.signature(a, 'static', j=1),
                  graphs.signature([a], 'static', k=1),
                  graphs.signature({'x': a}, 'static', k=1)):
        assert other != key
    with pytest.raises(TypeError, match='hashable'):
        graphs.compiled(lambda x, table: x)(a, np.zeros(2))


def test_constants_are_made_once_a_device_with_the_hosts_values():
    constant.cache_clear()
    with torch.inference_mode():
        mean = constant(IMAGENET_MEAN, torch.float32, torch.device('cpu'))
    assert not mean.is_inference()        # autograd may save it after the serving path
    assert constant(IMAGENET_MEAN, torch.float32, torch.device('cpu')) is mean
    assert torch.equal(mean, torch.tensor(IMAGENET_MEAN, dtype=torch.float32))
    assert constant(IMAGENET_MEAN, torch.float64, torch.device('cpu')).dtype == torch.float64


def test_the_hoisted_constants_keep_their_values():
    """prepare_image, voxelize_coords (fp32 and float64) and the cost
    terms' cell size give what the host-built constants gave."""
    rng = np.random.RandomState(0)
    img = torch.as_tensor(rng.randint(0, 256, (2, 5, 7, 3), np.uint8))
    kw = dict(dtype=torch.float32)
    want = (img.float() / 255.0 - torch.tensor(IMAGENET_MEAN, **kw)) / torch.tensor(
        IMAGENET_STD, **kw)
    assert torch.equal(prepare_image(img, torch.float32), want)
    res = np.array([0.2, 0.2, 20.0], np.float32)
    start = np.array([-19.9, -19.9, 0.0], np.float32)
    dim = np.array([200, 200, 1])
    for dtype in (torch.float32, torch.float64):
        pts = torch.as_tensor(rng.uniform(-22, 22, (64, 3)), dtype=dtype)
        coords, valid = voxelize_coords(pts, res, start, dim)
        r, s = (torch.as_tensor(v, dtype=dtype) for v in (res, start))
        want = ((pts - (s - r / 2.0)) / r).to(torch.int32)
        assert torch.equal(coords, want)
        assert torch.equal(valid, ((want >= 0) & (want < torch.as_tensor(dim))).all(-1))
    cost = CostFunction(CostConfig((-20.0, 20.0, 0.2), (-20.0, 20.0, 0.2), (-10.0, 10.0, 20.0),
                                   2.12, 4.9, 4, 1.0, 1.0, 1.0, 10.0, 1.0, 1.0, 100.0))
    trajs = torch.as_tensor(rng.randn(1, 3, 4, 2), dtype=torch.float32)
    assert torch.equal(cost._dx(trajs), torch.as_tensor(cost.dx))
