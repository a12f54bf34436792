"""The port's losses (stp3_tpu_torch/losses.py) against stp3_tpu.losses on
the same numpy inputs, fp32 on the CPU: values at rtol 1e-5 and, for the
terms the trainer differentiates, the gradient with respect to the
prediction at rtol 1e-5 / atol 1e-7."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stp3_tpu import losses as JL
from stp3_tpu_torch import losses as TL

torch.set_num_threads(2)


def _both(jfn, tfn, pred, *rest, **kw):
    """(torch value, jax value, torch d/dpred, jax d/dpred)."""
    want, gwant = jax.value_and_grad(lambda p: jfn(p, *[jnp.asarray(r) for r in rest], **kw))(
        jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    got = tfn(p, *[torch.from_numpy(np.asarray(r)) for r in rest], **kw)
    got.backward()
    return got.item(), float(want), p.grad.numpy(), np.asarray(gwant)


def _check(got, want, ggot, gwant):
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(ggot, gwant, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('top_k', [False, True])
def test_segmentation_loss(top_k):
    rng = np.random.RandomState(0)
    pred = rng.randn(2, 5, 8, 8, 2).astype(np.float32)
    target = rng.randint(0, 2, (2, 5, 8, 8)).astype(np.int32)
    target[0, 0, :2] = 255                                   # ignored pixels
    _check(*_both(JL.segmentation_loss, TL.segmentation_loss, pred, target,
                  class_weights=[1.0, 2.0], n_present=3, future_discount=0.95,
                  use_top_k=top_k, top_k_ratio=0.25))


def test_hdmap_loss():
    rng = np.random.RandomState(1)
    pred = rng.randn(2, 8, 8, 4).astype(np.float32)
    target = rng.randint(0, 2, (2, 8, 8, 2)).astype(np.int32)
    _check(*_both(JL.hdmap_loss, TL.hdmap_loss, pred, target,
                  class_weights=[[1.0, 5.0], [1.0, 1.0]], training_weights=[1, 1],
                  use_top_k=[True, False], top_k_ratio=[0.25, 0.25]))


@pytest.mark.parametrize('norm', [1, 2])
def test_spatial_regression_loss(norm):
    rng = np.random.RandomState(2)
    pred = rng.randn(2, 4, 6, 6, 2).astype(np.float32)
    target = rng.randn(2, 4, 6, 6, 2).astype(np.float32)
    target[:, :, :3, :, 0] = 255.0                           # ignored pixels
    _check(*_both(JL.spatial_regression_loss, TL.spatial_regression_loss, pred, target,
                  norm=norm, n_present=2, future_discount=0.9))
    # all pixels ignored: zero, as in the JAX function
    target[..., 0] = 255.0
    got = TL.spatial_regression_loss(torch.from_numpy(pred), torch.from_numpy(target), norm)
    assert got.item() == 0.0


def test_depth_loss():
    rng = np.random.RandomState(3)
    pred = rng.randn(1, 2, 2, 3, 4, 8).astype(np.float32)
    target = rng.randint(0, 8, (1, 2, 2, 3, 4)).astype(np.int32)
    target[0, 0, 0] = 255
    _check(*_both(JL.depth_loss, TL.depth_loss, pred, target))


def test_probabilistic_losses():
    rng = np.random.RandomState(4)
    gauss = {k: rng.randn(2, 1, 4).astype(np.float32) for k in
             ('present_mu', 'present_log_sigma', 'future_mu', 'future_log_sigma')}
    bern = {k: np.log(rng.rand(2, 3, 3, 4).astype(np.float32)) for k in
            ('present_log_prob', 'future_log_prob')}
    mix = {k: [rng.randn(2, 1, 4).astype(np.float32) for _ in range(3)] for k in gauss}
    for method, out in (('GAUSSIAN', gauss), ('BERNOULLI', bern), ('MIXGAUSSIAN', mix)):
        want = JL.probabilistic_loss(jax.tree.map(jnp.asarray, out), method)
        got = TL.probabilistic_loss(jax.tree.map(torch.from_numpy, out), method)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    with pytest.raises(NotImplementedError):
        TL.probabilistic_loss(gauss, 'OTHER')
