"""gstk_torch's l1 and SSIM against gstk_tpu.utils.losses: value and
gradient on a 64x48x3 pair, rtol 1e-5, atol 1e-6.

gstk_tpu filters with banded matmuls (or tap sums), the port with a
depthwise ``conv2d`` pair; in f32 on the CPU the two agree to rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.utils import losses as jlosses
from gstk_torch.utils import losses as tlosses

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(rng, h=48, w=64, c=3):
    gt = rng.uniform(0, 1, (h, w, c)).astype(np.float32)
    noise = 0.1 * rng.normal(size=(h, w, c))
    return np.clip(gt + noise, 0, 1).astype(np.float32), gt


@pytest.mark.parametrize("name", ["l1", "ssim"])
def test_loss_value_and_grad_match_jax(rng, name):
    pred, gt = _pair(rng)
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)
    jval, jgrad = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(gt)
    )
    p, g = (torch.tensor(a, requires_grad=True) for a in (pred, gt))
    tval = tfn(p, g)
    tgrad = torch.autograd.grad(tval, (p, g))
    np.testing.assert_allclose(float(tval.detach()), float(jval), **TOL)
    for a, b in zip(jgrad, tgrad):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_ssim_of_an_image_with_itself_is_one(rng):
    pred, _ = _pair(rng)
    x = torch.from_numpy(pred)
    assert abs(float(tlosses.ssim(x, x)) - 1.0) < 1e-6
    assert float(tlosses.ssim(x, 1.0 - x)) < 0.5


def test_l1_gradient_at_a_tie_matches_jax():
    """|d| at d = 0: jnp.abs's gradient is +1 (torch.abs would give 0)."""
    pred = np.array([[[0.25, 0.5, 0.75]]], np.float32)
    gt = np.array([[[0.25, 0.25, 1.0]]], np.float32)
    jgrad = jax.grad(jlosses.l1)(jnp.asarray(pred), jnp.asarray(gt))
    p = torch.tensor(pred, requires_grad=True)
    (tgrad,) = torch.autograd.grad(tlosses.l1(p, torch.from_numpy(gt)), p)
    np.testing.assert_array_equal(tgrad.numpy(), np.asarray(jgrad))
    assert tgrad[0, 0, 0] == 1.0 / 3.0
