"""gstk_torch's segment sum (the plain twin of kernel K4) against gstk_tpu's
``segment_sum_sorted`` (its Pallas kernel in interpret mode), mirroring
tests/test_segment_kernel.py: random, empty and clipped segments, and
segment ends past Np, with the values attribute-major and as the
entry-major view the backward passes.

Tolerance: rtol 1e-5, atol 1e-6 max|segment sum|. gstk_tpu's default of
three bf16 terms is about f32; the two sum each segment in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.ops.segment_kernel import segment_sum_sorted as jsegsum
from gstk_torch.ops import segment_kernel as tseg

torch.set_num_threads(2)


def _hi(rng, case, npv, n):
    """Nondecreasing segment ends for each case."""
    if case == "random":
        return np.minimum(np.cumsum(rng.integers(0, 4, n)), npv)
    if case == "sparse":  # mostly empty segments, as dead Gaussians give
        counts = rng.integers(0, 9, n) * (rng.uniform(size=n) < 0.2)
        return np.minimum(np.cumsum(counts), npv)
    if case == "past_np":  # unclipped ends run past Np
        return np.cumsum(rng.integers(0, 6, n))
    if case == "one_covers_all":  # empty, one segment over all, empty
        hi = np.zeros(n, np.int64)
        hi[n // 6:] = npv + 50
        return hi
    raise ValueError(case)


@pytest.mark.parametrize("case", ["random", "sparse", "past_np", "one_covers_all"])
def test_segment_sum_plain_matches_jax(rng, case):
    rows, npv, n = 16, 3000, 2500
    vals = rng.normal(size=(rows, npv)).astype(np.float32)
    hi = _hi(rng, case, npv, n).astype(np.int32)
    ref = np.asarray(jsegsum(jnp.asarray(vals), jnp.asarray(hi), interpret=True))
    before = tseg.segment_sum_sorted.launches
    got = tseg.segment_sum_sorted(torch.from_numpy(vals), torch.from_numpy(hi))
    assert tseg.segment_sum_sorted.launches == before  # CPU: the twin
    assert got.shape == (rows, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    # empty segments are exactly zero
    lo = np.concatenate([[0], np.minimum(hi, npv)[:-1]])
    empty = np.minimum(hi, npv) <= lo
    assert (got.numpy()[:, empty] == 0).all()
    if case == "one_covers_all":
        np.testing.assert_allclose(got.numpy()[:, n // 6], vals.sum(1),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", ["random", "sparse", "past_np"])
def test_segment_sum_entry_major_view_matches_jax(rng, case):
    """The layout the backward hands over: ``x.t()`` of a contiguous
    (Np, rows) array, each entry's rows contiguous, as kernel K4 reads it."""
    rows, npv, n = 16, 3000, 2500
    x = rng.normal(size=(npv, rows)).astype(np.float32)
    hi = _hi(rng, case, npv, n).astype(np.int32)
    ref = np.asarray(jsegsum(jnp.asarray(np.ascontiguousarray(x.T)),
                             jnp.asarray(hi), interpret=True))
    vals_t = torch.from_numpy(x).t()
    assert vals_t.stride() == (1, rows)
    got = tseg.segment_sum_sorted(vals_t, torch.from_numpy(hi))
    assert got.shape == (rows, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


def test_segment_sum_plain_takes_int64_ends_and_odd_rows(rng):
    """Rows need not be a multiple of 8 in the port (the backward reduces
    6 + ch rows); int64 ends give the same sums as int32."""
    vals = rng.normal(size=(10, 500)).astype(np.float32)
    hi = np.minimum(np.cumsum(rng.integers(0, 3, 400)), 500)
    ref = np.stack([vals[:, l:h].sum(1) for l, h in
                    zip(np.concatenate([[0], hi[:-1]]), hi)], 1)
    for dtype in (torch.int32, torch.int64):
        got = tseg.segment_sum_sorted_plain(
            torch.from_numpy(vals), torch.from_numpy(hi).to(dtype)
        )
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_segment_sum_rejects_bad_inputs():
    vals = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="float32"):
        tseg.segment_sum_sorted(vals.double(), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="1-D int"):
        tseg.segment_sum_sorted(vals, torch.zeros(3))
