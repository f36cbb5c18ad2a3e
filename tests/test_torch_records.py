"""The packed per-Gaussian record that kernels K1 and K2 read
(``raster_cuda.pack_records``, laid out as ``csrc/composite_common.cuh``
reads it) and how the compositing wrappers take it.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``);
here the record's layout is held against the four arrays it packs, the
wrappers' check of a record passed in, and the CPU path, which packs none.
"""

import importlib

import numpy as np
import pytest
import torch

from gstk_torch.ops import raster_cuda

# ops/__init__ re-exports the rasterize function under the module's name
tras = importlib.import_module("gstk_torch.ops.rasterize")


def _arrays(rng, n, ch):
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return f(n, 2), f(n, 3), f(n), f(n, ch)


@pytest.mark.parametrize("ch", [3, 4])
def test_pack_records_layout(rng, ch):
    n = 37
    xys, conics, opacities, colors = _arrays(rng, n, ch)
    rec = raster_cuda.pack_records(xys, conics, opacities, colors)
    assert rec.shape == (n, raster_cuda.RECORD_WIDTH) == (n, 12)
    assert rec.dtype == torch.float32 and rec.is_contiguous()
    # the three 16-B chunks the kernels copy:
    # [x, y, a, b | c, op, col0, col1 | col2, col3, 0, 0]
    q = rec.view(n, 3, 4)
    assert torch.equal(q[:, 0], torch.cat([xys, conics[:, :2]], 1))
    assert torch.equal(q[:, 1, :2], torch.stack([conics[:, 2], opacities], 1))
    colors_padded = torch.cat([colors, torch.zeros(n, 6 - ch)], 1)
    assert torch.equal(torch.cat([q[:, 1, 2:], q[:, 2]], 1), colors_padded)
    assert bool((rec[:, 6 + ch:] == 0).all())


@pytest.mark.parametrize("ch", [1, 2, 5])
def test_pack_records_rejects_other_channel_counts(rng, ch):
    with pytest.raises(ValueError, match="ch in"):
        raster_cuda.pack_records(*_arrays(rng, 5, ch))


def test_kernel_records_checked_or_built(rng):
    n = 9
    arrays = _arrays(rng, n, 4)
    rec = raster_cuda.pack_records(*arrays)
    check = lambda r: raster_cuda._kernel_records(r, *arrays, "test")
    assert torch.equal(check(None), rec)
    assert check(rec) is rec
    flat = torch.zeros(n * 12 + 1)
    bad = {
        "width": rec[:, :8].contiguous(),
        "rows": rec[:-1],
        "dtype": rec.double(),
        "strided": torch.zeros(n, 24)[:, ::2],
        "misaligned": flat[1:].view(n, 12),  # 4 B past a 16-B boundary
    }
    for name, r in bad.items():
        with pytest.raises(ValueError, match="records must be"):
            check(r)


@pytest.mark.parametrize("ch", [3, 4])
def test_wrappers_ignore_records_on_cpu(rng, ch, monkeypatch):
    """On CPU tensors the rasterizer takes the twins and packs no record,
    forward and backward; both wrappers refuse CPU tensors, with or
    without the record, before they count a launch."""
    n, tiles = 40, (2, 1)
    xys = torch.from_numpy(rng.uniform(0, 32, (n, 2)).astype(np.float32))
    xys[:, 1] = xys[:, 1] / 2
    conics = torch.tensor([[0.05, 0.0, 0.05]]).repeat(n, 1)
    opacities = torch.from_numpy(rng.uniform(0.1, 0.9, n).astype(np.float32))
    colors = torch.from_numpy(rng.uniform(0, 1, (n, ch)).astype(np.float32))
    gids = torch.cat([torch.arange(n), torch.full((8,), n)]).int()
    bins = torch.tensor([[0, 25], [25, n]], dtype=torch.int32)
    args = (xys, conics, opacities, colors, gids, bins, tiles)
    rec = raster_cuda.pack_records(xys, conics, opacities, colors)
    launches = (raster_cuda.composite_tiles_fwd.launches,
                raster_cuda.composite_tiles_bwd.launches)
    acc, final_t, _ = raster_cuda.composite_tiles_fwd_plain(*args)
    assert float(final_t.mean()) < 0.99
    planes = (acc, final_t, torch.ones_like(acc), torch.ones_like(final_t))
    for records in (rec, None):
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            raster_cuda.composite_tiles_fwd(*args, records=records)
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            raster_cuda.composite_tiles_bwd(*args[:6], *planes, tiles,
                                            records=records)
    assert (raster_cuda.composite_tiles_fwd.launches,
            raster_cuda.composite_tiles_bwd.launches) == launches

    def no_record(*_):
        raise AssertionError("a record packed for the twins")

    monkeypatch.setattr(tras, "pack_records", no_record)
    colors_g = colors.clone().requires_grad_()
    radii = torch.full((n,), 6, dtype=torch.int32)
    img, _ = tras.rasterize(
        xys, torch.ones(n), radii, conics, torch.ones(n, dtype=torch.int32),
        colors_g, opacities, 16, 32,
        config=tras.RasterizeConfig(isect_capacity=1 << 10))
    grad, = torch.autograd.grad(img.sum(), colors_g)
    assert float(img.detach().abs().sum()) > 0 and float(grad.abs().sum()) > 0
