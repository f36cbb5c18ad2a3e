"""gstk_torch's card probes (``gstk_torch/tools``) against the Pallas probes
of ``tools/`` on the CPU.

  * P1 (``tools/ablate_fwd.py::build_variant``): the plain twins of
    ``full`` and ``noexit`` against the tool's kernels run through
    ``pl.pallas_call(..., interpret=True)`` with the tool's grid spec, on
    the tool's scene at 8 chunks of 128 entries, 1 and 4 chunks a tile:
    acc rows 0:ch and the T row within rtol 1e-3, atol 1e-4 (gstk_tpu's
    image parity tolerances; the TPU kernel forms sigma through a
    bf16-split basis product, the twin op by op). The ``full`` twin also
    against ``composite_tiles_fwd_plain`` on a scene where pixels stop
    (same tolerances), ``dmaonly``'s twin on a hand-computed case
    (exactly), and the refused variants raise.
  * P2 and P3 (``tools/bench_dynrow.py``'s ``pallas_local_perm`` and
    ``hbm_dynwrite``, nested in its ``main``, rebuilt from its code object
    with ``interpret=True``): the plain twins and the library call
    (``index_copy_``) equal the tool's kernels bit for bit at n = 2^12.
"""

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gstk_tpu.ops import raster_pallas as rp
from gstk_torch.ops.raster_cuda import composite_tiles_fwd_plain, pack_records
from gstk_torch.tools import ablate_fwd, bench_dynrow

REPO = Path(__file__).resolve().parent.parent
PARITY = dict(rtol=1e-3, atol=1e-4)


def _load_tool(name):
    """A script of ``tools/`` (no package there) as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tool_attr(c_per_tile, total_chunks, ch, seed=0):
    """The attribute table and tile bins of ``tools/ablate_fwd.py::main``."""
    cap = total_chunks * rp.CHUNK
    tiles = total_chunks // c_per_tile
    rng = np.random.default_rng(seed)
    attr = np.zeros((cap + rp.CHUNK, rp.ATTR_W), np.float32)
    tile_of = np.arange(cap) // (c_per_tile * rp.CHUNK)
    attr[:cap, 0] = tile_of * 16 + 8.0
    attr[:cap, 1] = 8.0
    attr[:cap, 2] = 1e-4
    attr[:cap, 4] = 1e-4
    attr[:cap, 5] = 0.004
    attr[:cap, 6:10] = rng.uniform(0, 1, (cap, 4))
    bins = np.stack([np.arange(tiles) * c_per_tile * rp.CHUNK,
                     (np.arange(tiles) + 1) * c_per_tile * rp.CHUNK],
                    axis=-1).astype(np.int32)
    return attr, bins, tiles


def _tool_variant(tool, variant, attr, bins, tiles, ch):
    """``tools/ablate_fwd.py::run_variant``'s call, in interpret mode and
    untimed: (T, out_rows, 256), acc in rows 0:ch, T in row ch."""
    num_tiles, p = tiles, 256
    orows = rp.out_rows(ch)
    tpc = rp._tiles_per_call(num_tiles)
    kernel = tool.build_variant(rp, variant, tiles, 16, ch, num_tiles, tpc)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(num_tiles // tpc,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((tpc, orows, p), lambda i, *_: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, rp.CHUNK, rp.ATTR_W), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))],
    )
    out = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((num_tiles, orows, p),
                                               jnp.float32),
        grid_spec=grid_spec, interpret=True,
    )(jnp.asarray(bins).reshape(-1), jnp.asarray(attr))
    return np.asarray(out)


@pytest.mark.parametrize("variant", ["full", "noexit"])
@pytest.mark.parametrize("c_per_tile", [1, 4])
def test_ablate_twin_matches_tool_kernel(variant, c_per_tile):
    ch, total_chunks = ablate_fwd.KERNEL_CH, 8
    tool = _load_tool("ablate_fwd")
    attr, bins, tiles = _tool_attr(c_per_tile, total_chunks, ch)
    want = _tool_variant(tool, variant, attr, bins, tiles, ch)
    records, gids, tile_bins, tiles_x = ablate_fwd.probe_scene(
        c_per_tile, total_chunks, ch, 0, "cpu")
    np.testing.assert_array_equal(tile_bins.numpy(), bins)
    acc, final_t = ablate_fwd.run_variant(variant, records, gids, tile_bins,
                                          tiles_x, ch)
    np.testing.assert_allclose(acc.permute(0, 2, 1).numpy(), want[:, :ch],
                               **PARITY)
    np.testing.assert_allclose(final_t.numpy(), want[:, ch], **PARITY)
    # every pair composites (alpha >= 1/255 at each), so no pixel stops
    n_entries = c_per_tile * rp.CHUNK
    assert 1e-4 < float(final_t.min())
    assert float(final_t.max()) <= (1 - 1 / 255) ** n_entries


def _stopping_scene(seed=0, tiles_x=3, tiles_y=2, n=400, ch=4):
    """Random Gaussians over a 3x2-tile image, opaque enough that pixels
    stop, with sentinel ids inside ranges and one empty range. The kernels
    skip a sentinel and ``composite_tiles_fwd_plain`` clamps it to the last
    Gaussian, which is transparent and in no range."""
    rng = np.random.default_rng(seed)
    num_tiles = tiles_x * tiles_y
    xys = rng.uniform(0, [16 * tiles_x, 16 * tiles_y], (n, 2))
    a = rng.uniform(0.01, 0.2, n)
    c = rng.uniform(0.01, 0.2, n)
    b = rng.uniform(-0.5, 0.5, n) * np.sqrt(a * c)
    conics = np.stack([a, b, c], 1)
    opacities = rng.uniform(0.3, 0.99, n)
    opacities[-1] = 0.0
    colors = rng.uniform(0, 1, (n, ch))
    lengths = rng.integers(20, 200, num_tiles)
    lengths[2] = 0
    gids = rng.integers(0, n - 1, int(lengths.sum()))
    gids[rng.uniform(size=gids.shape) < 0.05] = n  # sentinel
    ends = np.cumsum(lengths)
    bins = np.stack([ends - lengths, ends], 1)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    i32 = lambda x: torch.from_numpy(np.asarray(x, np.int32))
    return (f32(xys), f32(conics), f32(opacities), f32(colors), i32(gids),
            i32(bins), (tiles_x, tiles_y))


def test_ablate_full_twin_matches_composite_plain():
    xys, conics, opacities, colors, gids, bins, tiles = _stopping_scene()
    want_acc, want_t, visited = composite_tiles_fwd_plain(
        xys, conics, opacities, colors, gids, bins, tiles)
    lengths = (bins[:, 1] - bins[:, 0])[:, None]
    assert bool((visited < lengths).any())  # some pixels stop
    records = pack_records(xys, conics, opacities, colors)
    for variant in ("full", "noexit", "marg_none"):
        acc, final_t = ablate_fwd.run_variant(variant, records, gids, bins,
                                              tiles[0], 4)
        torch.testing.assert_close(acc, want_acc, **PARITY)
        torch.testing.assert_close(final_t, want_t, **PARITY)


def test_ablate_dmaonly_twin_by_hand():
    """Two tiles: tile 0 holds 300 entries (two batches, the second with 44
    entries), tile 1 none. Pixel p of tile 0 sums word p mod 12 of entry p
    and, for p < 44, of entry 256 + p."""
    n, cap = 350, 300
    records = torch.arange(n * 12, dtype=torch.float32).reshape(n, 12)
    gids = torch.arange(cap, dtype=torch.int32) + 7
    bins = torch.tensor([[0, cap], [cap, cap]], dtype=torch.int32)
    acc, final_t = ablate_fwd.run_variant("dmaonly", records, gids, bins, 2, 4)
    p = np.arange(256)
    want = (p + 7) * 12.0 + p % 12
    want[:44] += (256 + p[:44] + 7) * 12.0 + p[:44] % 12
    np.testing.assert_array_equal(acc[0, :, 0].numpy(), want.astype(np.float32))
    assert not acc[0, :, 1:].any() and not acc[1].any()
    assert bool((final_t == 1).all())
    # a sentinel or an out-of-range id reads zeros
    gids[5], gids[6] = n, -1
    acc, _ = ablate_fwd.run_variant("dmaonly", records, gids, bins, 2, 4)
    assert float(acc[0, 5, 0]) == float(want[5] - (5 + 7) * 12.0 - 5)
    assert float(acc[0, 6, 0]) == float(want[6] - (6 + 7) * 12.0 - 6)


def test_ablate_marg_twins_remove_their_part():
    """On the probe scene the marg twins differ from full where their part
    mattered: marg_contrib writes the weights' sum to every channel."""
    records, gids, bins, tiles_x = ablate_fwd.probe_scene(1, 2, 4, 0, "cpu")
    full, full_t = ablate_fwd.run_variant("full", records, gids, bins, tiles_x)
    contrib, contrib_t = ablate_fwd.run_variant("marg_contrib", records, gids,
                                                bins, tiles_x)
    torch.testing.assert_close(contrib_t, full_t, rtol=0, atol=0)
    weights = 1.0 - full_t  # every entry kept: the weights sum to 1 - T
    for c in range(4):
        torch.testing.assert_close(contrib[..., c], weights, rtol=1e-5,
                                   atol=1e-6)
    for variant in ("marg_sigma", "marg_exp"):
        acc, _ = ablate_fwd.run_variant(variant, records, gids, bins, tiles_x)
        assert not torch.equal(acc, full)
        torch.testing.assert_close(acc, full, rtol=0.05, atol=1e-3)


@pytest.mark.parametrize("variant", sorted(ablate_fwd.REFUSED) + ["bogus"])
def test_ablate_refuses_tpu_only_variants(variant):
    records, gids, bins, tiles_x = ablate_fwd.probe_scene(1, 1, 4, 0, "cpu")
    with pytest.raises(ValueError, match="counterpart|unknown"):
        ablate_fwd.run_variant(variant, records, gids, bins, tiles_x)


def test_ablate_main_on_cpu(capsys):
    results = ablate_fwd.main(["--device", "cpu"])
    assert sorted(results) == [1, 16]
    assert results[16]["tiles"] == 1 and results[1]["tiles"] == 16
    assert all(v is None for r in results.values()
               for v in r["variants"].values())
    assert all(r["launches"] == 0 for r in results.values())
    out = capsys.readouterr().out
    assert out.count("(matches full)") == 4


def _tool_dynrow_kernels(n):
    """``pallas_local_perm`` and ``hbm_dynwrite`` from the tool's ``main``,
    closed over ``n``, ``interpret=True`` and the jax modules."""
    tool = _load_tool("bench_dynrow")
    free = {"n": n, "interpret": True, "jax": jax, "jnp": jnp, "pl": pl,
            "pltpu": pltpu}
    found = {}
    for code in tool.main.__code__.co_consts:
        if isinstance(code, types.CodeType) and code.co_name in (
                "pallas_local_perm", "hbm_dynwrite"):
            cells = tuple(types.CellType(free[v]) for v in code.co_freevars)
            found[code.co_name] = types.FunctionType(
                code, tool.__dict__, code.co_name, None, cells)
    return found["pallas_local_perm"], found["hbm_dynwrite"]


@pytest.mark.parametrize("case", [("perm", 512, 8), ("perm", 512, 1),
                                  ("dynwrite", 512, 64), ("dynwrite", 512, 8)])
def test_dynrow_matches_tool_kernels(case):
    kind, R, rows = case
    n = 1 << 12
    local_perm_tool, dynwrite_tool = _tool_dynrow_kernels(n)
    rng = np.random.default_rng(0)
    tab = (rng.standard_normal((n, 128)) * 10).astype(np.float32)
    nb, per = n // R, R // rows
    if kind == "perm":
        index = np.stack([rng.permutation(per) for _ in range(nb)]).astype(np.int32)
        want = local_perm_tool(R, rows)(jnp.asarray(index), jnp.asarray(tab))
        plain = bench_dynrow.local_perm_plain
        wrapper = bench_dynrow.local_perm
        dest = bench_dynrow.perm_destinations(torch.from_numpy(index), R, rows)
    else:
        index = rng.permutation(n // rows).reshape(nb, per).astype(np.int32)
        want = dynwrite_tool(R, rows)(jnp.asarray(index), jnp.asarray(tab))
        plain = bench_dynrow.dynwrite_plain
        wrapper = bench_dynrow.dynwrite
        dest = torch.from_numpy(index).reshape(-1).long()
    want = np.asarray(want)
    table, idx = torch.from_numpy(tab), torch.from_numpy(index)
    before = wrapper.launches
    for got in (plain(table, idx, R, rows), wrapper(table, idx, R, rows),
                bench_dynrow.index_copy_rows(torch.empty_like(table), dest,
                                             table, rows)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert wrapper.launches == before  # CPU tensors: no kernel


def test_dynrow_drops_out_of_range_pieces():
    """A group or sub-block whose index is out of range writes nothing; the
    rest land as the library call puts them."""
    n, R = 64, 16
    table = torch.arange(n * 128, dtype=torch.float32).reshape(n, 128)
    perm = torch.tensor([[1, 0, 3, 2], [2, 9, 0, -1], [0, 1, 2, 3],
                         [3, 2, 1, 0]], dtype=torch.int32)
    got = bench_dynrow.local_perm(table, perm, R, 4)
    ok = perm.clone()
    ok[1] = torch.tensor([2, 1, 0, 3])
    want = bench_dynrow.index_copy_rows(
        torch.empty_like(table), bench_dynrow.perm_destinations(ok, R, 4),
        table, 4)
    # groups 1 and 3 of block 1 were dropped, so its destination groups 1
    # and 3 (rows 20..23 and 28..31) hold nothing known; every other row
    # equals
    keep = torch.ones(n, dtype=torch.bool)
    keep[16 + 4:16 + 8] = False
    keep[16 + 12:16 + 16] = False
    torch.testing.assert_close(got[keep], want[keep], rtol=0, atol=0)
    dst = torch.tensor([[3, 0], [1, 99]], dtype=torch.int32)
    got = bench_dynrow.dynwrite(table, dst, 32, 16)
    torch.testing.assert_close(got[48:64], table[0:16], rtol=0, atol=0)
    torch.testing.assert_close(got[0:16], table[16:32], rtol=0, atol=0)
    torch.testing.assert_close(got[16:32], table[32:48], rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["shape", "dtype", "ratio"])
def test_dynrow_rejects_bad_inputs(bad):
    table = torch.zeros(64, 128)
    perm = torch.zeros((4, 4), dtype=torch.int32)
    if bad == "shape":
        table = torch.zeros(64, 64)
    elif bad == "dtype":
        perm = perm.long()
    else:
        perm = torch.zeros((5, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        bench_dynrow.local_perm(table, perm, 16, 4)


def test_dynrow_main_on_cpu():
    results = bench_dynrow.main(["--device", "cpu"])
    assert results["A_gather"]["library"] is None
    cases = {r["case"] for k, r in results.items() if k != "A_gather"}
    assert cases == set(bench_dynrow.PERM_CASES) | set(bench_dynrow.DYNWRITE_CASES)
    assert all(r["equal"] == {"library": True} and r["launches"] == 0
               for k, r in results.items() if k != "A_gather")
