"""gstk_torch's CUDA kernels against their plain twins on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when no
CUDA device is present (decided at run time, never at import). Run on a
machine with a card:

    python -m pytest -m gpu tests/test_torch_gpu.py

K3 (segment broadcast) must equal its twin exactly; K1 (tile compositing)
must agree within gstk_tpu's image parity tolerances (rtol 1e-3, atol 1e-4);
K2 (compositing backward) within the gradient tolerance (rtol 5e-3, atol
1e-4 of each column's largest value); K4 (segment sum) within rtol 1e-5 and
atol 1e-6 of the segment's sum of magnitudes (the f32 summation error grows
with it; one segment here sums 40k values), in both input layouts. The
backward K2 -> gather -> K4
must give the same bits on every run. K1 and K2 are also held against their
twins on intersections built by hand (``_tile_case``): a range long enough
that their batches wrap many times, opaque tiles where pixels stop at
different entries, sentinel ids inside ranges, and empty ranges.

Refinement (``train/strategy.py::refine``, plain PyTorch) on the card
against the CPU from the same state and split noise: equal alive masks
and ``info``, parameters within rtol 1e-6 (the means within 1e-6 of the
largest ``|mean|``: a split child's mean sums its parent's and an offset
whose ``exp`` and matrix product round differently on the two devices).

The back end on the card: a crop-box render and a four-band 1920x1080
render (four K1 and four K3 launches) against the same renders through the
plain twins (image tolerances, 0.1% of pixels allowed outside for the 1/255
cutoff); the crop mask, LPIPS (rtol 1e-4) and TSDF integration (atol 1e-5
on all but 0.1% of voxels, weights equal outside them) against the CPU;
SSIM and LPIPS unchanged with cuDNN's TF32 switched on globally; and a
depth PNG of a far scene clamped at 65535 mm.
"""

import numpy as np
import pytest
import torch

from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import scene_from_numpy
from gstk_torch.models.vanilla import splat_inputs
from gstk_torch.ops.binning import bin_gaussians, expansion_positions
from gstk_torch.ops.raster_cuda import (
    composite_tiles_bwd,
    composite_tiles_bwd_plain,
    composite_tiles_fwd,
    composite_tiles_fwd_plain,
    pack_records,
)
from gstk_torch.ops.segment_kernel import (
    segment_broadcast,
    segment_broadcast_plain,
    segment_sum_sorted,
    segment_sum_sorted_plain,
)

pytestmark = pytest.mark.gpu

PARITY = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


K3_CASES = ("random", "past_length", "zero_counts", "long_tail", "wide_window",
            "odd_length", "one_column")


@pytest.mark.parametrize("case", K3_CASES)
def test_segment_broadcast_kernel_equals_twin(cuda, case):
    """Three columns (one in ``one_column``). long_tail: over 300,000 slots
    past the last boundary, which the tail CTAs fill; wide_window: 3,000
    equal boundaries at slot 5,001, wider than a CTA's run of 64, so runs
    own no slot and one slot ends many runs; odd_length: a length that is a
    multiple of neither a tail CTA's slots nor the 4 slots a thread stores
    at once."""
    g = torch.Generator(device=cuda).manual_seed(0)
    n, length = 50_000, 1 << 18
    counts = torch.randint(0, 9, (n,), generator=g, device=cuda)
    if case == "zero_counts":
        counts[torch.rand(n, generator=g, device=cuda) < 0.7] = 0
    if case == "long_tail":
        counts = torch.randint(0, 3, (n,), generator=g, device=cuda)
        length = 1 << 19
    if case == "odd_length":
        length = (1 << 18) - 1001
    b = torch.cumsum(counts, 0)
    if case == "past_length":
        b = b * 2
    if case == "wide_window":
        b = torch.sort(torch.cat([b[:-3000], torch.full_like(b[:3000], 5001)])).values
    ds = [torch.ones(n, dtype=torch.int32, device=cuda)] + [
        torch.randint(-2**31, 2**31, (n,), generator=g, device=cuda,
                      dtype=torch.int64).int() for _ in range(2)
    ]
    if case == "one_column":
        ds = ds[:1]
    if case == "long_tail":
        assert length - int(b[-1]) >= 300_000
    before = segment_broadcast.launches
    got = segment_broadcast(b.int(), ds, length)
    assert segment_broadcast.launches == before + 1
    for x, y in zip(got, segment_broadcast_plain(b.int(), ds, length)):
        assert torch.equal(x, y)


def _scene(rng, n=3000, sh=1, opacity_logit=None):
    means = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      rng.uniform(-8, -2, n)], -1)
    arrays = {
        "means": means, "scales": rng.uniform(-4.0, -2.0, (n, 3)),
        "quats": rng.normal(size=(n, 4)), "features_dc": rng.normal(size=(n, 3)),
        "features_rest": 0.3 * rng.normal(size=(n, (sh + 1) ** 2 - 1, 3)),
        "opacities": rng.uniform(-1.0, 3.0, (n, 1)), "alive": np.ones(n, bool),
    }
    if opacity_logit is not None:  # e.g. logit(0.99): tiles stop early
        arrays["opacities"][:] = opacity_logit
    return {k: v.astype(np.float32) if k != "alive" else v for k, v in arrays.items()}


@pytest.mark.parametrize("ch", [3, 4])
def test_composite_kernel_matches_twin(cuda, ch):
    h, w = 240, 320
    scene = scene_from_numpy(_scene(np.random.default_rng(0)), cuda)
    camera = Camera.create(300.0, 300.0, w / 2, h / 2, np.eye(4)[:3], device=cuda)
    tiles = ((w + 15) // 16, (h + 15) // 16)
    with torch.no_grad():
        inp = splat_inputs(scene, camera, h, w, sh_degree=1)
        isect = bin_gaussians(inp["xys"], inp["depths"], inp["radii"],
                              inp["num_tiles_hit"], tiles, 16, 1 << 18)
    assert 0 < int(isect.num_intersects) <= 1 << 18
    args = (inp["xys"], inp["conics"], inp["opacities"],
            inp["colors"][:, :ch].contiguous(), isect.gaussian_ids,
            isect.tile_bins, tiles)
    before = composite_tiles_fwd.launches
    acc, final_t = composite_tiles_fwd(*args)
    assert composite_tiles_fwd.launches == before + 1
    acc_p, final_t_p, _ = composite_tiles_fwd_plain(*args)
    torch.testing.assert_close(acc, acc_p, **PARITY)
    torch.testing.assert_close(final_t, final_t_p, **PARITY)
    assert float(final_t.mean()) < 0.95  # the scene covers the view


def test_composite_kernel_rejects_untaken_shapes(cuda):
    n = 8
    f = lambda *s: torch.zeros(s, device=cuda)
    args = (f(n, 2), f(n, 3), f(n), f(n, 5),
            torch.zeros(16, dtype=torch.int32, device=cuda),
            torch.zeros(1, 2, dtype=torch.int32, device=cuda), (1, 1))
    with pytest.raises(ValueError, match="ch in"):
        composite_tiles_fwd(*args)


def _close(got, want, rtol, atol):
    """|got - want| <= atol + rtol |want| (atol broadcasts)."""
    ok = (got - want).abs() <= atol + rtol * want.abs()
    assert bool(ok.all()), (
        f"{int((~ok).sum())} of {ok.numel()} outside, max abs err "
        f"{float((got - want).abs().max())}"
    )


def _backward_inputs(cuda, ch, opacity_logit=None, seed=0):
    """A scene's intersections, K1's outputs and random cotangents."""
    h, w = 240, 320
    scene = scene_from_numpy(_scene(np.random.default_rng(seed),
                                    opacity_logit=opacity_logit), cuda)
    camera = Camera.create(300.0, 300.0, w / 2, h / 2, np.eye(4)[:3], device=cuda)
    tiles = ((w + 15) // 16, (h + 15) // 16)
    with torch.no_grad():
        inp = splat_inputs(scene, camera, h, w, sh_degree=1)
        isect = bin_gaussians(inp["xys"], inp["depths"], inp["radii"],
                              inp["num_tiles_hit"], tiles, 16, 1 << 18)
    assert 0 < int(isect.num_intersects) <= 1 << 18
    fwd = (inp["xys"], inp["conics"], inp["opacities"],
           inp["colors"][:, :ch].contiguous(), isect.gaussian_ids,
           isect.tile_bins, tiles)
    acc, final_t = composite_tiles_fwd(*fwd)
    g = torch.Generator(device=cuda).manual_seed(seed)
    g_acc = torch.randn(acc.shape, generator=g, device=cuda)
    g_t = torch.randn(final_t.shape, generator=g, device=cuda)
    return fwd[:6] + (acc, final_t, g_acc, g_t, tiles), isect, inp


@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("ch", [3, 4])
def test_composite_bwd_kernel_matches_twin(cuda, ch, opaque):
    """K2 against its twin; with opacity 0.99 most tiles stop early, and the
    entries they never reach must stay zero."""
    args, isect, _ = _backward_inputs(
        cuda, ch, opacity_logit=float(np.log(99.0)) if opaque else None
    )
    before = composite_tiles_bwd.launches
    gout = composite_tiles_bwd(*args)
    assert composite_tiles_bwd.launches == before + 1
    gout_p, kept = composite_tiles_bwd_plain(*args)
    assert gout.shape == (isect.gaussian_ids.shape[0], 6 + ch)
    _close(gout, gout_p, 5e-3, 1e-4 * gout_p.abs().amax(0, keepdim=True))
    assert int(kept.sum()) > 0
    untouched = gout_p.abs().sum(1) == 0
    assert bool((gout[untouched] == 0).all())
    if opaque:
        assert float(untouched[: int(isect.num_intersects)].float().mean()) > 0.1


K4_CASES = ("random", "empty", "one_covers_all", "clipped", "long", "overflow",
            "empty_run", "odd_n", "rows_9")


@pytest.mark.parametrize("case", K4_CASES)
def test_segment_sum_kernel_matches_twin(cuda, case):
    """Each case in both layouts: the entry-major view the backward passes
    (``x.t()`` of a contiguous (Np, rows) tensor) and a contiguous
    attribute-major (rows, Np) tensor, which the wrapper copies. long: a
    segment of 2,500 entries, summed by a warp from global memory, and one
    of 100, summed by a warp from shared memory; overflow: the 128
    Gaussians of one CTA with 31 entries each, a span (158,720 B) larger
    than the staging buffer; empty_run: 700 empty segments in a row; odd_n: N not a
    multiple of a CTA's 128 Gaussians; rows_9: the backward's rows at ch 3,
    36-B entries, so spans start at every 4-B offset of a 16-B vector."""
    g = torch.Generator(device=cuda).manual_seed(1)
    rows, npv, n = 10, 1 << 16, 20_000
    if case == "odd_n":
        n = 12_345
    if case == "rows_9":
        rows = 9
    counts = torch.randint(0, 7, (n,), generator=g, device=cuda)
    if case == "empty":  # most segments empty, as dead Gaussians are
        counts[torch.rand(n, generator=g, device=cuda) < 0.8] = 0
    if case == "long":  # and one a warp sums from the staged span
        counts[5000] = 2500
        counts[9000] = 100
    if case == "overflow":
        counts[256:384] = 31
    if case == "empty_run":
        counts[3000:3700] = 0
    hi = torch.cumsum(counts, 0)
    if case == "one_covers_all":
        hi = torch.zeros(n, dtype=torch.int64, device=cuda)
        hi[n // 3:] = npv + 100
    if case == "clipped":  # ends run past Np and are clipped there
        hi = hi * 8
    entry_major = torch.randn((npv, rows), generator=g, device=cuda)
    lo = torch.cat([hi.new_zeros(1), torch.clamp(hi, max=npv)[:-1]])
    empty = torch.clamp(hi, max=npv) <= lo
    for vals in (entry_major.t(), entry_major.t().contiguous()):
        before = segment_sum_sorted.launches
        got = segment_sum_sorted(vals, hi.int())
        assert segment_sum_sorted.launches == before + 1
        want = segment_sum_sorted_plain(vals, hi.int())
        _close(got, want, 1e-5,
               1e-6 * segment_sum_sorted_plain(vals.abs(), hi.int()))
        assert bool((got[:, empty] == 0).all())


TILE_CASES = ("long", "opaque", "sentinel", "empty")


def _tile_case(cuda, ch, case, seed=0):
    """Intersections built by hand: each tile's range holds its own
    Gaussians, centred in or near the tile, in a random depth order.

    long: a tile of 1,500 faint, wide entries that no pixel stops in, so K1's
    staged batches and K2's partial batches wrap many times; opaque: opacity
    0.99 and small footprints, so pixels (and warps) stop at different
    entries; sentinel: every 5th id of a range is a sentinel (N, or past
    it), which the kernels skip and the twins clamp to the last Gaussian,
    made transparent and kept out of every range; empty: every other range
    is empty, the first and the last included."""
    rng = np.random.default_rng(seed)
    tiles, lengths = {
        "long": ((2, 1), [1500, 700]),
        "opaque": ((3, 2), list(rng.integers(100, 400, 6))),
        "sentinel": ((3, 2), [300] * 6),
        "empty": ((4, 2), [0, 200, 0, 150, 0, 0, 300, 0]),
    }[case]
    n = sum(lengths) + 1  # the last Gaussian is in no range
    tile_of = np.repeat(np.arange(len(lengths)), lengths)
    origin = np.stack([tile_of % tiles[0], tile_of // tiles[0]], 1) * 16.0
    xys = np.concatenate([origin + rng.uniform(-6, 22, (n - 1, 2)),
                          np.zeros((1, 2))])
    if case == "long":
        ac = rng.uniform(0.001, 0.004, (n, 2))
        opacities = rng.uniform(0.004, 0.008, n)
    else:
        ac = rng.uniform(0.02, 0.3, (n, 2))
        opacities = (np.full(n, 0.99) if case == "opaque"
                     else rng.uniform(0.05, 0.6, n))
    b = rng.uniform(-0.5, 0.5, n) * np.sqrt(ac[:, 0] * ac[:, 1])
    conics = np.stack([ac[:, 0], b, ac[:, 1]], 1)
    opacities[-1] = 0.0
    colors = rng.uniform(0, 1, (n, ch))
    ends = np.cumsum(lengths)
    gids = np.concatenate([rng.permutation(np.arange(e - l, e))
                           for e, l in zip(ends, lengths)] + [np.full(16, n)])
    if case == "sentinel":
        gids[: ends[-1]][::5] = n + rng.integers(0, 3, len(gids[: ends[-1]][::5]))
    bins = np.stack([ends - np.asarray(lengths), ends], 1)
    t = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt, device=cuda)
    return (t(xys), t(conics), t(opacities), t(colors), t(gids, torch.int32),
            t(bins, torch.int32), tiles), lengths


@pytest.mark.parametrize("case", TILE_CASES)
@pytest.mark.parametrize("ch", [3, 4])
def test_composite_kernel_matches_twin_on_tile_cases(cuda, ch, case):
    args, lengths = _tile_case(cuda, ch, case)
    acc, final_t = composite_tiles_fwd(*args)
    acc_p, final_t_p, visited = composite_tiles_fwd_plain(*args)
    torch.testing.assert_close(acc, acc_p, **PARITY)
    torch.testing.assert_close(final_t, final_t_p, **PARITY)
    per_tile = visited.amax(1).cpu().numpy()
    if case == "long":
        assert per_tile[0] == lengths[0] >= 1000  # no pixel stopped
    if case == "opaque":  # pixels stop, and at different entries
        assert bool((visited < torch.tensor(lengths, device=cuda)[:, None]).any())
        assert int(torch.unique(visited).numel()) > 10
    if case == "empty":
        empty = np.asarray(lengths) == 0
        assert (per_tile[empty] == 0).all()
        assert bool((final_t[torch.from_numpy(empty).to(cuda)] == 1).all())


@pytest.mark.parametrize("case", TILE_CASES)
@pytest.mark.parametrize("ch", [3, 4])
def test_composite_bwd_kernel_matches_twin_on_tile_cases(cuda, ch, case):
    fwd, _ = _tile_case(cuda, ch, case)
    acc, final_t = composite_tiles_fwd(*fwd)
    g = torch.Generator(device=cuda).manual_seed(1)
    args = fwd[:6] + (acc, final_t,
                      torch.randn(acc.shape, generator=g, device=cuda),
                      torch.randn(final_t.shape, generator=g, device=cuda),
                      fwd[6])
    gout = composite_tiles_bwd(*args)
    gout_p, kept = composite_tiles_bwd_plain(*args)
    _close(gout, gout_p, 5e-3, 1e-4 * gout_p.abs().amax(0, keepdim=True))
    assert int(kept.sum()) > 0
    untouched = gout_p.abs().sum(1) == 0
    assert bool((gout[untouched] == 0).all())
    if case == "sentinel":
        assert bool((gout[fwd[4] >= fwd[0].shape[0]] == 0).all())


def test_backward_is_deterministic(cuda):
    """K2 -> gather by expansion position -> K4 twice: the same bits."""
    args, isect, inp = _backward_inputs(cuda, 4, seed=2)
    positions = expansion_positions(isect)
    hi = torch.clamp(torch.cumsum(inp["num_tiles_hit"].long(), 0),
                     max=isect.gaussian_ids.shape[0])

    def backward():
        gout = composite_tiles_bwd(*args)
        return segment_sum_sorted(gout.index_select(0, positions).t(), hi)

    assert torch.equal(backward(), backward())


@pytest.mark.parametrize("step", [150, 451])  # before / past the first reset
def test_refine_cuda_matches_cpu(cuda, step):
    from gstk_torch.core.gaussians import init_scene
    from gstk_torch.models.vanilla import VanillaConfig
    from gstk_torch.train.checkpoint import (
        train_state_from_numpy,
        train_state_to_numpy,
    )
    from gstk_torch.train.step import init_train_state
    from gstk_torch.train.strategy import RefineState, refine

    g = torch.Generator().manual_seed(3)
    n, cap = 3000, 8192
    pts = (torch.rand((n, 3), generator=g) * 4 - 2).numpy()
    rgb = (torch.rand((n, 3), generator=g) * 255).numpy()
    state = init_train_state(init_scene(g, cap, (pts, rgb), sh_degree=1,
                                        device="cpu"))
    with torch.no_grad():
        state.scene.opacities.normal_(0.0, 2.0, generator=g)
        state.scene.scales.uniform_(-7.0, -2.0, generator=g)
    state.refine = RefineState(
        xys_grad_norm=torch.rand(cap, generator=g) * 1e-6,
        vis_counts=torch.randint(0, 5, (cap,), generator=g).float(),
        max_2dsize=torch.rand(cap, generator=g) * 0.2,
    )
    state.step = torch.tensor(step, dtype=torch.int32)
    flat = train_state_to_numpy(state)
    cfg = VanillaConfig(warmup_length=0, refine_every=10, reset_alpha_every=30)
    noise = torch.randn((cfg.n_split_samples, cap, 3), generator=g)
    out = {}
    for dev in ("cpu", cuda):
        s = train_state_from_numpy(flat, dev)
        scene, adam, _, info = refine(s.scene, s.adam, s.refine, s.step, cfg,
                                      20, 800, noise=noise.to(dev))
        s.scene, s.adam = scene, adam
        out[str(dev)] = (train_state_to_numpy(s),
                         {k: v.item() for k, v in info.items()})
    (got, got_info), (want, want_info) = out["cuda"], out["cpu"]
    assert got_info == want_info
    assert want_info["num_split"] > 0 and want_info["num_dup"] > 0
    assert want_info["num_cull"] > 0
    np.testing.assert_array_equal(got[".scene/.alive"], want[".scene/.alive"])
    means_atol = 1e-6 * np.abs(want[".scene/.means"]).max()
    for k, v in want.items():
        atol = means_atol if k == ".scene/.means" else 1e-7
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=atol, err_msg=k)


# probe P1: K1's ablation clones (gstk_torch/tools/ablate_fwd.py)
def _ablate_check(cuda, records, gids, bins, tiles_x):
    """Every clone against its twin (parity tolerances; dmaonly, whose sum
    takes the twin's order, rtol 1e-6); full and marg_none against K1 and
    noexit against full, bit for bit."""
    from gstk_torch.tools import ablate_fwd

    xys, conics, op, colors = (records[:, 0:2], records[:, 2:5], records[:, 5],
                               records[:, 6:10])
    tiles = (tiles_x, bins.shape[0] // tiles_x)
    k1 = composite_tiles_fwd(xys, conics, op, colors, gids, bins, tiles,
                             records=records)
    outs = {}
    for variant in ablate_fwd.VARIANTS:
        before = ablate_fwd.run_variant.launches
        outs[variant] = ablate_fwd.run_variant(variant, records, gids, bins,
                                               tiles_x)
        assert ablate_fwd.run_variant.launches == before + 1
        twin = ablate_fwd.ablate_fwd_plain(variant, records, gids, bins,
                                           tiles_x)
        tol = dict(rtol=1e-6, atol=0.0) if variant == "dmaonly" else PARITY
        for got, want in zip(outs[variant], twin):
            torch.testing.assert_close(got, want, **tol)
    for variant, ref in (("full", k1), ("marg_none", k1),
                         ("noexit", outs["full"])):
        for got, want in zip(outs[variant], ref):
            assert torch.equal(got, want), variant


@pytest.mark.parametrize("c_per_tile", [1, 16])
def test_ablate_kernels_on_the_probe_scene(cuda, c_per_tile):
    from gstk_torch.tools.ablate_fwd import probe_scene

    _ablate_check(cuda, *probe_scene(c_per_tile, 64, 4, 0, cuda))


@pytest.mark.parametrize("case", TILE_CASES)
def test_ablate_kernels_on_tile_cases(cuda, case):
    (xys, conics, op, colors, gids, bins, tiles), _ = _tile_case(cuda, 4, case)
    records = pack_records(xys, conics, op, colors)
    _ablate_check(cuda, records, gids, bins, tiles[0])


def test_ablate_kernel_takes_ch_4_only(cuda):
    from gstk_torch.tools import ablate_fwd

    records, gids, bins, tiles_x = ablate_fwd.probe_scene(1, 2, 3, 0, cuda)
    with pytest.raises(ValueError, match="ch 4"):
        ablate_fwd.run_variant("full", records, gids, bins, tiles_x, 3)


# probes P2 and P3: row scatters (gstk_torch/tools/bench_dynrow.py)
@pytest.mark.parametrize("case", [("perm", 4096, 8), ("perm", 4096, 1),
                                  ("perm", 512, 8), ("perm", 512, 2),
                                  ("dynwrite", 4096, 64), ("dynwrite", 4096, 8),
                                  ("dynwrite", 4096, 256), ("dynwrite", 512, 1)])
def test_dynrow_kernels_equal_twins(cuda, case):
    """Bit for bit against the plain twin and the library call, at n = 2^15
    rows; then with some indices out of range, which every version drops."""
    from gstk_torch.tools import bench_dynrow as dr

    kind, R, rows = case
    n = 1 << 15
    g = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn((n, 128), generator=g, device=cuda)
    nb, per = n // R, R // rows
    if kind == "perm":
        fn, plain = dr.local_perm, dr.local_perm_plain
        index = torch.argsort(torch.rand((nb, per), generator=g, device=cuda),
                              dim=1).int()
        dest = dr.perm_destinations(index, R, rows)
    else:
        fn, plain = dr.dynwrite, dr.dynwrite_plain
        index = torch.randperm(n // rows, generator=g, device=cuda)
        index = index.int().reshape(nb, per)
        dest = index.reshape(-1).long()
    before = fn.launches
    got = fn(table, index, R, rows)
    assert fn.launches == before + 1
    assert torch.equal(got, plain(table, index, R, rows))
    assert torch.equal(got, dr.index_copy_rows(torch.empty_like(table), dest,
                                               table, rows))
    bad = index.clone()
    bad.view(-1)[::7] = -1
    bad.view(-1)[3::7] = per if kind == "perm" else n // rows
    got, want = fn(table, bad, R, rows), plain(table, bad, R, rows)
    hit = torch.zeros(n // rows, dtype=torch.bool, device=cuda)
    ok = (bad >= 0) & (bad < (per if kind == "perm" else n // rows))
    bad_dest = (bad.reshape(-1).long() if kind == "dynwrite"
                else dr.perm_destinations(bad.clamp(0, per - 1), R, rows))
    hit[bad_dest[ok.view(-1)]] = True
    hit = hit.repeat_interleave(rows)
    assert bool(hit.any()) and not bool(hit.all())
    assert torch.equal(got[hit], want[hit])


def test_train_cache_build_on_the_card(cuda, tmp_path):
    """24 frames of 800x800 RGBA with depth: the d = 4 bucket built frame
    by frame on the card equals the per-frame path and ``area_downscale``
    of the whole stack bit for bit, the depths every 4th pixel, and the
    device peak of the build stays under ``train_cache_bytes``; a uint8
    frame dequantizes to n / 255 exactly."""
    import types

    from gstk_torch.data.datamanager import CachedFrame
    from gstk_torch.train import trainer as trainer_mod

    u8 = torch.arange(256, dtype=torch.uint8, device=cuda)
    np.testing.assert_array_equal(
        trainer_mod._dequantize_image(u8).cpu().numpy(),
        np.arange(256, dtype=np.float32) / np.float32(255))
    rng = np.random.default_rng(0)
    frames = [CachedFrame(
        image=rng.integers(0, 256, (800, 800, 4)).astype(np.float32) / np.float32(255),
        fx=1000.0, fy=1000.0, cx=400.0, cy=400.0,
        c2w=np.eye(4, dtype=np.float32)[:3],
        depth=rng.uniform(0.5, 5.0, (800, 800)).astype(np.float32))
        for _ in range(24)]
    trainer = trainer_mod.Trainer(trainer_mod.TrainerConfig(), device=cuda)
    trainer.datamanager = types.SimpleNamespace(train_frames=frames)
    # the process's first matrix product allocates cuBLAS's workspace, once
    # and for good: not a byte of the build
    trainer_mod.area_downscale(torch.zeros((8, 8, 4), device=cuda), 4)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, imgs, _, depths, _, _ = trainer._device_train_cache(4)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= trainer_mod.train_cache_bytes(24, (800, 800, 4), 4, False,
                                                 True)
    for i in (0, 5, 23):
        _, gt, _, depth, _, _ = trainer._frame_to_device(frames[i], 4)
        assert torch.equal(imgs[i], gt) and torch.equal(depths[i], depth)
        np.testing.assert_array_equal(depth.cpu().numpy(),
                                      frames[i].depth[::4, ::4])
    stack = torch.from_numpy(np.stack([f.image for f in frames])).to(cuda)
    assert torch.equal(imgs, trainer_mod.area_downscale(stack, 4))


# -- the back end (gs-eval, gs-render, gs-export) ----------------------------

def _render_pair(scene, camera, h, w, **kw):
    """One render through the kernels and the same through the plain
    twins, both on the scene's device; the kernels' launch counts."""
    from gstk_torch.models.vanilla import render_scene
    from gstk_torch.ops.rasterize import RasterizeConfig

    before = (composite_tiles_fwd.launches, segment_broadcast.launches)
    outs = []
    for backend in ("auto", "plain"):
        cfg = RasterizeConfig(isect_capacity=1 << 18, bands=0, backend=backend,
                              forward_only=True)
        with torch.no_grad():
            outs.append(render_scene(scene, camera, h, w, sh_degree=1,
                                     background=torch.zeros(3, device=camera.c2w.device),
                                     raster_config=cfg, **kw))
        if backend == "auto":
            launches = (composite_tiles_fwd.launches - before[0],
                        segment_broadcast.launches - before[1])
    for k in ("rgb", "depth", "alpha"):
        got, want = outs[0][k], outs[1][k]
        ok = (got - want).abs() <= PARITY["atol"] + PARITY["rtol"] * want.abs()
        assert float((~ok).float().mean()) <= 1e-3, (k, int((~ok).sum()))
    return outs[0], launches


def test_crop_box_render_on_the_card(cuda):
    from gstk_torch.core.scene_box import OrientedBox

    arrays = _scene(np.random.default_rng(1))
    scene = scene_from_numpy(arrays, cuda)
    box = OrientedBox.from_params([0.2, 0.1, 0.5], [0.0, 0.0, -5.0],
                                  [3.0, 2.0, 4.0], device=cuda)
    inside = box.within(scene.means)
    cpu_box = OrientedBox.from_params([0.2, 0.1, 0.5], [0.0, 0.0, -5.0],
                                      [3.0, 2.0, 4.0], device="cpu")
    assert torch.equal(inside.cpu(), cpu_box.within(torch.from_numpy(arrays["means"])))
    assert 0 < int(inside.sum()) < len(inside)
    h, w = 240, 320
    camera = Camera.create(300.0, 300.0, w / 2, h / 2, np.eye(4)[:3], device=cuda)
    full, _ = _render_pair(scene, camera, h, w)
    cropped, launches = _render_pair(scene, camera, h, w, crop_box=box)
    assert launches == (1, 1)
    assert 0 < float(cropped["alpha"].sum()) < float(full["alpha"].sum())


def test_four_band_render_1080p(cuda):
    """1920x1080 resolves to four bands (one per 640,000 pixels); each band
    launches K1 and K3 once, and the image, seams between the bands
    included, matches the plain twins."""
    arrays = _scene(np.random.default_rng(2), n=6000)
    scene = scene_from_numpy(arrays, cuda)
    h, w = 1080, 1920
    camera = Camera.create(1000.0, 1000.0, w / 2, h / 2, np.eye(4)[:3], device=cuda)
    out, launches = _render_pair(scene, camera, h, w)
    assert launches == (4, 4)
    assert out["rgb"].shape == (h, w, 3)
    # every band holds a part of the scene: rows 0-271, 272-543, 544-815, 816-1079
    for y0, y1 in ((0, 272), (272, 544), (544, 816), (816, 1080)):
        assert float(out["alpha"][y0:y1].mean()) > 0.05


def test_lpips_on_the_card_matches_cpu_and_ignores_tf32(cuda):
    from gstk_torch.utils.losses import ssim
    from gstk_torch.utils.lpips import lpips, random_lpips_params

    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (128, 128, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    cpu = float(lpips(random_lpips_params(0, device="cpu"), torch.from_numpy(a),
                      torch.from_numpy(b)))
    params = random_lpips_params(0, device=cuda)
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    saved = torch.backends.cudnn.allow_tf32
    try:
        results = {}
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            results[tf32] = (float(lpips(params, ta, tb)), float(ssim(ta, tb)))
            assert torch.backends.cudnn.allow_tf32 == tf32  # restored
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    np.testing.assert_allclose(results[False][0], cpu, rtol=1e-4)
    np.testing.assert_allclose(results[True], results[False], rtol=1e-6)
    np.testing.assert_allclose(results[False][1], float(ssim(
        torch.from_numpy(a), torch.from_numpy(b))), rtol=1e-5)


def test_integrate_frames_on_the_card_matches_cpu(cuda):
    from gstk_torch.exporter.tsdf import integrate_frames, make_volume

    rng = np.random.default_rng(0)
    n, h, w = 3, 96, 96
    depths = (2.0 + 0.3 * rng.uniform(-1, 1, (n, h, w))).astype(np.float32)
    depths[:, :10] = 0
    colors = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    intr = np.tile(np.array([[80, 80, 48, 48]], np.float32), (n, 1))
    w2cs = np.stack([np.eye(4, dtype=np.float32)] * n)
    w2cs[1, :3, 3] = [0.1, 0.0, 0.0]
    w2cs[2, :3, 3] = [0.0, 0.05, 0.1]
    box = ((-1.5, -1.5, 0.5), (3, 3, 3), 0.025)
    vols = [integrate_frames(make_volume(*box, device=d), depths, colors, intr,
                             w2cs, 0.1) for d in (cuda, "cpu")]
    got, want = vols
    outside = torch.zeros(want.tsdf.shape, dtype=torch.bool)
    for k in ("tsdf", "colors"):
        a, b = getattr(got, k).cpu(), getattr(want, k)
        bad = (a - b).abs() > 1e-5
        outside |= bad if bad.ndim == 3 else bad.any(-1)
    assert float(outside.float().mean()) <= 1e-3, int(outside.sum())
    assert torch.equal(got.weights.cpu()[~outside], want.weights[~outside])
    assert float(want.weights.max()) == 3


def test_depth_png_clamped_on_a_far_render(cuda, tmp_path):
    """A scene 60-90 m away rendered on the card: its depth PNG holds
    min(mm, 65535), as Pillow writes gstk_tpu's uint32 array."""
    from gstk_torch.scripts.render import _save_depth_mm
    from gstk_torch.utils.io import read_png

    arrays = _scene(np.random.default_rng(3), n=3000)
    arrays["means"][:, :2] *= 15.0
    arrays["means"][:, 2] = np.random.default_rng(4).uniform(-90, -60, 3000)
    arrays["scales"][:] = -0.5
    scene = scene_from_numpy(arrays, cuda)
    h, w = 120, 160
    camera = Camera.create(150.0, 150.0, w / 2, h / 2, np.eye(4)[:3], device=cuda)
    out, _ = _render_pair(scene, camera, h, w)
    depth = out["depth"].cpu().numpy()
    _save_depth_mm(tmp_path / "d.png", depth)
    got = read_png(tmp_path / "d.png")
    mm = (1000.0 * depth).astype(np.uint32)
    assert got.dtype == np.uint16 and (mm > 65535).mean() > 0.1
    np.testing.assert_array_equal(got, np.minimum(mm, 65535))
