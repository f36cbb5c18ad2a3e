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

The data and the viewer on the card: two raytraced views (128x128,
supersample 3) against the CPU's (RGBA and depth equal in >= 99.9% of
pixels, alpha equal, depth within 1 mm, seed points within 1e-9); a
``TrainingViewer`` frame at 640x480, rgb and depth, through K1 and K3
against the plain twins (uint8 within 1 level on all but 0.1% of pixels);
and the launch counters of K1 and K3 exact while two threads render.
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


# -- the projection kernels (csrc/project_fwd.cu, csrc/project_bwd.cu) -----

PROJ_H, PROJ_W, PROJ_F = 240, 320, 300.0


def _close_lanes(got, want, rtol, share):
    """|got - want| <= rtol |want| + share * (the lane's largest |want|)."""
    lane = want.abs().reshape(want.shape[0], -1).amax(1)
    atol = share * lane.reshape((-1,) + (1,) * (want.ndim - 1))
    ok = (got - want).abs() <= atol + rtol * want.abs()
    assert bool(ok.all()), (
        f"{int((~ok).sum())} of {ok.numel()} outside, lanes "
        f"{torch.nonzero(~ok)[:4, 0].tolist()}")


def _lane_errors(got, exact):
    """Per lane, the largest |got - exact| over the lane's largest
    |exact|."""
    got = got.reshape(got.shape[0], -1).double()
    exact = exact.reshape(exact.shape[0], -1).double()
    return (got - exact).abs().amax(1) / (exact.abs().amax(1) + 1e-30)


def _projection_case(cuda, sh=3, seed=0, n=1 << 16):
    """A drawn scene of ``n`` lanes at SH degree ``sh``: a tenth dead, means
    in front of, beside and behind the camera, scales from sub-pixel to a
    fifth of the view. Planted ties: lane 0's mean lies on the view-space
    clamp +1.3 tan(fovx), lane 1's on -1.3 tan(fovy) (tz = 2, so t * (1/tz)
    is exact), lane 2's red SH colour on max(rgb + 0.5, 0)'s tie."""
    rng = np.random.default_rng(seed)
    arrays = _scene(rng, n=n, sh=sh)
    arrays["means"] = np.stack([rng.uniform(-6, 6, n), rng.uniform(-4, 4, n),
                                rng.uniform(-12, 1, n)], -1).astype(np.float32)
    arrays["scales"] = rng.uniform(-5.0, -0.5, (n, 3)).astype(np.float32)
    arrays["alive"] = rng.random(n) > 0.1
    f = np.float32
    lim_x = f(1.3) * ((f(1) / f(PROJ_F)) * f(0.5 * PROJ_W))
    lim_y = f(1.3) * ((f(1) / f(PROJ_F)) * f(0.5 * PROJ_H))
    # OpenGL c2w = I: view space is (x, -y, -z) of the world
    arrays["means"][0] = (2 * lim_x, 0.0, -2.0)
    arrays["means"][1] = (0.3, 2 * lim_y, -2.0)
    arrays["scales"][:2] = np.log([0.5, 0.3, 0.2])
    arrays["alive"][:3] = True
    c0 = f(0.28209479177387814)
    arrays["features_dc"][2, 0] = f(-0.5) / c0
    while c0 * arrays["features_dc"][2, 0] != f(-0.5):
        arrays["features_dc"][2, 0] = np.nextafter(arrays["features_dc"][2, 0],
                                                   f(0))
    arrays["features_rest"][2, :, 0] = 0.0
    arrays["means"][2] = (0.1, 0.1, -4.0)
    scene = scene_from_numpy(arrays, cuda)
    camera = Camera.create(PROJ_F, PROJ_F, PROJ_W / 2, PROJ_H / 2,
                           np.eye(4)[:3], device=cuda)
    return scene, camera


def _projection_runs(scene, camera, degree, config, crop_box=None,
                     weighted=None):
    """splat_inputs (the kernels), splat_inputs_plain and the plain path in
    f64 (same matrices, lanes and cotangents), each with the gradients of
    one random weighting of its float outputs (those named in ``weighted``,
    else all) w.r.t. the scene's parameters; the kernels' launch counts."""
    from gstk_torch.core.cameras import camera_matrices
    from gstk_torch.core.gaussians import GaussianScene
    from gstk_torch.models import vanilla
    from gstk_torch.ops import project_cuda

    viewmat, fullmat = camera_matrices(camera, PROJ_H, PROJ_W)
    alive = scene.alive
    if crop_box is not None:
        alive = alive & crop_box.within(scene.means.detach())
    exact = GaussianScene(**{k: getattr(scene, k).detach().double()
                             for k in project_cuda.PARAM_NAMES}, alive=alive)
    cam64 = Camera(*(getattr(camera, k).double()
                     for k in ("fx", "fy", "cx", "cy", "c2w")))
    g = torch.Generator(device=scene.means.device).manual_seed(degree + 7)
    weights = None
    outs, grads, launches = [], [], None
    for run in ("kernels", "plain", "f64"):
        before = (project_cuda.project_fwd.launches,
                  project_cuda.project_bwd.launches)
        if run == "kernels":
            out = vanilla.splat_inputs(scene, camera, PROJ_H, PROJ_W,
                                       sh_degree=degree, config=config,
                                       crop_box=crop_box)
            launches = (project_cuda.project_fwd.launches - before[0],)
        elif run == "plain":
            out = vanilla.splat_inputs_plain(
                scene, camera, viewmat, fullmat, alive, PROJ_H, PROJ_W,
                sh_degree=degree, config=config)
        else:
            scene = exact
            out = vanilla.splat_inputs_plain(
                exact, cam64, viewmat.double(), fullmat.double(), alive,
                PROJ_H, PROJ_W, sh_degree=degree, config=config)
        floats = [k for k in project_cuda.OUTPUT_NAMES
                  if out[k].dtype.is_floating_point
                  and k in (weighted or project_cuda.OUTPUT_NAMES)]
        if weights is None:
            weights = {k: torch.randn(out[k].shape, generator=g,
                                      device=out[k].device) for k in floats}
        loss = sum((out[k] * weights[k].to(out[k].dtype)).sum()
                   for k in floats)
        params = [getattr(scene, k) for k in project_cuda.PARAM_NAMES]
        got = torch.autograd.grad(loss, params, allow_unused=True)
        grads.append([torch.zeros_like(p) if x is None else x
                      for p, x in zip(params, got)])
        outs.append({k: v.detach() for k, v in out.items()})
        if run == "kernels":
            launches += (project_cuda.project_bwd.launches - before[1],)
    return outs, grads, launches


PROJ_CASES = [(3, 0, "classic"), (3, 0, "antialiased"), (3, 1, "classic"),
              (3, 1, "antialiased"), (3, 2, "classic"), (3, 2, "antialiased"),
              (3, 3, "classic"), (3, 3, "antialiased"), (4, 4, "antialiased"),
              (0, 0, "sigmoid")]


@pytest.mark.parametrize("case", PROJ_CASES,
                         ids=[f"sh{a}-d{b}-{c}" for a, b, c in PROJ_CASES])
def test_projection_kernels_match_plain(cuda, case):
    """2^16 lanes, dead lanes and a crop box, degrees 0-4 (``sigmoid``: a
    model without SH), classic and antialiased; one forward and one
    backward launch. The float outputs within rtol 1e-5 / atol 1e-6 of the
    plain path's; radii and tile counts equal on all but 0.001% of lanes
    and never more than 1 apart. The six gradients as accurate as autograd
    of the plain path: against the plain path in f64, the kernels' error a
    lane (over the lane's largest gradient) within 1.5x the plain f32
    path's at the median and the 99th percentile of lanes, and within 20x
    at the worst lane. The two f32 paths sum in different orders, and on
    ill-conditioned lanes (a nearly singular 2D covariance) both stray from
    f64 by as much as 1e-2; a wrong term strays by far more, on every lane
    it reaches."""
    from gstk_torch.core.scene_box import OrientedBox
    from gstk_torch.models.vanilla import VanillaConfig
    from gstk_torch.ops import project_cuda

    scene_sh, degree, mode = case
    config = VanillaConfig(
        sh_degree=scene_sh,
        rasterize_mode="classic" if mode == "sigmoid" else mode)
    scene, camera = _projection_case(cuda, sh=max(scene_sh, 3))
    box = OrientedBox.from_params([0.2, 0.1, 0.5], [0.0, 0.0, -5.0],
                                  [9.0, 6.0, 10.0], device=cuda)
    (fused, plain, _), grads, launches = _projection_runs(
        scene, camera, degree, config, crop_box=box)
    assert launches == (1, 1)
    for k in ("xys", "depths", "conics", "colors", "opacities"):
        torch.testing.assert_close(fused[k], plain[k], rtol=1e-5, atol=1e-6,
                                   msg=k)
    n = scene.capacity
    for k in ("radii", "num_tiles_hit"):
        diff = (fused[k] - plain[k]).abs()
        assert int((diff > 0).sum()) <= 1e-5 * n and int(diff.max()) <= 1, k
    visible = plain["radii"] > 0
    assert 0.05 * n < int(visible.sum()) < 0.95 * n
    for name, got, want, exact in zip(project_cuda.PARAM_NAMES, *grads):
        e_got, e_plain = _lane_errors(got, exact), _lane_errors(want, exact)
        for q in (0.5, 0.99):
            assert (float(torch.quantile(e_got, q))
                    <= 1.5 * float(torch.quantile(e_plain, q)) + 1e-7), (name, q)
        assert float(e_got.max()) <= 20 * float(e_plain.max()) + 1e-7, name
        assert float(exact.abs().max()) > 0 or (
            name == "features_rest" and degree == 0), name


def test_projection_kernels_split_the_gradient_at_ties(cuda):
    """The planted ties: lanes 0 and 1 sit on the +-1.3 tan(fov) clamp of
    the plain path on the card, lane 2's red on max(rgb + 0.5, 0), all three
    visible. With the conics weighted (the clamp acts on them alone; the
    pixel centre's and depth's gradients would drown it in the means'),
    the kernels give lanes 0 and 1 the plain path's gradients within 1e-3
    of the lane's largest (lane 0's scale and rotation gradients are small
    beside its mean's, and both f32 paths stray 1e-4 of the lane from f64
    there; a whole share at either clamp moves the means' by 10% or more).
    With the colours weighted, lane 2's DC red gets half of C0 times its
    colour's cotangent."""
    from gstk_torch.models.vanilla import VanillaConfig

    scene, camera = _projection_case(cuda, n=1 << 12)
    config = VanillaConfig(sh_degree=3, rasterize_mode="antialiased")
    (fused, plain, _), (g_fused, g_plain, _), _ = _projection_runs(
        scene, camera, 3, config, weighted=("conics",))
    assert bool((plain["radii"][:3] > 0).all())
    t = scene.means.detach()[:2] * torch.tensor([1.0, -1.0, -1.0], device=cuda)
    tan = 0.5 * PROJ_W / camera.fx, 0.5 * PROJ_H / camera.fy
    assert float(t[0, 0] * (1.0 / t[0, 2])) == float(1.3 * tan[0])
    assert float(t[1, 1] * (1.0 / t[1, 2])) == float(-1.3 * tan[1])
    for got, want in zip(g_fused, g_plain):
        _close_lanes(got[:2], want[:2], 0.0, 1e-3)
    (fused, _, _), (g_fused, _, _), _ = _projection_runs(
        scene, camera, 3, config, weighted=("colors",))
    assert float(fused["colors"][2, 0]) == 0.0
    g = torch.Generator(device=cuda).manual_seed(3 + 7)  # _projection_runs'
    w_col = torch.randn(fused["colors"].shape, generator=g, device=cuda)
    want = 0.5 * np.float32(0.28209479177387814) * float(w_col[2, 0])
    assert float(g_fused[3][2, 0]) == pytest.approx(want, rel=1e-6)


def _camera_grad_error(got, want, exact):
    """|got - exact| against |want - exact| (the plain f32 path's), both
    over |exact|: norms over the matrix's entries."""
    norm = lambda x: float(x.double().norm())
    return (norm(got.double() - exact) / norm(exact),
            norm(want.double() - exact) / norm(exact))


def test_camera_gradient_runs_the_kernels(cuda):
    """Camera optimisation projects through the kernels. With viewmat and
    fullmat given as leaves, PB's gradient of each entry the projection
    reads is as accurate as autograd of the plain path: against the plain
    path in f64, the kernels' error (norm over the entries, over the f64
    gradient's norm) within 4x the plain f32 path's plus 1e-5; both f32
    paths sum 2^16 lanes' terms, in different orders, and a wrong or
    missing term moves the sum by far more. A second backward gives the
    same bits (a fixed order of sums). With the camera's c2w requiring
    grad, splat_inputs launches PF once and PB once, and c2w's gradient
    meets the same bound against the f64 gradients of the matrices carried
    back through camera_matrices."""
    from gstk_torch.core.cameras import camera_matrices
    from gstk_torch.core.gaussians import GaussianScene
    from gstk_torch.models import vanilla
    from gstk_torch.ops import project_cuda

    scene, camera = _projection_case(cuda, n=1 << 16)
    config = vanilla.VanillaConfig(sh_degree=3, rasterize_mode="antialiased")
    exact = GaussianScene(**{k: getattr(scene, k).detach().double()
                             for k in project_cuda.PARAM_NAMES},
                          alive=scene.alive)
    g = torch.Generator(device=cuda).manual_seed(11)
    floats = ("xys", "depths", "conics", "colors", "opacities")
    weights = {}

    def loss_of(out):
        for k in floats:
            if k not in weights:
                weights[k] = torch.randn(out[k].shape, generator=g,
                                         device=cuda)
        return sum((out[k] * weights[k].to(out[k].dtype)).sum()
                   for k in floats)

    viewmat, fullmat = camera_matrices(camera, PROJ_H, PROJ_W)
    setting = project_cuda.Setting(PROJ_H, PROJ_W, 16, 3, False, True)
    cam64 = Camera(*(getattr(camera, k).double()
                     for k in ("fx", "fy", "cx", "cy", "c2w")))
    leaves = []
    for run in ("kernels", "kernels_again", "plain", "f64"):
        dtype = torch.float64 if run == "f64" else torch.float32
        vm, fm = (m.detach().to(dtype).requires_grad_()
                  for m in (viewmat, fullmat))
        if run.startswith("kernels"):
            out = project_cuda.project_splats(
                scene, scene.alive, project_cuda.view_params(camera, vm, fm),
                setting)
        else:
            out = vanilla.splat_inputs_plain(
                exact if run == "f64" else scene,
                cam64 if run == "f64" else camera, vm, fm, scene.alive,
                PROJ_H, PROJ_W, sh_degree=3, config=config)
        leaves.append(torch.autograd.grad(loss_of(out), (vm, fm)))
    (k_vm, k_fm), (k2_vm, k2_fm), (p_vm, p_fm), (x_vm, x_fm) = leaves
    assert torch.equal(k_vm, k2_vm) and torch.equal(k_fm, k2_fm)
    assert float(k_vm[3].abs().max()) == 0.0 == float(k_fm[2].abs().max())
    for name, got, want, ref in (("viewmat", k_vm[:3], p_vm[:3], x_vm[:3]),
                                 ("fullmat", k_fm, p_fm, x_fm)):
        err, err_plain = _camera_grad_error(got, want, ref)
        assert err <= 4 * err_plain + 1e-5, (name, err, err_plain)

    grads = []
    for run in ("kernels", "plain"):
        c2w = camera.c2w.detach().clone().requires_grad_()
        cam = Camera(camera.fx, camera.fy, camera.cx, camera.cy, c2w)
        before = (project_cuda.project_fwd.launches,
                  project_cuda.project_bwd.launches)
        out = vanilla.splat_inputs(
            scene, cam, PROJ_H, PROJ_W, sh_degree=3, config=config,
            backend="auto" if run == "kernels" else "plain")
        (g_c2w,) = torch.autograd.grad(loss_of(out), c2w)
        grads.append(g_c2w)
        after = (project_cuda.project_fwd.launches,
                 project_cuda.project_bwd.launches)
        assert tuple(b - a for a, b in zip(before, after)) == (
            (1, 1) if run == "kernels" else (0, 0)), run
    (ref,) = torch.autograd.grad(camera_matrices(cam, PROJ_H, PROJ_W), c2w,
                                 (x_vm.float(), x_fm.float()))
    err, err_plain = _camera_grad_error(*grads, ref.double())
    assert err <= 4 * err_plain + 1e-5, ("c2w", err, err_plain)


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


def test_raytraced_view_on_the_card_matches_cpu(cuda, tmp_path):
    """Two raytraced views at 128x128, supersample 3, generated on the card
    and on the CPU: RGBA equal in >= 99.9% of pixels, alpha equal, depth
    equal in >= 99.9% and within 1 mm elsewhere, seed clouds within 1e-9."""
    from gstk_torch.data.raytraced import generate_raytraced_dataset
    from gstk_torch.utils.io import read_ply, read_png

    dirs = {d: generate_raytraced_dataset(tmp_path / str(d), n_views=2,
                                          img_wh=(128, 128), seed_points=500,
                                          supersample=3, device=d)
            for d in (cuda, "cpu")}
    gpu, cpu = dirs[cuda], dirs["cpu"]
    n_px = n_rgba = n_depth = 0
    for i in range(2):
        a = read_png(cpu / "images" / f"frame_{i:05d}.png")
        b = read_png(gpu / "images" / f"frame_{i:05d}.png")
        np.testing.assert_array_equal(b[..., 3], a[..., 3])
        da = read_png(cpu / "depths" / f"depth_{i:05d}.png").astype(np.int64)
        db = read_png(gpu / "depths" / f"depth_{i:05d}.png").astype(np.int64)
        assert np.abs(db - da).max() <= 1
        n_px += 128 * 128
        n_rgba += int((a == b).all(-1).sum())
        n_depth += int((da == db).sum())
    assert n_rgba >= 0.999 * n_px and n_depth >= 0.999 * n_px
    pa, pb = read_ply(cpu / "sparse.ply")["vertex"], read_ply(gpu / "sparse.ply")["vertex"]
    assert len(pa) == len(pb) == 500
    for k in "xyz":
        np.testing.assert_allclose(pb[k], pa[k], rtol=0, atol=1e-9)


def _viewer_pair(cuda):
    """(a TrainingViewer through the kernels, one through the plain twins),
    both on the card, given one scene in front of the orbit camera."""
    from gstk_torch.models.vanilla import VanillaConfig
    from gstk_torch.ops.rasterize import RasterizeConfig
    from gstk_torch.viewer.http_viewer import TrainingViewer

    scene = scene_from_numpy(_scene(np.random.default_rng(5), n=20000), cuda)
    viewers = []
    for backend in ("auto", "plain"):
        v = TrainingViewer(VanillaConfig(sh_degree=1),
                           RasterizeConfig(forward_only=True, backend=backend,
                                           isect_capacity=1 << 20),
                           host="127.0.0.1", port=0, device=cuda)
        v.update_scene(scene)
        viewers.append(v)
    return viewers


def test_training_viewer_frame_matches_plain_twins(cuda):
    """A 640x480 frame, rgb and depth, through K1 and K3 against the plain
    twins: uint8 within 1 level on all but 0.1% of pixels; one K1 and one
    K3 launch a frame."""
    from gstk_torch.viewer.http_viewer import DEFAULT_SETTINGS, orbit_pose

    kernel, plain = _viewer_pair(cuda)
    try:
        c2w = orbit_pose(0.1, 0.05, 5.0, (0.0, 0.0, -5.0))
        for output in ("rgb", "depth"):
            settings = {**DEFAULT_SETTINGS, "output": output}
            before = (composite_tiles_fwd.launches, segment_broadcast.launches)
            got = kernel.render(c2w, 480, 640, settings)
            assert (composite_tiles_fwd.launches - before[0],
                    segment_broadcast.launches - before[1]) == (1, 1)
            want = plain.render(c2w, 480, 640, settings)
            diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
            assert (diff > 1).mean() <= 1e-3, (output, int((diff > 1).sum()))
            assert len(np.unique(got)) > 16
    finally:
        kernel.stop()
        plain.stop()


def test_launch_counters_under_two_threads(cuda):
    """Two threads render 16 frames each through the kernels at once: K1
    and K3 count 32 launches each, none lost."""
    import threading

    from gstk_torch.viewer.http_viewer import DEFAULT_SETTINGS, orbit_pose

    kernel, plain = _viewer_pair(cuda)
    plain.stop()
    frames, errors = [], []

    def work(k):
        try:
            for i in range(16):
                c2w = orbit_pose(0.05 * i + k, 0.05, 5.0, (0.0, 0.0, -5.0))
                frames.append(kernel.render(c2w, 240, 320, DEFAULT_SETTINGS))
        except Exception as exc:  # reported by the test thread below
            errors.append(repr(exc))

    try:
        kernel.render(orbit_pose(0.0, 0.05, 5.0, (0.0, 0.0, -5.0)), 240, 320,
                      DEFAULT_SETTINGS)  # builds the kernels first
        torch.cuda.synchronize()
        before = (composite_tiles_fwd.launches, segment_broadcast.launches)
        threads = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert (composite_tiles_fwd.launches - before[0],
                segment_broadcast.launches - before[1]) == (32, 32)
        assert len(frames) == 32 and all(f.max() > 0 for f in frames)
    finally:
        kernel.stop()


def _torch_ranks():
    """``tests/_torch_ranks.py``, loaded by its path: where ``tests`` names an
    installed package, ``import tests._torch_ranks`` finds that one."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).with_name("_torch_ranks.py")
    spec = importlib.util.spec_from_file_location("_torch_ranks", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sharded_and_dp_steps_on_the_card(cuda, tmp_path):
    """Two gloo ranks on the one card (NCCL takes one rank a card): two
    Gaussian-sharded steps equal the replicated steps on the card bit for
    bit, after a data-parallel step (rank r: camera r) both ranks hold
    the same state, and two sharded co-gs steps with SO3xR3 camera
    optimisation match the replicated ones as on the CPU
    (``assert_cam_opt_matches``)."""
    np.savez(tmp_path / "in.npz", case="card")
    ranks = _torch_ranks()
    outs = ranks.spawn("card", 2, tmp_path)
    for o in outs:
        keys = [k for k in o if k.startswith("step_ref.")]
        for k in keys:
            np.testing.assert_array_equal(o["step." + k[9:]], o[k], err_msg=k)
        ranks.assert_cam_opt_matches(o)
    for k in outs[0]:
        if k.startswith("dp."):
            np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


def test_nccl_world_one_dp_step_is_the_step(cuda):
    """A data-parallel step over a one-rank NCCL group equals the plain step
    bit for bit: an all-reduce over one rank, and a mean over one, are the
    identity."""
    import socket

    import torch.distributed as dist

    from gstk_torch.core.gaussians import scene_from_numpy as from_numpy
    from gstk_torch.parallel.mesh import get_mesh, initialize_distributed
    from gstk_torch.train.checkpoint import train_state_to_numpy
    from gstk_torch.train.step import init_train_state

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        arrays, gt, cams, make = _torch_ranks().card_case(cuda)
        want, m_want = make()(init_train_state(from_numpy(arrays, cuda)),
                              cams[0], gt)
        got, m_got = make(axis_name="data", mesh=get_mesh())(
            init_train_state(from_numpy(arrays, cuda)), cams[0], gt)
        for k, v in train_state_to_numpy(want).items():
            np.testing.assert_array_equal(train_state_to_numpy(got)[k], v,
                                          err_msg=k)
        assert all(torch.equal(m_got[k], m_want[k]) for k in m_want)
    finally:
        dist.destroy_process_group()


def test_cogs_spans_hold_their_events(cuda):
    """A co-gs step with the planar prior and SO3xR3 camera optimisation,
    traced: every device event launched inside the planar fit's
    ``linalg_eigh`` is charged to ``gstk.depth_terms``, and every one
    launched by the camera group's Adam step or by the adjustment's exp
    map to ``gstk.camera`` (as the benchmark's layer metrics charge them);
    the planar-fit counter moves by the ``linalg_eigh`` calls traced and
    PB's view-gradient counter by the ``view_grad_sum_kernel`` launches."""
    from gstk_torch.core import camera_opt
    from gstk_torch.core.camera_opt import CameraOptConfig
    from gstk_torch.models.depth import DepthConfig
    from gstk_torch.ops import project_cuda
    from gstk_torch.ops.rasterize import RasterizeConfig
    from gstk_torch.train import step as tstep
    from gstk_torch.train.optim import OptimizerConfig
    from gstk_torch.utils import losses

    from gsbench import program
    from gsbench import trace as gtrace

    scene, camera = _projection_case(cuda, n=1 << 14)
    model = DepthConfig(sh_degree=3, using_planar_loss=True)
    fn = tstep.make_train_step(
        model, RasterizeConfig(isect_capacity=1 << 20), OptimizerConfig(),
        PROJ_H, PROJ_W, 3, camera_opt=CameraOptConfig(mode="SO3xR3"))
    state = tstep.init_train_state(scene, num_cameras=2)
    state.step.fill_(12_000)
    gen = torch.Generator(device=cuda).manual_seed(5)
    gt = torch.rand(PROJ_H, PROJ_W, 3, generator=gen, device=cuda)
    depth = 1.0 + torch.rand(PROJ_H, PROJ_W, generator=gen, device=cuda)
    index = torch.ones((), dtype=torch.int32, device=cuda)

    def step():
        fn(state, camera, gt, gen, depth=depth, camera_index=index)

    def marked(name, real):
        def call(*args, **kwargs):
            if name == "exp_map" or "camera_opt" in args[0]:
                with torch.profiler.record_function("gsbench." + name):
                    return real(*args, **kwargs)
            return real(*args, **kwargs)
        return call

    step()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tstep, "adam_step", marked("camera_adam", tstep.adam_step))
        m.setattr(tstep, "apply_to_camera",
                  marked("exp_map", camera_opt.apply_to_camera))
        fits, views = losses.local_planar_loss.fits, project_cuda.project_bwd.view_grad_launches
        tr = gtrace.record(lambda: [step() for _ in range(2)], cuda)
        fits = losses.local_planar_loss.fits - fits
        views = project_cuda.project_bwd.view_grad_launches - views
    assert gtrace.check(tr, True) == []
    spans = program.of(tr)
    for name in ("camera_adam", "exp_map"):
        evs = tr.events_in(name)
        assert evs and {spans.layer_of(e) for e in evs} == {"camera"}, name
    eighs = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in tr.cpu_ops if e["name"] == "aten::linalg_eigh"]
    inside = [e for e in tr.matched if any(
        s <= float(tr.calls[e["args"]["correlation"]]["ts"]) <= t for s, t in eighs)]
    assert inside and {spans.layer_of(e) for e in inside} == {"depth_terms"}
    assert fits == len(eighs) == 2
    summed = [e for e in tr.device if e.get("cat") == "kernel"
              and "view_grad_sum_kernel" in e["name"]]
    assert views == len(summed) == 2


ADAM_SHAPES = {"means": (3,), "scales": (3,), "quats": (4,),
               "features_dc": (3,), "features_rest": (15, 3),
               "opacities": (1,)}  # a lane's rows at SH degree 3


def _adam_case(cuda, lanes, steps, seed=0):
    """An SH-3 scene's groups of ``lanes`` lanes, a tenth dead, with moments
    as after earlier steps, and one gradient a step: NaN on dead lanes
    (zeroed by both paths)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    draw = lambda shape, scale: scale * torch.randn(
        shape, generator=g, device=cuda)
    shapes = {k: (lanes, *s) for k, s in ADAM_SHAPES.items()}
    params = {k: draw(s, 1.0) for k, s in shapes.items()}
    mu = {k: draw(s, 1e-3) for k, s in shapes.items()}
    nu = {k: draw(s, 1e-2).square() for k, s in shapes.items()}
    alive = torch.rand(lanes, generator=g, device=cuda) > 0.1
    grads = []
    for _ in range(steps):
        gs = {k: draw(s, 1e-2) for k, s in shapes.items()}
        for v in gs.values():
            v[~alive] = float("nan")
        grads.append(gs)
    return params, mu, nu, alive, grads


def _adam_twins(params, mu, nu, grads, first_step, count, config,
                mask=None, fused=None):
    """The fused kernel (``fused``, else adam_fused itself) and
    adam_step_plain, each from its own copy of the state, one step a
    gradient from ``first_step``; (params, state) each, and the kernel's
    launches."""
    from gstk_torch.train import adam_cuda, optim

    device = next(iter(params.values())).device
    steps = [torch.tensor(first_step + i, dtype=torch.int32, device=device)
             for i in range(len(grads))]
    runs, launches = [], None
    for fn in (fused or adam_cuda.adam_fused, optim.adam_step_plain):
        p = {k: v.clone() for k, v in params.items()}
        state = optim.AdamState(
            count=torch.tensor(count, dtype=torch.int32, device=device),
            mu={k: v.clone() for k, v in mu.items()},
            nu={k: v.clone() for k, v in nu.items()})
        before = adam_cuda.adam_fused.launches
        for step, gs in zip(steps, grads):
            state = fn(p, gs, state, step, config, mask)
        if launches is None:
            launches = adam_cuda.adam_fused.launches - before
        runs.append((p, state))
    return runs, launches


def _assert_same_bits(runs):
    (p0, s0), (p1, s1) = runs
    assert torch.equal(s0.count, s1.count)
    for k in p1:
        for what, a, b in (("p", p0, p1), ("m", s0.mu, s1.mu),
                           ("v", s0.nu, s1.nu)):
            diff = (a[k] != b[k]) & ~(a[k].isnan() & b[k].isnan())
            assert not diff.any(), (
                f"{k} {what}: {int(diff.sum())} elements differ, the most "
                f"by {float((a[k] - b[k]).abs().max())}")


ADAM_CASES = [(1 << 21, 0, "aligned"), (1 << 21, 12_093, "aligned"),
              (1 << 21, 29_998, "aligned"), (1 << 21, 12_093, "frozen"),
              (1001, 29_998, "unaligned"), (1 << 21, 12_093, "clipped")]


@pytest.mark.parametrize("case", ADAM_CASES,
                         ids=[f"{a}-{b}-{c}" for a, b, c in ADAM_CASES])
def test_fused_adam_equals_plain_bits(cuda, case):
    """Four steps of the fused kernel and of adam_step_plain from the same
    state: p, m, v and the count bit for bit. At 2^21 lanes from step and
    count 0 (the largest bias corrections), 12,093 and 29,998 (across the
    means schedule's end at 30,000); ``frozen``: the means' gradient zero,
    as the train step freezes a group, so they move by their momentum
    alone; ``unaligned``: 1,001 lanes (groups that end inside a 4-element
    unit) with gradients that are views at a 4-byte offset into one buffer,
    which the kernel reads element by element; ``clipped``: a norm clip of
    16 through adam_step, which scales every group but the opacities
    (norm about 14) on the device."""
    from gstk_torch.train.optim import OptimizerConfig, adam_step

    lanes, first, layout = case
    params, mu, nu, alive, grads = _adam_case(cuda, lanes, 4)
    if layout == "frozen":
        for gs in grads:
            gs["means"] = torch.zeros_like(gs["means"])
    if layout == "unaligned":
        for i, gs in enumerate(grads):
            flat = torch.cat([torch.zeros(1, device=cuda)]
                             + [v.reshape(-1) for v in gs.values()])
            parts = torch.split(flat[1:], [v.numel() for v in gs.values()])
            grads[i] = {k: x.view(v.shape)
                        for (k, v), x in zip(gs.items(), parts)}
            assert grads[i]["means"].data_ptr() % 16 != 0
    clipped = layout == "clipped"
    runs, launches = _adam_twins(
        params, mu, nu, grads, first, first,
        OptimizerConfig(max_norm=16.0 if clipped else None), alive,
        adam_step if clipped else None)
    assert launches == 4
    _assert_same_bits(runs)
    p = runs[0][0]
    assert torch.equal(p["means"][~alive], params["means"][~alive])
    if layout == "frozen":
        moved = (p["means"] != params["means"]).any(-1)
        assert moved[alive].float().mean() > 0.99


def test_fused_adam_camera_group_equals_plain_bits(cuda):
    """The camera group as the train step steps it: (num_cameras, 6), no
    mask, the exponential decay of CameraOptConfig's defaults, across its
    end; p, m, v bit for bit over four steps, from count 1 and from 29,998."""
    from gstk_torch.core.camera_opt import CameraOptConfig
    from gstk_torch.train.optim import OptimizerConfig

    cam = CameraOptConfig(mode="SO3xR3")
    cfg = OptimizerConfig(
        lrs=(("camera_opt", cam.lr),),
        extra_exp=(("camera_opt", cam.lr_final, cam.max_steps),))
    g = torch.Generator(device=cuda).manual_seed(3)
    draw = lambda scale: {"camera_opt": scale * torch.randn(
        (37, 6), generator=g, device=cuda)}
    params, mu = draw(1e-2), draw(1e-3)
    nu = {"camera_opt": draw(1e-2)["camera_opt"].square()}
    grads = [draw(1.0) for _ in range(4)]
    for first, count in ((29_998, 1), (29_998, 29_998), (5, 5)):
        runs, launches = _adam_twins(params, mu, nu, grads, first, count, cfg)
        assert launches == 4
        _assert_same_bits(runs)


def test_fused_adam_makes_no_stream_sync(cuda):
    """adam_step's fused path (a scene with its mask, the same with a norm
    clip, then the camera group) under
    ``torch.cuda.set_sync_debug_mode("error")``: no sync. The plain twin,
    which uploads its rates, raises there."""
    from gstk_torch.train import optim

    params, mu, nu, alive, grads = _adam_case(cuda, 1 << 16, 2)
    state = optim.AdamState(
        count=torch.zeros((), dtype=torch.int32, device=cuda), mu=mu, nu=nu)
    cam = {"camera_opt": torch.zeros((4, 6), device=cuda)}
    cam_state = optim.init_adam(cam)
    cam_cfg = optim.OptimizerConfig(lrs=(("camera_opt", 1e-3),),
                                    extra_exp=(("camera_opt", 5e-5, 30_000),))
    step = torch.full((), 12_000, dtype=torch.int32, device=cuda)
    cam_grad = {"camera_opt": torch.ones((4, 6), device=cuda)}
    state = optim.adam_step(params, grads[0], state, step,
                            update_mask=alive)  # builds and loads the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = optim.adam_step(params, grads[1], state, step,
                                update_mask=alive)
        state = optim.adam_step(params, grads[1], state, step,
                                optim.OptimizerConfig(max_norm=1.0),
                                update_mask=alive)
        cam_state = optim.adam_step(cam, cam_grad, cam_state, step, cam_cfg)
        with pytest.raises(RuntimeError, match="synchroniz"):
            optim.adam_step_plain(cam, cam_grad, cam_state, step, cam_cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(state.count) == 3 and int(cam_state.count) == 1


@pytest.mark.parametrize("camera", [False, True])
def test_fused_adam_launches_match_the_trace(cuda, camera):
    """Two traced train steps: ``adam_fused.launches`` moves by the
    ``adam_fused_kernel`` events the trace holds, one an Adam state a step
    (two with camera optimisation), charged to ``gstk.update`` (the camera
    group's to ``gstk.camera``), and no trace event is lost."""
    from gstk_torch.core.camera_opt import CameraOptConfig
    from gstk_torch.models.vanilla import VanillaConfig
    from gstk_torch.ops.rasterize import RasterizeConfig
    from gstk_torch.train import adam_cuda
    from gstk_torch.train import step as tstep
    from gstk_torch.train.optim import OptimizerConfig

    from gsbench import program
    from gsbench import trace as gtrace

    scene, view = _projection_case(cuda, n=1 << 14)
    fn = tstep.make_train_step(
        VanillaConfig(sh_degree=3), RasterizeConfig(isect_capacity=1 << 20),
        OptimizerConfig(), PROJ_H, PROJ_W, 3,
        camera_opt=CameraOptConfig(mode="SO3xR3") if camera else None)
    state = tstep.init_train_state(scene, num_cameras=2 if camera else None)
    state.step.fill_(12_000)
    gen = torch.Generator(device=cuda).manual_seed(5)
    gt = torch.rand(PROJ_H, PROJ_W, 3, generator=gen, device=cuda)
    index = torch.ones((), dtype=torch.int32, device=cuda)
    kw = dict(camera_index=index) if camera else {}

    def step():
        fn(state, view, gt, gen, **kw)

    step()
    before = adam_cuda.adam_fused.launches
    tr = gtrace.record(lambda: [step() for _ in range(2)], cuda)
    made = adam_cuda.adam_fused.launches - before
    assert gtrace.check(tr, True) == []
    evs = [e for e in tr.device if e.get("cat") == "kernel"
           and "adam_fused_kernel" in e["name"]]
    assert made == len(evs) == (4 if camera else 2)
    layers = sorted(program.of(tr).layer_of(e) for e in evs)
    assert layers == (["camera", "camera", "update", "update"] if camera
                      else ["update", "update"])
    assert int(state.adam.count) == 3
