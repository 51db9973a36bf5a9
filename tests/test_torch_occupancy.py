"""Port parity for the occupancy grid (``neuralsim_tpu_torch/ops/occupancy.py``
against ``neuralsim_tpu/ops/occupancy.py``) and for the stable top-k that the
culled render and the sparse fine pass select rays with, on the CPU.

Densities come from an analytic ball and from the small box-density MLP of
``tests/test_occupancy.py`` (exact zeros outside the box), on the same numpy
inputs on both sides. Grids, boxes, bounds and budgets are held equal to
the bit: a probe a float32 ulp across the threshold or a voxel face would
move a ray in or out of the budget.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.models.nerf import make_sigma_fn as jax_sigma_fn
from neuralsim_tpu.ops import occupancy as jocc
from neuralsim_tpu.sampler.poses import pose_spherical as jax_pose_spherical
from neuralsim_tpu_torch import config as tcfg
from neuralsim_tpu_torch.models.convert import params_from_numpy
from neuralsim_tpu_torch.models.nerf import make_sigma_fn
from neuralsim_tpu_torch.ops import occupancy as tocc
from neuralsim_tpu_torch.ops.rays import get_rays
from neuralsim_tpu_torch.ops.render import top_k_indices
from neuralsim_tpu_torch.ops.volume import stratified_z_vals
from neuralsim_tpu_torch.sampler.poses import pose_spherical
from tests.test_occupancy import NET as JNET
from tests.test_occupancy import RC as JRC
from tests.test_occupancy import _box_density_params

torch.set_num_threads(2)

TNET = tcfg.NeRFNetConfig(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32,
                          skips=(0,), multires=4, multires_views=2)
TRC = tcfg.RenderConfig(n_samples=16, n_importance=16, ray_chunk=512, near=0.5, far=2.0,
                        perturb=False)
K = np.array([[40.0, 0, 16.0], [0, 40.0, 16.0], [0, 0, 1.0]], np.float32)


def jax_ball(pts, radius=0.2, density=30.0):
    return density * jax.nn.sigmoid((radius - jnp.linalg.norm(pts, axis=-1)) * 100.0)


def torch_ball(pts, radius=0.2, density=30.0):
    return density * torch.sigmoid((radius - torch.linalg.norm(pts, dim=-1)) * 100.0)


@pytest.fixture(scope="module")
def box_params():
    return {k: np.array(v) for k, v in _box_density_params(jax.random.PRNGKey(0),
                                                           half=0.15).items()}


def _sigma_fns(density, box_params):
    if density == "ball":
        return jax_ball, torch_ball
    return (jax_sigma_fn(box_params, JNET),
            make_sigma_fn(params_from_numpy({"p": box_params}, "cpu")["p"], TNET))


def _assert_grids_equal(got, want):
    for name, g, w in zip(("occ", "bbox_min", "bbox_max"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.fixture(scope="module")
def grids(box_params):
    """(jax grid, port grid) of the ball, resolution 32, dilation 1."""
    kw = dict(bbox_min=(-0.8, -0.8, -0.8), bbox_max=(0.8, 0.8, 0.8), resolution=32,
              dilate=1, chunk=65536)
    want = jocc.build_occupancy_grid(jax_ball, **kw)
    got = tocc.build_occupancy_grid(torch_ball, device="cpu", **kw)
    return want, got


def _as_jax(grid):
    return jocc.OccupancyGrid(*(jnp.asarray(t.numpy()) for t in grid))


@pytest.mark.parametrize("density", ["ball", "box_mlp"])
@pytest.mark.parametrize("dilate", [0, 2])
def test_build_occupancy_grid_matches_jax(box_params, density, dilate):
    jfn, tfn = _sigma_fns(density, box_params)
    kw = dict(bbox_min=(-0.5, -0.45, -0.55), bbox_max=(0.5, 0.55, 0.45), resolution=24,
              dilate=dilate, subsamples=2, chunk=10000)
    want = jocc.build_occupancy_grid(jfn, **kw)
    got = tocc.build_occupancy_grid(tfn, device="cpu", **kw)
    assert got.occ.dtype == torch.float32 and got.occ.device.type == "cpu"
    assert 0.0 < float(got.occ.mean()) < 0.5                      # not vacuous
    _assert_grids_equal(got, want)


def test_dilation_wraps_around_like_jnp_roll():
    """An occupied voxel on a face marks the opposite face after dilation."""
    def corner(pts):
        return (pts[..., 0] < -0.7).to(torch.float32)

    def jcorner(pts):
        return (pts[..., 0] < -0.7).astype(jnp.float32)

    kw = dict(bbox_min=(-0.8,) * 3, bbox_max=(0.8,) * 3, resolution=8, dilate=1)
    got = tocc.build_occupancy_grid(corner, device="cpu", **kw)
    _assert_grids_equal(got, jocc.build_occupancy_grid(jcorner, **kw))
    assert float(got.occ[-1].min()) == 1.0


@pytest.mark.parametrize("center", [(0.0, 0.0, 0.0), (0.5, -0.2, 0.1)],
                         ids=["centred", "off_centre"])
def test_derive_scene_bbox_matches_jax(center):
    """The derived box brackets the object wherever it sits, and is the
    JAX package's to the bit."""
    c = np.array(center, np.float32)

    def jfn(p):
        return jax_ball(p - c, radius=0.1)

    def tfn(p):
        return torch_ball(p - torch.from_numpy(c), radius=0.1)

    want = jocc.derive_scene_bbox(jfn, 0.9, resolution=40)
    got = tocc.derive_scene_bbox(tfn, 0.9, resolution=40, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy() <= c - 0.1).all() and (got[1].numpy() >= c + 0.1).all()
    assert float((got[1] - got[0]).max()) < 0.9


def test_derive_scene_bbox_empty_scene_falls_back():
    got = tocc.derive_scene_bbox(lambda p: torch.zeros(p.shape[:-1]), 0.9, resolution=16,
                                 device="cpu")
    want = jocc.derive_scene_bbox(lambda p: jnp.zeros(p.shape[:-1]), 0.9, resolution=16)
    for g, w, v in zip(got, want, (-0.9, 0.9)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_allclose(g.numpy(), [v] * 3)


def test_build_scene_grid_matches_jax(box_params):
    jfn, tfn = _sigma_fns("box_mlp", box_params)
    he = tocc.scene_half_extent(1.2, 2.0, 32, 32, K)
    want = jocc.build_scene_grid(jfn, he, resolution=32)
    got = tocc.build_scene_grid(tfn, he, resolution=32, device="cpu")
    _assert_grids_equal(got, want)
    assert float(got.occ.mean()) > 0.0


@pytest.mark.parametrize("camera", [None, (32, 32, K), (20, 28, np.array(
    [[15.0, 0, 9.5], [0, 16.0, 11.0], [0, 0, 1.0]], np.float32))], ids=["no_k", "k", "wide"])
def test_scene_half_extent_matches_jax(camera):
    args = () if camera is None else camera
    assert tocc.scene_half_extent(1.01, 1.93, *args) == jocc.scene_half_extent(1.01, 1.93, *args)


@pytest.mark.parametrize("theta, phi", [(0.0, -90.0), (45.0, -30.0), (180.0, -5.0)])
def test_scene_half_extent_covers_frustum_corners(theta, phi):
    """Every far-plane sample of a wide camera (~90 degrees) lies in the
    cube, which is wider than the on-axis bound max(r - near, far - r)."""
    radius, near, far = 1.01, 0.31, 1.93
    he = tocc.scene_half_extent(radius, far)
    assert he > max(radius - near, far - radius)
    wide = np.array([[8.0, 0, 8.0], [0, 8.0, 8.0], [0, 0, 1.0]], np.float32)
    c2w = pose_spherical(torch.tensor([theta]), torch.tensor([phi]), radius)[0]
    ro, rd = get_rays(16, 16, wide, c2w[:3, :4])
    assert float((ro + rd * far).abs().max()) <= he + 1e-5


@pytest.mark.parametrize("case", ["ball", "full"])
def test_grid_lookup_matches_jax(grids, rng, case):
    """Random points inside and outside, and points on the domain's faces
    and on voxel faces: on a full grid bbox_min reads 1, bbox_max 0."""
    grid = grids[1]
    if case == "full":
        grid = tocc.OccupancyGrid(torch.ones_like(grid.occ), grid.bbox_min, grid.bbox_max)
    lo, hi = -0.8, 0.8
    faces = np.array([[lo, 0, 0], [0, lo, lo], [hi, 0, 0], [0, 0, hi], [hi, hi, hi],
                      [lo + 0.05, 0.0, 0.0], [0.05, 0.05, 0.05], [0, 0, 0], [0.2, 0, 0]],
                     np.float32)
    pts = np.concatenate([faces, rng.uniform(-1.0, 1.0, (4000, 3)),
                          rng.randn(500, 3) * 0.25]).astype(np.float32)
    want = np.asarray(jocc.grid_lookup(_as_jax(grid), pts))
    got = tocc.grid_lookup(grid, torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(pts)
    if case == "full":
        np.testing.assert_array_equal(got[:5], [1, 1, 0, 0, 0])


def _rays(rng, n, spread=0.25):
    ro = (rng.randn(n, 3) * 0.05 + [0, 0, 1.2]).astype(np.float32)
    rd = (rng.randn(n, 3) * spread + [0, 0, -1.0]).astype(np.float32)
    return ro, rd


def test_ray_hit_scores_and_z_bounds_match_jax(grids, rng):
    want_grid, grid = grids
    ro, rd = _rays(rng, 512)
    z = np.sort(0.5 + 1.5 * rng.rand(512, 24), -1).astype(np.float32)
    t = [torch.from_numpy(a) for a in (ro, rd, z)]
    scores = tocc.ray_hit_scores(grid, *t)
    np.testing.assert_array_equal(scores.numpy(),
                                  np.asarray(jocc.ray_hit_scores(want_grid, ro, rd, z)))
    assert 0 < int((scores > 0).sum()) < 512
    for margin in (0, 2):
        got = tocc.ray_z_bounds(grid, *t, margin_samples=margin)
        want = jocc.ray_z_bounds(want_grid, ro, rd, z, margin_samples=margin)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["ball", "empty", "one_voxel"])
def test_occupied_aabb_matches_jax(grids, case):
    """An all-empty grid gives a zero-volume box at the domain corner, not
    an inverted one."""
    occ = grids[1].occ.clone()
    if case == "empty":
        occ.zero_()
    elif case == "one_voxel":
        occ.zero_()
        occ[3, 17, 30] = 1.0
    grid = tocc.OccupancyGrid(occ, grids[1].bbox_min, grids[1].bbox_max)
    got = tocc.occupied_aabb(grid)
    want = jocc.occupied_aabb(_as_jax(grid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "empty":
        assert (got[1] - got[0] == 0).all()
        np.testing.assert_array_equal(got[0].numpy(), grid.bbox_min.numpy())
    else:
        assert (got[1] - got[0] > 0).all()


@pytest.mark.parametrize("case", ["ball", "empty"])
@pytest.mark.parametrize("z_margin", [0.0, 0.1875])
def test_ray_aabb_bounds_matches_jax(grids, rng, case, z_margin):
    """Random rays plus rays with zero direction components (the |d| <
    1e-12 -> +-1e-12 substitution, both signs) and rays grazing the box."""
    occ = grids[1].occ if case == "ball" else torch.zeros_like(grids[1].occ)
    grid = tocc.OccupancyGrid(occ, grids[1].bbox_min, grids[1].bbox_max)
    ro, rd = _rays(rng, 400)
    axis = np.array([[0, 0, 1.2, 0, 0, -1], [0, 0, 1.2, 0, -0.0, -1], [0.1, 0.1, 1.2, 0, 0, -1],
                     [0, 0, 1.2, 1e-13, -1e-13, -1], [1.2, 0, 0, -1, 0, 0],
                     [0, 0.26, 1.2, 0, 0, -1]], np.float32)
    ro = np.concatenate([ro, axis[:, :3]])
    rd = np.concatenate([rd, axis[:, 3:]])
    got = tocc.ray_aabb_bounds(grid, torch.from_numpy(ro), torch.from_numpy(rd), 0.5, 2.0,
                               z_margin=z_margin)
    want = jocc.ray_aabb_bounds(_as_jax(grid), ro, rd, 0.5, 2.0, z_margin=z_margin)
    for name, g, w in zip(("hit", "t_near", "t_far"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if case == "empty":
        assert not got[0].any()
    else:
        assert 0 < int(got[0].sum()) < len(ro) and bool(got[0][-6])


def test_aabb_conservative_against_grid_probes(grids, rng):
    """Every ray the voxel prober hits, the slab test hits, and its
    interval holds the prober's (up to the prober's snapping)."""
    grid = grids[1]
    ro, rd = (torch.from_numpy(a) for a in _rays(rng, 512))
    z = stratified_z_vals(512, 64, 0.5, 2.0, perturb=False)
    hit, tn, tf = tocc.ray_aabb_bounds(grid, ro, rd, 0.5, 2.0)
    probed = tocc.ray_hit_scores(grid, ro, rd, z) > 0
    gn, gf = tocc.ray_z_bounds(grid, ro, rd, z)
    assert (hit | ~probed).all() and probed.any()
    step = 1.5 / 64
    assert (tn[probed] <= gn[probed] + 3 * step).all()
    assert (tf[probed] >= gf[probed] - 3 * step).all()


@pytest.mark.parametrize("cull_mode", ["aabb", "grid"])
def test_calibrate_hit_budget_matches_jax(grids, cull_mode):
    """Same grid, same poses: the same budget, below 1, a multiple of the
    quantum, and at least each pose's hit fraction under the mode's scorer."""
    import dataclasses

    want_grid, grid = grids
    wide = np.array([[20.0, 0, 16.0], [0, 20.0, 16.0], [0, 0, 1.0]], np.float32)
    th, ph = np.array([85.0, 90.0, 0.0], np.float32), np.array([-90.0, 30.0, -45.0], np.float32)
    jposes = np.array(jax_pose_spherical(jnp.asarray(th), jnp.asarray(ph), 1.2))
    poses = pose_spherical(torch.from_numpy(th), torch.from_numpy(ph), 1.2)
    np.testing.assert_allclose(poses.numpy(), jposes, atol=1e-6)
    jrc = dataclasses.replace(JRC, cull_mode=cull_mode)
    trc = dataclasses.replace(TRC, cull_mode=cull_mode)
    want = jocc.calibrate_hit_budget(want_grid, jposes, 32, 32, wide, jrc)
    got = tocc.calibrate_hit_budget(grid, torch.from_numpy(jposes), 32, 32, wide, trc)
    assert got == want and 0.0 < got < 1.0
    assert abs(got / 0.05 - round(got / 0.05)) < 1e-9
    for c2w in torch.from_numpy(jposes):
        ro, rd = (t.reshape(-1, 3) for t in get_rays(32, 32, wide, c2w[:3, :4]))
        if cull_mode == "aabb":
            hit = tocc.ray_aabb_bounds(grid, ro, rd, 0.5, 2.0)[0]
        else:
            z = stratified_z_vals(ro.shape[0], 16, 0.5, 2.0, perturb=False)
            hit = tocc.ray_hit_scores(grid, ro, rd, z) > 0
        assert 0.0 < float(hit.float().mean()) <= got


@pytest.mark.parametrize("n_importance", [0, 16])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_empty_ray_outputs_match_jax(n_importance, white_bkgd):
    import dataclasses

    jrc = dataclasses.replace(JRC, n_importance=n_importance, white_bkgd=white_bkgd)
    trc = dataclasses.replace(TRC, n_importance=n_importance, white_bkgd=white_bkgd)
    want = jocc.empty_ray_outputs(5, jrc)
    got = tocc.empty_ray_outputs(5, trc, device="cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_empty_ray_outputs_match_raw2outputs():
    """The analytic empty outputs are what compositing gives a ray with no
    density."""
    from neuralsim_tpu_torch.ops.volume import raw2outputs

    z = stratified_z_vals(4, 16, 0.5, 2.0, perturb=False)
    rays_d = torch.tensor([[0.0, 0.0, -1.0]]).expand(4, 3)
    rgb, disp, acc, _, depth = raw2outputs(torch.full((4, 16, 4), -1e9), z, rays_d)
    out = tocc.empty_ray_outputs(4, TRC, device="cpu")
    for got, want in ((out["rgb_map"], rgb), (out["disp_map"], disp),
                      (out["acc_map"], acc), (out["depth_map"], depth)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_grid_builds_on_the_default_device_or_raises(monkeypatch):
    """build_occupancy_grid / derive_scene_bbox default to cuda; with no
    GPU they raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tocc.build_occupancy_grid(torch_ball, (-1, -1, -1), (1, 1, 1), resolution=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tocc.build_scene_grid(torch_ball, 1.0, resolution=4)


# ------------------------------------------------------------ top-k ties --

@pytest.mark.parametrize("pattern", ["binary", "all_equal", "few_levels", "distinct"])
@pytest.mark.parametrize("k", [8, 40, 64])
def test_top_k_indices_match_jax_top_k_on_ties(rng, pattern, k):
    """jax.lax.top_k puts equal values in ascending index order; the port's
    stable descending sort gives the same indices."""
    n = 64
    scores = {"binary": (rng.rand(n) < 0.3), "all_equal": np.zeros(n),
              "few_levels": rng.randint(0, 4, n), "distinct": rng.permutation(n)}[pattern]
    scores = scores.astype(np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1])
    got = top_k_indices(torch.from_numpy(scores), k).numpy()
    np.testing.assert_array_equal(got, want)
