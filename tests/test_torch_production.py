"""Port parity for the production render routes on the CPU: the
occupancy-culled render (both scorers, z tightening, the single-pass and
hierarchical fine counts), coarse-raw reuse and the sparse fine pass,
against ``neuralsim_tpu`` on the same numpy weights, rays and grid
(``NeuralSimRenderer`` with ``production_mode()``:
``tests/test_torch_production_renderer.py``).

Every culled case holds an effective budget below 1 and a render that
differs from the exact one, so no case compares exact with exact: either
the budget is short of the rays that hit the grid (the top-k tie order then
decides which hit rays are rendered) or the routed rays sample a tightened
interval.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bench import box_scene_params as jax_box_scene
from neuralsim_tpu import config as jcfg
from neuralsim_tpu.models.nerf import init_nerf_pipeline_params, make_sigma_fn
from neuralsim_tpu.ops import occupancy as jocc
from neuralsim_tpu.ops.rays import get_rays as jax_get_rays
from neuralsim_tpu.ops.render import render_ray_batch as jax_render_ray_batch
from neuralsim_tpu.sampler.poses import pose_spherical as jax_pose_spherical
from neuralsim_tpu_torch import config as tcfg
from neuralsim_tpu_torch.models.convert import params_from_numpy
from neuralsim_tpu_torch.models.nerf import make_sigma_fn as torch_sigma_fn
from neuralsim_tpu_torch.ops import occupancy as tocc
from neuralsim_tpu_torch.ops import render as trender
from neuralsim_tpu_torch.ops.volume import stratified_z_vals
from tests.test_torch_render import _tol
from tests.test_torch_render_tile import kernel_route  # noqa: F401  (a fixture)

torch.set_num_threads(2)

SMALL = dict(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32, skips=(2,))
JNET, TNET = jcfg.NeRFNetConfig(**SMALL), tcfg.NeRFNetConfig(**SMALL)
RENDER = dict(n_samples=16, n_importance=16, ray_chunk=128)
# a 24x24 camera 1.01 from the box scene (half 0.06): 32% of the rays hit
# the occupied box, 20% an occupied voxel
H = W = 24
K = np.array([[60.0, 0, 12.0], [0, 60.0, 12.0], [0, 0, 1.0]], np.float32)
CAMERA = dict(height=H, width=W, focal=60.0, fx=60.0, fy=60.0, cx=12.0, cy=12.0)
# tolerances: tests/test_torch_render.py:_tol, 1e-4 on the box scene in
# float32 and bf16 (both sides round at the same places), looser on the
# random-init field for the reason given there
ACC_FLOOR = 1e-3     # disparity is compared where both rays are lit or both empty


def _rcs(**render):
    render = {**RENDER, **render}
    return (jcfg.RenderConfig(**render).test_mode(), tcfg.RenderConfig(**render).test_mode())


@pytest.fixture(scope="module")
def scene():
    """Box-scene weights, one pose's rays, and the JAX grid (build_scene_grid
    at resolution 48) with the port's grid equal to it."""
    params = {k: np.array(v) for k, v in jax_box_scene(JNET, jax.random.PRNGKey(0)).items()}
    models = {"coarse": params, "fine": params}
    c2w = np.array(jax_pose_spherical(90.0, -30.0, 1.01))
    ro, rd = (np.array(t).reshape(-1, 3) for t in jax_get_rays(H, W, K, c2w[:3, :4]))
    he = jocc.scene_half_extent(1.01, jcfg.RenderConfig().far, H, W, K)
    grid = jocc.build_scene_grid(make_sigma_fn(params, JNET), he, resolution=48)
    tmodels = params_from_numpy(models, "cpu")
    tgrid = tocc.build_scene_grid(torch_sigma_fn(tmodels["coarse"], TNET), he, resolution=48,
                                  device="cpu")
    for g, w in zip(tgrid, grid):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return dict(models=models, tmodels=tmodels, ro=ro, rd=rd, grid=grid, tgrid=tgrid,
                c2w=c2w)


def _hits(scene, cull_mode):
    """How many of the scene's rays hit the grid under the scorer."""
    ro, rd = torch.from_numpy(scene["ro"]), torch.from_numpy(scene["rd"])
    rc = tcfg.RenderConfig(**RENDER)
    if cull_mode == "aabb":
        return int(tocc.ray_aabb_bounds(scene["tgrid"], ro, rd, rc.near, rc.far)[0].sum())
    z = stratified_z_vals(len(ro), rc.n_samples, rc.near, rc.far, perturb=False)
    return int((tocc.ray_hit_scores(scene["tgrid"], ro, rd, z) > 0).sum())


def _render_both(scene, jrc, trc, grid=True):
    want = jax_render_ray_batch(scene["models"], scene["ro"], scene["rd"], None, JNET, jrc,
                                grid=scene["grid"] if grid else None)
    got = trender.render_ray_batch(scene["tmodels"], torch.from_numpy(scene["ro"]),
                                   torch.from_numpy(scene["rd"]), TNET, trc,
                                   grid=scene["tgrid"] if grid else None)
    return got, want


def _assert_maps_close(got, want, scene_kind="box"):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k.startswith("disp"):
            acc_key = "acc0" if k == "disp0" else "acc_map"
            ga, wa = got[acc_key].numpy(), np.asarray(want[acc_key])
            lit = ((ga >= ACC_FLOOR) & (wa >= ACC_FLOOR)) | ((ga == 0) & (wa == 0))
            assert lit.mean() > 0.9, k
            g, w = g[lit], w[lit]
        np.testing.assert_allclose(g, w, err_msg=k, **_tol(scene_kind, k))


@pytest.fixture(scope="module")
def exact_rgb(scene):
    """The port's exact render of the scene's rays, per dtype."""
    return {dtype: trender.render_ray_batch(
        scene["tmodels"], torch.from_numpy(scene["ro"]), torch.from_numpy(scene["rd"]),
        TNET, _rcs(compute_dtype=dtype)[1])["rgb_map"] for dtype in ("float32", "bfloat16")}


# (cull_mode, tighten_bounds, n_importance_culled, budget): "short" is half
# the measured hit fraction, so hit rays are left out and the tie order
# picks which; "calibrated" covers every hit ray with calibrate_hit_budget
CULLED = [
    ("aabb", False, None, "short"),
    ("grid", False, None, "short"),
    ("aabb", True, 0, "calibrated"),
    ("grid", True, 0, "calibrated"),
    ("aabb", True, 0, "short"),
    ("aabb", True, None, "calibrated"),
    ("grid", True, None, "calibrated"),
    ("aabb", True, 8, "calibrated"),
    ("grid", True, 8, "calibrated"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cull_mode, tighten, n_ic, budget", CULLED,
                         ids=["-".join(map(str, c)) for c in CULLED])
def test_culled_render_matches_jax(scene, exact_rgb, dtype, cull_mode, tighten, n_ic, budget):
    n = len(scene["ro"])
    hits = _hits(scene, cull_mode)
    if budget == "short":
        hit_budget = 0.5 * hits / n
    else:
        _, trc = _rcs(cull_mode=cull_mode)
        hit_budget = tocc.calibrate_hit_budget(scene["tgrid"],
                                               torch.from_numpy(scene["c2w"])[None],
                                               H, W, K, trc)
    k_sel = max(8, min(n, -(-int(round(n * hit_budget)) // 8) * 8))
    assert 0 < hit_budget < 1.0 and 0 < hits < n
    assert (hits <= k_sel) if budget == "calibrated" else (k_sel < hits)
    jrc, trc = _rcs(compute_dtype=dtype, cull_mode=cull_mode, hit_budget=hit_budget,
                    tighten_bounds=tighten, n_samples_culled=8, n_importance_culled=n_ic)
    got, want = _render_both(scene, jrc, trc)

    assert int(got["occ_budget"]) == int(want["occ_budget"]) == k_sel
    assert int(got["occ_hit_count"]) == int(want["occ_hit_count"]) == hits
    assert got["occ_budget"].shape == ()
    # a single pass has no coarse maps, as the JAX scatter keeps only the
    # routed render's keys
    assert ("rgb0" in got) == (not (tighten and n_ic == 0))
    _assert_maps_close({k: v for k, v in got.items() if not k.startswith("occ_")},
                       {k: v for k, v in want.items() if not k.startswith("occ_")})
    assert float((got["rgb_map"] - exact_rgb[dtype]).abs().max()) > 1e-3


def test_culled_unrouted_rays_get_the_empty_outputs(scene):
    """Rays outside the budget carry exactly empty_ray_outputs."""
    _, trc = _rcs(hit_budget=0.5 * _hits(scene, "aabb") / len(scene["ro"]))
    got = trender.render_ray_batch(scene["tmodels"], torch.from_numpy(scene["ro"]),
                                   torch.from_numpy(scene["rd"]), TNET, trc,
                                   grid=scene["tgrid"])
    routed = torch.zeros(len(scene["ro"]), dtype=torch.bool)
    scores = tocc.ray_aabb_bounds(scene["tgrid"], torch.from_numpy(scene["ro"]),
                                  torch.from_numpy(scene["rd"]), trc.near, trc.far)[0]
    routed[trender.top_k_indices(scores.float(), int(got["occ_budget"]))] = True
    empty = tocc.empty_ray_outputs(len(routed), trc)
    for k, v in empty.items():
        torch.testing.assert_close(got[k][~routed], v[~routed], rtol=0, atol=0)
    assert float(got["acc_map"][routed].max()) > 0.5


@pytest.mark.parametrize("n_ic, per_chunk", [(0, 1), (None, 2)], ids=["single", "hierarchical"])
def test_culled_render_launches_one_march_per_routed_chunk(scene, kernel_route, monkeypatch,
                                                           n_ic, per_chunk):
    """Through the kernel route (launches stood in by their twins), the
    march kernel runs once (single pass) or twice (hierarchical) per chunk
    of routed rays, on the routed rays only, and the render equals the
    plain route's."""
    _, trc = _rcs(hit_budget=0.5, tighten_bounds=True, n_importance_culled=n_ic, ray_chunk=64)
    got = trender.render_ray_batch(scene["tmodels"], torch.from_numpy(scene["ro"]),
                                   torch.from_numpy(scene["rd"]), TNET, trc,
                                   grid=scene["tgrid"])
    k_sel = int(got["occ_budget"])
    n_chunks = -(-k_sel // 64)
    assert [name for name, _ in kernel_route] == ["fused_nerf_march"] * (per_chunk * n_chunks)
    assert sum(rays for _, rays in kernel_route) == per_chunk * k_sel
    kernel_route.clear()
    monkeypatch.setattr(trender.raymarch, "uses_kernel", lambda t: False)
    plain = trender.render_ray_batch(scene["tmodels"], torch.from_numpy(scene["ro"]),
                                     torch.from_numpy(scene["rd"]), TNET, trc,
                                     grid=scene["tgrid"])
    assert not kernel_route
    for k in got:
        torch.testing.assert_close(got[k], plain[k], rtol=1e-5, atol=1e-5)


def test_grid_without_budget_is_the_dense_render(scene):
    """A grid with hit_budget 1 renders every ray exactly (no occ_* keys)."""
    got, want = _render_both(scene, *_rcs())
    assert "occ_budget" not in got
    _assert_maps_close(got, want)


# ---------------------------------------------- reuse and the sparse fine pass

def _models(scene_kind):
    if scene_kind == "box":
        p = {k: np.array(v) for k, v in jax_box_scene(JNET, jax.random.PRNGKey(0)).items()}
        return {"coarse": p, "fine": p}
    models = init_nerf_pipeline_params(jax.random.PRNGKey(3), JNET, 16)
    return {name: {k: np.array(v) for k, v in p.items()} for name, p in models.items()}


def _random_rays(rng, n=50):
    ro = (rng.randn(n, 3) * 0.02 + np.array([0, 0, 1.01])).astype(np.float32)
    rd = (rng.randn(n, 3) * 0.05 + np.array([0, 0, -1.0])).astype(np.float32)
    return ro, rd


FINE_ROUTES = [
    (dict(reuse_coarse=True), "box"),
    (dict(reuse_coarse=True), "random"),
    (dict(fine_fraction=0.5), "box"),
    (dict(fine_fraction=0.25, reuse_coarse=True), "box"),
]


@pytest.mark.parametrize("override, scene_kind", FINE_ROUTES,
                         ids=["reuse_coarse-box", "reuse_coarse-random", "fine_fraction-box",
                              "fine_fraction_over_reuse-box"])
def test_fine_routes_match_jax(rng, override, scene_kind):
    """Three full chunks and a ragged tail of 2 rays. The sparse fine pass
    ranks the rays of a tile, so the port pads the tail as the JAX package
    does; fine_fraction < 1 takes precedence over reuse_coarse. On the box
    scene most coarse opacities are exact zeros, so the tie order picks the
    routed rays. The sparse pass is not held on the random-init field: its
    rays' opacities lie within float32 noise of each other there, and an
    ulp in the coarse march swaps which rays a tile routes."""
    models = _models(scene_kind)
    ro, rd = _random_rays(rng)
    jrc, trc = _rcs(ray_chunk=16, **override)
    want = jax_render_ray_batch(models, ro, rd, None, JNET, jrc)
    got = trender.render_ray_batch(params_from_numpy(models, "cpu"), torch.from_numpy(ro),
                                   torch.from_numpy(rd), TNET, trc)
    _assert_maps_close(got, want, scene_kind)
    exact = trender.render_ray_batch(params_from_numpy(models, "cpu"), torch.from_numpy(ro),
                                     torch.from_numpy(rd), TNET, _rcs(ray_chunk=16)[1])
    if scene_kind == "random" or "fine_fraction" in override:
        assert float((got["rgb_map"] - exact["rgb_map"]).abs().max()) > 1e-4
    if scene_kind == "box":
        assert float(np.asarray(want["acc_map"]).max()) > 0.5


def test_sparse_fine_selected_rays_exact_others_coarse(rng):
    """Each ray carries either its exact fine maps (routed) or its coarse
    maps with z_std 0; k_sel of each tile are routed."""
    models = params_from_numpy(_models("random"), "cpu")
    ro, rd = (torch.from_numpy(a) for a in _random_rays(rng, 64))
    _, trc = _rcs(ray_chunk=64)
    full = trender.render_ray_batch(models, ro, rd, TNET, trc)
    sparse = trender.render_ray_batch(models, ro, rd, TNET,
                                      dataclasses.replace(trc, fine_fraction=0.25))
    routed = (sparse["rgb_map"] - full["rgb_map"]).abs().amax(-1) < 1e-6
    coarse = (sparse["rgb_map"] - full["rgb0"]).abs().amax(-1) < 1e-6
    assert (routed | coarse).all() and int(routed.sum()) >= 16
    assert (sparse["z_std"][~routed] == 0).all() and (sparse["z_std"][routed] > 0).all()
    top = trender.top_k_indices(full["acc0"], 16)
    assert routed[top].all()


@pytest.mark.parametrize("override", [dict(reuse_coarse=True), dict(fine_fraction=0.25)],
                         ids=["reuse_coarse", "fine_fraction"])
def test_fine_routes_launch_two_marches_per_chunk(rng, kernel_route, override):
    models = params_from_numpy(_models("box"), "cpu")
    ro, rd = (torch.from_numpy(a) for a in _random_rays(rng, 40))
    _, trc = _rcs(ray_chunk=16, **override)
    got = trender.render_ray_batch(models, ro, rd, TNET, trc)
    names = [name for name, _ in kernel_route]
    assert names == ["fused_nerf_march"] * 6
    rays = [r for _, r in kernel_route]
    if "reuse_coarse" in override:
        assert rays == [16, 16, 16, 16, 8, 8]
    else:   # the fine pass of each tile marches its k_sel rays
        assert rays == [16, 8, 16, 8, 16, 8]
    assert torch.isfinite(got["rgb_map"]).all()


def test_render_poses_keeps_occ_scalars(scene):
    """render_poses reshapes the maps to [P, H, W, ...] and leaves the
    occ_* diagnostics as scalars."""
    _, trc = _rcs(hit_budget=0.5)
    out = trender.render_poses(scene["tmodels"], torch.from_numpy(scene["c2w"])[None], H, W, K,
                               TNET, trc, grid=scene["tgrid"], device="cpu")
    assert out["rgb_map"].shape == (1, H, W, 3)
    assert out["occ_budget"].shape == () and out["occ_hit_count"].shape == ()
