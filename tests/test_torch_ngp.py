"""Instant-NGP's hash-grid field in the port (``models/ngp.py``, the plain
twin of ``csrc/ngp_march.cu``) against the benchmark's independent plain
reference (``bench_port/reference/ngp.py``) on the CPU, at a small grid
that has dense and hashed levels (L = 4, T = 2^10, resolutions 4-32: 4 and
8 dense, 15 and 32 hashed), on seeded weights whose table is U(-1, 1).

Tolerances: the twin and the reference compute the encoding, the SH and
the MLPs with the same float32 operations in the same order, so their
fields and renders are compared to the bit, and their gradients (two
autograd graphs that sum the same terms, the table's scatter-adds in
index order) within 1e-6 of the norm; the finite differences run in
float64, where a central step of 1e-6 is within 1e-6 of the gradient for a
field that is smooth inside a cell.
"""

import dataclasses
import math

import pytest
import torch

from bench_port.reference import ngp as ref
from bench_port.reference.config import RenderConfig as RefRenderConfig
from neuralsim_tpu_torch import config as tcfg
from neuralsim_tpu_torch.config import HashNetConfig, NeRFNetConfig, NeuralSimConfig
from neuralsim_tpu_torch.kernels import raymarch
from neuralsim_tpu_torch.models import ngp
from neuralsim_tpu_torch.models.nerf import init_nerf_pipeline_params, make_sigma_fn
from neuralsim_tpu_torch.ops import render as trender

torch.set_num_threads(2)

SMALL = dict(hash_levels=4, log2_hashmap_size=10, base_resolution=4, finest_resolution=32)
NET = HashNetConfig(**SMALL)
GRID = ref.HashGrid(**SMALL)


def params_of(seed=0, dtype=torch.float32):
    p = ref.bench_params(GRID, 1.0, torch.Generator().manual_seed(seed))
    return {k: v.to(dtype) for k, v in p.items()}


def points(n, seed=1, spread=1.0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = (2.0 * torch.rand(n, 3, generator=g) - 1.0) * spread
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    return x.to(dtype), d.to(dtype)


def rays(n, seed=2):
    """Rays from a 1.01-radius sphere toward the origin, as the pipeline's."""
    g = torch.Generator().manual_seed(seed)
    o = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1) * 1.01
    d = -o / 1.01 + 0.05 * torch.randn(n, 3, generator=g)
    return o, d, d / torch.linalg.norm(d, dim=-1, keepdim=True)


# ------------------------------------------------------------ the layout --

@pytest.mark.parametrize("net, grid, want", [
    (HashNetConfig(), ref.HashGrid(),
     [16, 22, 30, 42, 58, 80, 111, 153, 212, 294, 406, 561, 776, 1072, 1482, 2048]),
    (NET, GRID, [4, 8, 15, 32]),
])
def test_resolutions(net, grid, want):
    assert ngp.resolutions(net) == ref.level_resolutions(grid) == want


def test_published_layout():
    """Levels 0-4 dense, 5-15 hashed at 2^19 rows: 6,098,925 rows, 48.8 MB."""
    layout = ngp.level_layout(HashNetConfig())
    assert [lv.dense for lv in layout] == [True] * 5 + [False] * 11
    assert [lv.size for lv in layout[:6]] == [4913, 12167, 29791, 79507, 205379, 524288]
    assert ngp.table_rows(HashNetConfig()) == ref.rows_of(ref.HashGrid()) == 6_098_925
    assert sum(a * b for a, b in ngp.kernel_shapes(HashNetConfig()).values()) == 9408
    assert [lv.offset for lv in layout] == [lv[1] for lv in ref.levels(ref.HashGrid())]


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_corner_index_against_python_integers(level):
    """Dense: x + y (N+1) + z (N+1)^2. Hashed: the uint32 products wrap for
    every c_y or c_z past 1, held against Python integers mod 2^32."""
    lv = ngp.level_layout(NET)[level]
    g = torch.Generator().manual_seed(level)
    c = torch.randint(0, lv.resolution + 2, (500, 3), generator=g)
    c[:4] = torch.tensor([[0, 0, 0], [1, 2, 3], [lv.resolution + 1] * 3, [0, 2, 0]])
    got = ngp.corner_index(c, lv)
    side = lv.resolution + 1
    for (x, y, z), row in zip(c.tolist(), got.tolist()):
        if lv.dense:
            want = x + y * side + z * side * side
        else:
            want = ((x * 1) ^ (y * 2654435761) ^ (z * 805459861)) % 2 ** 32 % lv.size
            assert y < 2 or y * 2654435761 >= 2 ** 32      # the product wraps
        assert row == want
    assert torch.equal(got, ref._rows(c, lv.resolution, lv.size, lv.dense))


def test_hash_at_published_resolution_wraps():
    lv = ngp.level_layout(HashNetConfig())[-1]
    c = torch.tensor([[2049, 2049, 2049], [7, 1999, 3]])
    want = [((x ^ (y * 2654435761) ^ (z * 805459861)) % 2 ** 32) % 2 ** 19
            for x, y, z in c.tolist()]
    assert ngp.corner_index(c, lv).tolist() == want


# ------------------------------------------------------------- the field --

def test_encoding_sh_and_raw_equal_the_reference():
    p = params_of()
    x, d = points(2000, spread=1.2)
    u, _ = ngp.unit_coords(x, NET)
    assert torch.equal(ngp.hash_encode(p["hash_table"], u, NET),
                       ref.encode(p["hash_table"], u, GRID))
    assert torch.equal(ngp.sh_encode(d), ref.spherical_harmonics(d, 4))
    assert torch.equal(ngp.ngp_apply(p, x, d, NET), ref.field(p, x, d, GRID))


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_is_orthonormal(degree):
    """The real SH up to each degree are orthonormal on the sphere (a
    Monte Carlo mean over 200,000 directions, within its sampling error)."""
    d = torch.nn.functional.normalize(torch.randn(200_000, 3, dtype=torch.float64,
                                                  generator=torch.Generator().manual_seed(0)),
                                      dim=-1)
    y = ngp.sh_encode(d)[:, :degree * degree]
    gram = 4.0 * math.pi * (y.T @ y) / d.shape[0]
    torch.testing.assert_close(gram, torch.eye(degree * degree, dtype=torch.float64),
                               rtol=0, atol=0.03)


def test_outside_the_box_sigma_is_zero():
    p = params_of()
    x, d = points(1000, spread=1.5)
    raw = ngp.ngp_apply(p, x, d, NET)
    inside = (x.abs() <= 1.0).all(dim=-1)
    assert (~inside).any() and inside.any()
    assert torch.all(raw[~inside, 3] == 0.0) and torch.all(raw[inside, 3] > 0.0)
    # the colour outside is the clamped point's
    clamped = ngp.ngp_apply(p, x.clamp(-1.0, 1.0), d, NET)
    assert torch.equal(raw[:, :3], clamped[:, :3])


def test_init_one_field_for_both_passes():
    models = init_nerf_pipeline_params(NET, 128, torch.Generator().manual_seed(0))
    assert models["fine"] is models["coarse"]
    p = models["coarse"]
    assert set(p) == set(ngp.param_keys(NET))
    assert tuple(p["hash_table"].shape) == (ngp.table_rows(NET), 2)
    assert float(p["hash_table"].abs().max()) <= 1e-4
    for key, shape in ngp.kernel_shapes(NET).items():
        assert tuple(p[key].shape) == shape
    assert set(init_nerf_pipeline_params(NET, 0)) == {"coarse"}


def test_config_and_flags():
    assert HashNetConfig().i_embed == 1
    # the widths are the published ones, the reference's, and no setting
    g = ref.HashGrid()
    assert ((ngp.FEATURES, ngp.DENSITY_WIDTH, ngp.DENSITY_OUT, ngp.COLOR_WIDTH,
             ngp.COLOR_DEPTH, ngp.SH_DEGREE)
            == (g.hash_features, g.density_width, g.density_out, g.color_width,
                g.color_depth, g.sh_degree) == (2, 64, 16, 64, 2, 4))
    assert tcfg.hash_net(NeRFNetConfig(), hash_levels=8) == HashNetConfig(hash_levels=8)
    cfg = tcfg.config_from_flags({"i_embed": 1, "hash_levels": 8, "log2_hashmap_size": 17})
    assert cfg.net == HashNetConfig(hash_levels=8, log2_hashmap_size=17)
    with pytest.raises(KeyError, match="i_embed 1"):
        tcfg.config_from_flags({"hash_levels": 8})
    with pytest.raises(KeyError, match="unknown flag"):
        tcfg.config_from_flags({"i_embed": 1, "sh_degree": 3})
    assert type(tcfg.config_from_flags({"netwidth": 128}).net) is NeRFNetConfig


# ----------------------------------------------------------- the render --

def test_render_rays_equals_the_reference():
    p = params_of()
    o, d, vd = rays(300)
    rc = tcfg.RenderConfig(n_samples=16, n_importance=24).test_mode()
    got = trender.render_rays({"coarse": p, "fine": p}, o, d, vd, NET, rc)
    want = ref.render_rays(p, o, d, vd, GRID, RefRenderConfig(n_samples=16, n_importance=24,
                                                               perturb=False))
    for key in ("rgb_map", "disp_map", "acc_map", "depth_map", "rgb0"):
        assert torch.equal(got[key], want[key]), key


def test_renderer_images_equal_the_reference():
    from bench_port.reference.config import CameraConfig as RefCamera
    from bench_port.reference.poses import poses_from_noise, psi_to_probs
    from bench_port.reference.config import SamplerConfig as RefSampler
    from neuralsim_tpu_torch.pipeline import NeuralSimRenderer

    p = params_of()
    cam = tcfg.CameraConfig()
    small = dict(height=12, width=12, fx=cam.fx * 0.12, fy=cam.fy * 0.12, cx=cam.cx * 0.12,
                 cy=cam.cy * 0.12)
    cfg = NeuralSimConfig(net=NET, camera=tcfg.CameraConfig(**small),
                          render=tcfg.RenderConfig(n_samples=8, n_importance=8, ray_chunk=50))
    r = NeuralSimRenderer(cfg, models={"coarse": p, "fine": p}, device="cpu")
    rgb, noise = r.render_images(torch.zeros(8), generator=torch.Generator().manual_seed(4),
                                 num_k=2)
    sc = RefSampler()
    poses = poses_from_noise(psi_to_probs(torch.zeros(8), sc), noise, sc)
    rcam = RefCamera(**small)
    want = ref.render_poses(p, poses, 12, 12, rcam.K, GRID,
                            RefRenderConfig(n_samples=8, n_importance=8, perturb=False), 50)
    assert torch.equal(rgb, want["rgb_map"])


def test_sigma_fn_reads_the_hash_field():
    p = params_of()
    x, d = points(64)
    torch.testing.assert_close(make_sigma_fn(p, NET)(x), ref.field(p, x, d, GRID)[:, 3],
                               rtol=0, atol=0)


# -------------------------------------------------------------- gradients --

def _loss(raw_fn, cot_s, cot_rgb):
    sigma, rgb3 = raw_fn()
    return (sigma * cot_s).sum() + (rgb3 * cot_rgb).sum()


@pytest.mark.parametrize("wrt", ["hash_table", "density_0_kernel", "density_1_kernel",
                                 "color_0_kernel", "color_2_kernel", "rays_o"])
def test_gradients_equal_the_reference_autograd(wrt):
    p = {k: v.requires_grad_(True) for k, v in params_of().items()}
    o, d, vd = rays(40)
    o.requires_grad_(True)
    z = torch.sort(0.31 + 1.62 * torch.rand(40, 12, generator=torch.Generator().manual_seed(5)),
                   dim=-1).values
    g = torch.Generator().manual_seed(6)
    cot_s, cot_rgb = torch.randn(40, 12, generator=g), torch.randn(3, 40, 12, generator=g)
    leaf = o if wrt == "rays_o" else p[wrt]

    def reference():
        pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
        raw = ref.field(p, pts, vd[:, None, :].expand(40, 12, 3).reshape(-1, 3),
                        GRID).reshape(40, 12, 4)
        return raw[..., 3], torch.movedim(raw[..., :3], -1, 0)

    got, = torch.autograd.grad(
        _loss(lambda: raymarch.fused_ngp_march(p, o, d, vd, z, NET), cot_s, cot_rgb), leaf)
    want, = torch.autograd.grad(_loss(reference, cot_s, cot_rgb), leaf)
    assert float(want.norm()) > 0
    assert float((got - want).norm() / want.norm()) <= 1e-6


@pytest.mark.parametrize("wrt, level", [("hash_table", 1), ("hash_table", 3),
                                        ("density_0_kernel", None), ("color_1_kernel", None),
                                        ("rays_o", None)])
def test_gradients_against_float64_finite_differences(wrt, level):
    """The twin's gradient at the entry of largest gradient (of a dense
    level 1 and a hashed level 3 of the table, of a kernel, of the ray
    origins) against a central difference in float64."""
    p = params_of(dtype=torch.float64)
    o, d, vd = (t.double() for t in rays(30))
    z = torch.sort(0.31 + 1.62 * torch.rand(30, 10, generator=torch.Generator().manual_seed(7),
                                            dtype=torch.float64), dim=-1).values
    g = torch.Generator().manual_seed(8)
    cot_s = torch.randn(30, 10, generator=g, dtype=torch.float64)
    cot_rgb = torch.randn(3, 30, 10, generator=g, dtype=torch.float64)
    leaves = dict(p, rays_o=o)

    def loss(values):
        q = {k: values[k] for k in p}
        return _loss(lambda: raymarch.ngp_march_ref(q, values["rays_o"], d, vd, z, NET),
                     cot_s, cot_rgb)

    leaf = leaves[wrt].clone().requires_grad_(True)
    grad, = torch.autograd.grad(loss(dict(leaves, **{wrt: leaf})), leaf)
    mask = torch.ones_like(grad, dtype=torch.bool)
    if level is not None:
        lv = ngp.level_layout(NET)[level]
        assert lv.dense == (level == 1)
        mask[:] = False
        mask[lv.offset:lv.offset + lv.size] = True
    index = tuple(int(i) for i in torch.unravel_index(
        torch.argmax(torch.where(mask, grad.abs(), 0.0)), grad.shape))
    assert float(grad[index]) != 0.0
    eps = 1e-6
    plus, minus = leaves[wrt].clone(), leaves[wrt].clone()
    plus[index] += eps
    minus[index] -= eps
    fd = (loss(dict(leaves, **{wrt: plus})) - loss(dict(leaves, **{wrt: minus}))) / (2 * eps)
    assert abs(float(grad[index]) - float(fd)) <= 1e-6 * abs(float(grad[index]))


# ------------------------------------------------- refusals off the route --

def _small_cfg(**render):
    return NeuralSimConfig(net=NET, render=tcfg.RenderConfig(
        n_samples=4, n_importance=4, **render))


@pytest.mark.parametrize("render, words", [
    (dict(fuse_compositing=True), "fuse_compositing"),
    (dict(fuse_pointgen=False), "fuse_pointgen"),
])
def test_kernel_routes_that_take_no_hash_field_raise(render, words, monkeypatch):
    """On the card (uses_kernel true) every route but the hash march raises,
    naming itself, before any launch."""
    monkeypatch.setattr(raymarch, "uses_kernel", lambda t: True)
    p = params_of()
    o, d, _ = rays(8)
    rc = _small_cfg(**render).render.test_mode()
    with pytest.raises(NotImplementedError, match=words):
        trender.render_ray_batch({"coarse": p, "fine": p}, o, d, NET, rc)


def test_culled_route_raises_on_the_card(monkeypatch):
    monkeypatch.setattr(raymarch, "uses_kernel", lambda t: True)
    p = params_of()
    o, d, _ = rays(8)
    rc = _small_cfg().render.production_mode()
    with pytest.raises(NotImplementedError, match="production"):
        trender.render_ray_batch({"coarse": p, "fine": p}, o, d, NET, rc, grid=object())


def test_point_major_kernels_refuse_a_hash_field(monkeypatch):
    from neuralsim_tpu_torch.models.nerf import query_points

    monkeypatch.setattr(raymarch, "uses_kernel", lambda t: True)
    x, d = points(8)
    with pytest.raises(NotImplementedError, match="point-major"):
        query_points(params_of(), x[:, None, :], d, NET, use_pallas=True)


def test_kernel_route_takes_the_hash_march(monkeypatch):
    """On the card the march goes to fused_ngp_march: two launches a chunk
    (the launch replaced here by the twin)."""
    monkeypatch.setattr(raymarch, "uses_kernel", lambda t: True)
    launched = []

    def launch(params, o, d, v, z, net):
        launched.append(tuple(z.shape))
        return raymarch.ngp_march_ref(params, o, d, v, z, net)

    monkeypatch.setattr(raymarch, "_launch_ngp", launch)
    p = params_of()
    o, d, _ = rays(30)
    rc = dataclasses.replace(_small_cfg().render, ray_chunk=16).test_mode()
    with torch.no_grad():
        out = trender.render_ray_batch({"coarse": p, "fine": p}, o, d, NET, rc)
    assert launched == [(16, 4), (16, 8), (14, 4), (14, 8)]
    monkeypatch.setattr(raymarch, "uses_kernel", lambda t: t.is_cuda)
    plain = trender.render_ray_batch({"coarse": p, "fine": p}, o, d, NET, rc)
    assert torch.equal(out["rgb_map"], plain["rgb_map"])


@pytest.mark.parametrize("where", ["renderer", "driver_grad", "driver_render", "kernel",
                                   "query_points"])
def test_non_float32_dtypes_raise(where):
    from neuralsim_tpu_torch.bilevel.driver import BilevelDriver
    from neuralsim_tpu_torch.models.nerf import query_points
    from neuralsim_tpu_torch.pipeline import NeuralSimRenderer

    p = params_of()
    models = {"coarse": p, "fine": p}
    cfg = _small_cfg()
    f32 = dataclasses.replace(cfg, bilevel=dataclasses.replace(cfg.bilevel,
                                                               grad_compute_dtype="float32"))
    bf16_render = dataclasses.replace(f32, render=dataclasses.replace(
        cfg.render, compute_dtype="bfloat16"))
    with pytest.raises(ValueError, match="float32 only"):
        if where == "renderer":
            NeuralSimRenderer(bf16_render, models=models, device="cpu")
        elif where == "driver_grad":
            BilevelDriver(cfg, models, None, device="cpu")      # grad_compute_dtype bf16
        elif where == "driver_render":
            BilevelDriver(bf16_render, models, None, device="cpu")
        elif where == "kernel":
            o, d, vd = rays(4)
            raymarch.fused_ngp_march(p, o, d, vd, torch.rand(4, 3), NET, torch.bfloat16)
        else:
            x, d = points(4)
            query_points(p, x[:, None, :], d, NET, torch.bfloat16)


def test_fused_ngp_march_refuses_a_nerf_mlp():
    with pytest.raises(ValueError, match="hash-grid field"):
        raymarch.fused_ngp_march({}, *rays(2), torch.rand(2, 3), NeRFNetConfig())
