"""Configuration of the port: a copy of the fields of
``neuralsim_tpu.config`` that the port reads, with the same names and
defaults (NeRF net, render, camera, sampler, detector, data, bilevel outer
loop, standalone NeRF training), and the reference's txt-config and flag
surface (``parse_reference_config``, ``config_from_flags``, ``load_config``,
``parse_cli``)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class NeRFNetConfig:
    """NeRF MLP architecture (reference run_nerf_helpers.py:70-122)."""

    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    skips: Tuple[int, ...] = (4,)
    multires: int = 10          # xyz positional-encoding frequencies -> 63 ch
    multires_views: int = 4     # viewdir encoding frequencies -> 27 ch
    i_embed: int = 0            # 0 = positional encoding, -1 = identity
    use_viewdirs: bool = True

    @property
    def input_ch(self) -> int:
        if self.i_embed == -1:
            return 3
        return 3 + 3 * 2 * self.multires

    @property
    def input_ch_views(self) -> int:
        if not self.use_viewdirs:
            return 0
        if self.i_embed == -1:
            return 3
        return 3 + 3 * 2 * self.multires_views

    @property
    def output_ch(self) -> int:
        return 4


# NeRFNetConfig.i_embed of a multiresolution hash-grid field (HashNetConfig),
# the value HashNeRF-pytorch gives its hash embedder
HASH_EMBED = 1


@dataclass(frozen=True)
class HashNetConfig(NeRFNetConfig):
    """Instant-NGP's NeRF field (Müller et al., SIGGRAPH 2022; NVlabs
    instant-ngp ``configs/nerf/base.json``): a multiresolution hash grid of
    ``hash_levels`` levels and at most 2^``log2_hashmap_size`` entries
    each, resolutions from ``base_resolution`` to ``finest_resolution``
    over the box ``hash_aabb`` (the same bounds on every axis), and the
    bias-free density and colour MLPs, whose widths are fixed at the
    published ones (``models/ngp.py``, which computes the field). The NeRF
    MLP's fields and properties stay and are not read."""

    i_embed: int = HASH_EMBED
    hash_levels: int = 16
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    finest_resolution: int = 2048
    hash_aabb: Tuple[float, float] = (-1.0, 1.0)


def hash_net(net: NeRFNetConfig, **settings) -> HashNetConfig:
    """``net`` as a hash-grid field (i_embed = HASH_EMBED) with
    ``settings`` over HashNetConfig's defaults (or ``net``'s own)."""
    fields = {f.name: getattr(net, f.name) for f in dataclasses.fields(net)}
    fields.update(settings, i_embed=HASH_EMBED)
    return HashNetConfig(**fields)


@dataclass(frozen=True)
class RenderConfig:
    """Volume-rendering options (reference render_rays,
    run_nerf_noscale.py:390-501). The production fields, as in the JAX
    package: ``fine_fraction`` < 1 runs the fine pass on that fraction of
    the rays (highest coarse opacity first); ``hit_budget`` < 1 with an
    occupancy grid renders only that fraction of the rays (top grid scores,
    the rest empty); ``tighten_bounds`` samples each routed ray inside its
    occupied z interval at ``n_samples_culled`` coarse samples, with
    ``n_importance_culled`` fine samples (0: one single-pass march, None:
    ``n_importance``); ``reuse_coarse`` merges the coarse raws into the
    fine composite; ``cull_mode`` scores rays by a slab test against the
    occupied box ("aabb") or by voxel probes ("grid")."""

    n_samples: int = 64
    n_importance: int = 128
    perturb: bool = True
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    lindisp: bool = False
    ndc: bool = False
    ray_chunk: int = 8192       # rays per march call
    compute_dtype: str = "float32"   # or "bfloat16"
    remat: bool = False
    # march through the hand-written kernels on a CUDA tensor; False takes
    # the plain PyTorch path on any device
    use_pallas: bool = True
    # on the card: march + compositing in one kernel (fused_render_tile)
    # when raw_noise_std == 0
    fuse_compositing: bool = False
    # on the card: the ray-march kernel; False: the point-major kernel
    # (fused_nerf_mlp_widepe) on the flattened points
    fuse_pointgen: bool = True
    # plain encoding: sin(y + pi/2) for cos (True) or a true cos (False)
    pe_projection: bool = True
    fine_fraction: float = 1.0
    hit_budget: float = 1.0
    tighten_bounds: bool = False
    n_samples_culled: Optional[int] = 16
    n_importance_culled: Optional[int] = None
    reuse_coarse: bool = False
    cull_mode: str = "aabb"
    near: float = 0.3103964843749999   # pipeline default: info.near - 0.5
    far: float = 1.9297681884765627    # pipeline default: info.far + 0.5

    def test_mode(self) -> "RenderConfig":
        """No jitter, no noise (reference render_kwargs_test)."""
        return dataclasses.replace(self, perturb=False, raw_noise_std=0.0)

    def production_mode(self, n_samples: int = 16,
                        hit_budget_floor: float = 0.25) -> "RenderConfig":
        """The data-generation preset: occupancy cull + per-ray z
        tightening + one single-pass march of ``n_samples`` samples inside
        the tightened interval. ``hit_budget_floor`` is a floor only:
        ``NeuralSimRenderer`` raises the budget to the calibrated hit
        fraction of the scene."""
        return dataclasses.replace(
            self.test_mode(), hit_budget=hit_budget_floor,
            tighten_bounds=True, n_samples_culled=n_samples,
            n_importance_culled=0)


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics (reference load_data_param)."""

    height: int = 100
    width: int = 100
    focal: float = 1333.3333740234375 / 4.0
    fx: float = 1333.3333740234375 / 4.0
    fy: float = 1334.2196044921875 / 4.0
    cx: float = 195.4293212890625 / 4.0
    cy: float = 200.63180541992188 / 4.0

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )


@dataclass(frozen=True)
class SamplerConfig:
    """Gumbel-softmax pose sampler (reference load_LINEMOD_noscale.py:202-328)."""

    n_bins: int = 8
    bin_width_deg: float = 45.0
    bin_offset_deg: float = 22.5
    gumbel_temperature: float = 0.1
    softmax_temperature: float = 0.25
    theta_low_deg: float = 85.0
    theta_high_deg: float = 95.0
    radius: float = 1.01
    n_samples_k: int = 50


@dataclass(frozen=True)
class DetectorConfig:
    """RetinaNet-R50-FPN inner-loop settings (reference neural_sim_main.py:594-622)."""

    num_classes: int = 6
    images_per_batch: int = 8
    base_lr: float = 2.5e-4
    max_iter: int = 50
    warmup_iters: int = 10
    momentum: float = 0.9
    weight_decay: float = 1e-4
    freeze_backbone: bool = True        # FREEZE_AT=6: the whole ResNet frozen
    # RetinaNet head/anchor parameters (detectron2 retinanet_R_50_FPN_3x defaults)
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    smooth_l1_beta: float = 0.1
    iou_fg_threshold: float = 0.5
    iou_bg_threshold: float = 0.4
    score_threshold: float = 0.05
    nms_threshold: float = 0.5
    topk_per_level: int = 1000
    max_detections: int = 100
    image_size: int = 128               # model input side (square pad)
    # pretrained init from a local checkpoint (reference --pretrain /
    # --pretrain_weight, neural_sim_main.py:602-606): every shape-matching
    # tensor is kept, the class-dependent head outputs stay fresh
    pretrain: bool = False
    pretrain_weight: Optional[str] = None
    # the feature that feeds the FPN P6 conv: "c5" (detectron2, the
    # reference) or "p5" (torchvision retinanet_resnet50_fpn); it must match
    # the checkpoint (models.convert_retinanet.detect_p6_source)
    fpn_p6_source: str = "c5"
    # val-set streaming: 0 = the whole val set lives on the device; > 0 =
    # the driver keeps the val images on the host and moves them to the
    # device in chunks of about this many images (evaluate() and the
    # hypergradient's val gradient)
    eval_stream_images: int = 0


@dataclass(frozen=True)
class BilevelConfig:
    """Outer-loop optimizer for psi (reference neural_sim_main.py:1144-1212)."""

    n_epochs: int = 50
    opt_lr: float = 5e-5
    opt_method: str = "momentum"        # sgd | momentum | Adam
    psi_pose_cats_mode: str = "5"       # 1~8 | uniform | two_13 | two_27 | three_123 | three_147
    optimization: bool = True
    # psi parameterization: "categorical" (8-bin logits, the reference's
    # live mode) | "gaussian" ((mean, std) azimuth, completing the
    # reference's sample-only variant, load_LINEMOD_noscale.py:304-328)
    psi_mode: str = "categorical"
    gauss_mean_init: float = 157.5      # degrees; bin-5 center
    gauss_std_init: float = 30.0
    # hypergradient engine: "influence" (the reference's inverse-HVP .
    # mixed-partial approximation, neural_sim_main.py:912-1069) | "unrolled"
    # (differentiate through the inner training)
    hypergrad_mode: str = "influence"
    # inverse-HVP solver: onestep | cg | lissa | cg_normal | neumann | identity
    ihvp_solver: str = "onestep"
    ihvp_damping: float = 1e-2
    cg_iters: int = 10
    lissa_iters: int = 30
    # must exceed ||H + damping I||_2 (PSD H only); <= 0 = auto via power
    # iteration
    lissa_scale: float = 25.0
    # sign applied to the influence-mode grad_E before the psi chain rule:
    # -1.0 is the implicit-function-theorem descent direction, +1.0 the
    # reference's raw convention (PARITY.md)
    influence_sign: float = -1.0
    grad_e_max_images: int = 100        # reference cap (neural_sim_main.py:876)
    # exploration floor on the categorical sampling distribution:
    # (1-eps)*softmax(psi/T) + eps/n_bins; 0.0 = reference parity
    explore_eps: float = 0.0
    # psi render-gradient mode: "strips" (loop over image batches and pixel
    # strips, one reverse-mode render each) | "fwd" (one JVP per psi
    # component) | "rev" (reverse mode with per-tile rematerialization)
    grad_mode: str = "strips"
    # pixels per strip of the strips gradient (one ray tile; its backward
    # keeps the whole strip's activations)
    grad_ray_chunk: int = 5000
    # images per render-gradient call of the fwd / rev modes
    grad_image_batch: int = 4
    # strips mode: images folded into one ray tile of
    # strip_image_batch * grad_ray_chunk rays
    strip_image_batch: int = 1
    # MLP matmul dtype inside the differentiated strip render ("float32" is
    # the oracle for parity tests)
    grad_compute_dtype: str = "bfloat16"
    # occupancy-culled strips gradient: fraction of each image's rays the
    # strips gather-render, selected by the slab test against the occupied
    # box (rays that miss it have zero psi-gradient). 0.0 = dense; < 0 =
    # track the calibrated forward hit_budget; > 0 = that fraction. An
    # image whose hit count overflows the budget renders all its pixels.
    grad_hit_budget: float = -1.0


@dataclass(frozen=True)
class DataConfig:
    basedir: str = "./logs"
    datadir: str = "./logs/nerfdata"
    expname: str = "exp_ycb_synthetic"
    object_id: str = "2"
    dataset_type: str = "LINEMOD"
    half_res: bool = True
    testskip: int = 0
    train_val_path_info: str = "./configs/ycb_synthetic_train_val_path_info.json"
    test_distribution: str = "one_1"
    ft_path: Optional[str] = None
    white_bkgd: bool = False
    render_factor: int = 0
    save_pngs: bool = True


@dataclass(frozen=True)
class TrainConfig:
    """Standalone NeRF training (reference run_nerf_noscale.py:503-791):
    the fields ``train_nerf`` and ``train_cli`` read."""

    n_iters: int = 200000
    n_rand: int = 1024
    lrate: float = 5e-4
    lrate_decay: int = 500              # exponential decay, in 1000s of steps
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    no_batching: bool = True
    i_print: int = 100
    i_weights: int = 10000
    i_testset: int = 50000
    i_video: int = 50000
    render_only: bool = False
    render_test: bool = False


@dataclass(frozen=True)
class ParallelConfig:
    """Layout of the ('data', 'model') mesh (``parallel.make_mesh``): the
    data axis shards rays and images, the model axis optionally splits the
    wide NeRF layers (``parallel.distributed.nerf_param_sharding``)."""

    data_axis: int = -1                 # -1: every rank on the data axis
    model_axis: int = 1


@dataclass(frozen=True)
class NeuralSimConfig:
    net: NeRFNetConfig = field(default_factory=NeRFNetConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    camera: CameraConfig = field(default_factory=CameraConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    data: DataConfig = field(default_factory=DataConfig)
    bilevel: BilevelConfig = field(default_factory=BilevelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    seed: int = 0

    def replace(self, **kw) -> "NeuralSimConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------- #
# Reference txt-config ingestion
# --------------------------------------------------------------------------- #


def parse_reference_config(path: str) -> dict:
    """Parse the reference's configargparse txt format (``key = value`` lines,
    ``#`` comments — e.g. configs/nerf_param_ycbv_general.txt)."""
    out: dict = {}
    with open(path, "r") as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = (s.strip() for s in line.split("=", 1))
            out[key] = _coerce(val)
    return out


def _coerce(val: str):
    low = val.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    try:
        return int(val)
    except ValueError:
        pass
    try:
        return float(val)
    except ValueError:
        pass
    return val


# flag-name -> (section, field) mapping for the reference CLI surface
# (reference config_parser, neural_sim_main.py:1215-1360)
_FLAG_MAP = {
    "basedir": ("data", "basedir"),
    "datadir": ("data", "datadir"),
    "expname": ("data", "expname"),
    "object_id": ("data", "object_id"),
    "dataset_type": ("data", "dataset_type"),
    "half_res": ("data", "half_res"),
    "testskip": ("data", "testskip"),
    "train_val_path_info": ("data", "train_val_path_info"),
    "test_distribution": ("data", "test_distribution"),
    "ft_path": ("data", "ft_path"),
    "white_bkgd": ("data", "white_bkgd"),
    "render_factor": ("data", "render_factor"),
    "netdepth": ("net", "netdepth"),
    "netwidth": ("net", "netwidth"),
    "netdepth_fine": ("net", "netdepth_fine"),
    "netwidth_fine": ("net", "netwidth_fine"),
    "multires": ("net", "multires"),
    "multires_views": ("net", "multires_views"),
    "i_embed": ("net", "i_embed"),
    "use_viewdirs": ("net", "use_viewdirs"),
    "N_samples": ("render", "n_samples"),
    "N_importance": ("render", "n_importance"),
    "perturb": ("render", "perturb"),
    "raw_noise_std": ("render", "raw_noise_std"),
    "lindisp": ("render", "lindisp"),
    "chunk": ("render", "ray_chunk"),
    "N_rand": ("train", "n_rand"),
    "lrate": ("train", "lrate"),
    "lrate_decay": ("train", "lrate_decay"),
    "precrop_iters": ("train", "precrop_iters"),
    "precrop_frac": ("train", "precrop_frac"),
    "no_batching": ("train", "no_batching"),
    "i_print": ("train", "i_print"),
    "i_weights": ("train", "i_weights"),
    "i_testset": ("train", "i_testset"),
    "i_video": ("train", "i_video"),
    "render_only": ("train", "render_only"),
    "render_test": ("train", "render_test"),
    "n_iters": ("train", "n_iters"),      # extension: reference hardcodes 200k
    "n_samples_K": ("sampler", "n_samples_k"),
    "gumble_T": ("sampler", "gumbel_temperature"),
    "n_epochs": ("bilevel", "n_epochs"),
    "opt_lr": ("bilevel", "opt_lr"),
    "opt_method": ("bilevel", "opt_method"),
    "psi_pose_cats_mode": ("bilevel", "psi_pose_cats_mode"),
    "optimization": ("bilevel", "optimization"),
    "pretrain": ("detector", "pretrain"),
    "pretrain_weight": ("detector", "pretrain_weight"),
    # extensions with no reference analog (production occupancy culling,
    # gaussian psi, psi-gradient mode selection)
    "hit_budget": ("render", "hit_budget"),
    "tighten_bounds": ("render", "tighten_bounds"),
    "cull_mode": ("render", "cull_mode"),
    "n_samples_culled": ("render", "n_samples_culled"),
    "n_importance_culled": ("render", "n_importance_culled"),
    "use_pallas": ("render", "use_pallas"),
    "fine_fraction": ("render", "fine_fraction"),
    "psi_mode": ("bilevel", "psi_mode"),
    "grad_mode": ("bilevel", "grad_mode"),
    "ihvp_solver": ("bilevel", "ihvp_solver"),
    "cg_iters": ("bilevel", "cg_iters"),
    "lissa_iters": ("bilevel", "lissa_iters"),
    "lissa_scale": ("bilevel", "lissa_scale"),
    "grad_image_batch": ("bilevel", "grad_image_batch"),
    "strip_image_batch": ("bilevel", "strip_image_batch"),
    "grad_compute_dtype": ("bilevel", "grad_compute_dtype"),
    "grad_hit_budget": ("bilevel", "grad_hit_budget"),
    "eval_stream_images": ("detector", "eval_stream_images"),
    "reuse_coarse": ("render", "reuse_coarse"),
    "ndc": ("render", "ndc"),
    # the hash-grid field's settings (HashNetConfig; i_embed = 1)
    **{name: ("net", name) for name in (
        "hash_levels", "log2_hashmap_size", "base_resolution", "finest_resolution")},
}

# flags the reference accepts but that have no effect on this implementation
# (llff/deepvoxels paths, netchunk-style serial chunking, tensorboard cadence)
_IGNORED_FLAGS = {
    "config", "netchunk", "no_reload",
    "shape", "factor", "no_ndc", "spherify", "llffhold", "i_img",
}


# flags of the JAX package whose fields the port leaves out: they raise,
# naming the flag, instead of being dropped
_UNPORTED_FLAGS = {
    "grad_dynamic_start": "a traced strip offset of the XLA strips program; "
                          "the port's strips take no such argument",
}


def config_from_flags(flags: dict, base: Optional[NeuralSimConfig] = None) -> NeuralSimConfig:
    """Build a NeuralSimConfig from a dict of reference-style flag values."""
    cfg = base or NeuralSimConfig()
    flags = dict(flags)
    # one-flag production preset (round-4 bench headline: single-pass
    # grid-guided rendering); applied BEFORE field flags so explicit
    # --n_samples_culled etc. still override the preset
    if flags.pop("production_render", False):
        cfg = dataclasses.replace(cfg, render=cfg.render.production_mode())
    sections = {
        "net": dict(), "render": dict(), "camera": dict(), "sampler": dict(),
        "detector": dict(), "bilevel": dict(), "data": dict(), "train": dict(),
    }
    for key, val in flags.items():
        if key in _IGNORED_FLAGS:
            continue
        if key in _UNPORTED_FLAGS:
            raise KeyError(f"flag --{key} sets a field the port leaves out "
                           f"({_UNPORTED_FLAGS[key]})")
        if key not in _FLAG_MAP:
            raise KeyError(f"unknown flag: --{key}")
        sec, fieldname = _FLAG_MAP[key]
        if isinstance(val, str) and val == "None":
            # nullable knobs (n_samples_culled / n_importance_culled / ...)
            # accept `--flag None` to restore the disabled state; without
            # this the truthy string "None" would flow into sample-count
            # arithmetic at trace time
            val = None
        if key == "perturb":            # reference uses float 0/1
            val = bool(val)
        if key in ("optimization", "pretrain"):
            val = bool(val)
        if key in ("object_id", "psi_pose_cats_mode"):
            val = str(val)
        sections[sec][fieldname] = val
    net = sections["net"]
    hashed = set(net) - {f.name for f in dataclasses.fields(NeRFNetConfig)}
    if net.get("i_embed", cfg.net.i_embed) == HASH_EMBED:
        cfg = dataclasses.replace(cfg, net=hash_net(cfg.net))
    elif hashed:
        raise KeyError(f"flags {sorted(hashed)} set a hash-grid field: they need --i_embed "
                       f"{HASH_EMBED}")
    return dataclasses.replace(
        cfg,
        **{
            name: dataclasses.replace(getattr(cfg, name), **vals)
            for name, vals in sections.items()
            if vals
        },
    )


def load_config(config_path: Optional[str] = None, overrides: Optional[dict] = None) -> NeuralSimConfig:
    """txt config + CLI overrides, reference precedence (CLI > file > defaults)."""
    flags: dict = {}
    if config_path:
        flags.update(parse_reference_config(config_path))
    if overrides:
        flags.update(overrides)
    return config_from_flags(flags)


def parse_cli(argv=None) -> NeuralSimConfig:
    """Reference-compatible CLI: ``--config file.txt`` + ``--flag value`` pairs."""
    import argparse

    parser = argparse.ArgumentParser("neuralsim_tpu_torch")
    parser.add_argument("--config", type=str, default=None)
    known, rest = parser.parse_known_args(argv)
    overrides: dict = {}
    it = iter(rest)
    for tok in it:
        if not tok.startswith("--"):
            raise SystemExit(f"unexpected argument {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            overrides[key] = _coerce(val)
            continue
        # reference store_true flags
        if key in ("no_batching", "use_viewdirs", "white_bkgd", "half_res",
                   "lindisp", "no_reload", "render_only", "render_test",
                   "no_ndc", "spherify", "production_render"):
            overrides[key] = True
            continue
        overrides[key] = _coerce(next(it))
    return load_config(known.config, overrides)
