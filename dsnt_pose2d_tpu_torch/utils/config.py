"""Frozen dataclass configs: the experiment schema, shared with the JAX package.

A copy of ``dsnt_pose2d_tpu/utils/config.py`` (the port imports nothing of the
JAX package): the same dataclasses, defaults and JSON (de)serialization, so
one JSON file in ``configs/`` loads into both packages.  Fields that select
JAX/TPU machinery keep their names and meaning: ``use_pallas`` selects the
fused DSNT-head kernel (here the CUDA kernel), ``warp_method='shear'`` the
row-shift kernel.

The port also accepts bases that the JAX package lacks (``hrnet_w48``, an
HRNet, at the end of :data:`BASE_MODELS`).  Such a base has no preset under
``configs/``: ``tests/test_cli.py`` pins those presets to the JAX package's
six, and every preset there loads in both packages.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

BASE_MODELS = (
    "hg1", "hg2", "hg4", "hg8",
    "resnet18", "resnet34", "resnet50", "resnet101",
    # BASELINE stretch config #5: ViT backbones (tiny/small/base, 16px patch).
    "vit_t16", "vit_s16", "vit_b16",
    # The port alone: HRNet-W48 (Sun et al., arXiv:1902.09212).
    "hrnet_w48",
)
OUTPUT_STRATS = ("dsnt", "gauss", "fc")
PREACTS = ("softmax", "thresholded_softmax", "relu", "abs", "sigmoid")
REGS = ("none", "var", "kl", "js", "mse")

# MPII has 16 joints (SURVEY.md C10).
MPII_NUM_JOINTS = 16

# Numeric-compatibility version of the model graph.  Bump whenever a change
# keeps checkpoints structurally loadable but shifts their numerics.
#   v1: original round-1/2 graph.
#   v2: hourglass stem conv padding changed from XLA SAME (2,3) to explicit
#       symmetric (3,3) (torch/Newell parity fix) — v1 checkpoints load but
#       see shifted stem features.
MODEL_VERSION = 2


@dataclass(frozen=True)
class ModelConfig:
    """Model architecture + head configuration (reference model-factory args)."""

    base: str = "hg1"
    dilate: int = 0
    truncate: int = 0
    output_strat: str = "dsnt"
    preact: str = "softmax"
    reg: str = "none"
    reg_coeff: float = 1.0
    hm_sigma: float = 1.0
    # Logit cutoff for preact='thresholded_softmax' (SURVEY.md section 7
    # item 2 open pin); flows to both the jnp and the fused Pallas paths.
    hm_threshold: float = 0.0
    num_joints: int = MPII_NUM_JOINTS
    # Coordinate loss for dsnt/fc heads (paper ablates euclidean/l1/mse).
    coord_loss: str = "euclidean"
    # Per-stack loss reduction under intermediate supervision.  Sum is the
    # hourglass-lineage default (SURVEY.md section 7 item 8).
    stack_loss: str = "sum"
    # Heatmap-matching ('gauss') target: peak-1 unnormalized Gaussian as in the
    # Newell lineage (set True for a sum-to-1 target).
    gauss_target_normalize: bool = False
    # Use the fused DSNT-head kernel (ops/cuda/dsnt_head.cu on the card)
    # instead of the plain op composition.  Numerics agree to ~1e-6.
    use_pallas: bool = True
    # Backbone compute dtype; params stay fp32, head math always fp32.
    dtype: str = "bfloat16"
    # Rematerialize each hourglass stack / ViT block on the backward pass
    # (training only; a ResNet ignores it).
    remat: bool = False
    # Architecture-scale knobs (reference values by default; shrink for CI).
    hg_features: int = 256
    hg_depth: int = 4
    input_size: int = 0  # 0 = default for base (256 hg, hrnet / 224 resnet)
    # Numeric-compatibility version stamped into checkpoints (see
    # MODEL_VERSION above); configs deserialized without the field are v1.
    model_version: int = MODEL_VERSION

    def __post_init__(self):
        if self.base not in BASE_MODELS and not self.base.startswith("hg"):
            raise ValueError(f"unknown base model {self.base!r}")
        if self.output_strat not in OUTPUT_STRATS:
            raise ValueError(f"unknown output strategy {self.output_strat!r}")
        if self.preact not in PREACTS:
            raise ValueError(f"unknown preact {self.preact!r}")
        if self.reg not in REGS:
            raise ValueError(f"unknown regularizer {self.reg!r}")
        if self.stack_loss not in ("sum", "mean"):
            raise ValueError(f"stack_loss must be sum|mean, got {self.stack_loss!r}")
        if self.coord_loss not in ("euclidean", "l1", "mse"):
            raise ValueError(f"unknown coord_loss {self.coord_loss!r}")

    @property
    def resolved_input_size(self) -> int:
        if self.input_size:
            return self.input_size
        if self.base.startswith(("hg", "hrnet")):
            return 256
        if self.base.startswith("vit"):
            return 448  # 2x-resolution stretch config
        return 224


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer + schedule (reference: RMSProp 2.5e-4, step decay x0.1)."""

    optimizer: str = "rmsprop"
    lr: float = 2.5e-4
    rmsprop_decay: float = 0.99  # torch RMSprop alpha default
    eps: float = 1e-8
    momentum: float = 0.0
    weight_decay: float = 0.0
    schedule: str = "step"  # 'step' | 'constant' | 'cosine'
    lr_drop_epochs: tuple[int, ...] = (60, 90)
    lr_drop_factor: float = 0.1
    grad_clip_norm: float = 0.0  # 0 = off


@dataclass(frozen=True)
class DataConfig:
    data_dir: str = "data/mpii"
    source: str = "auto"  # 'auto' | 'h5' | 'synthetic'
    # Host canvas side (px): the static-shape decoded person region fed to the
    # on-device augmentation graph.  1.5x the input size leaves rotation/zoom
    # headroom; 0 = auto (384 for 256-px models, 96 for the synthetic fixture).
    canvas_size: int = 0
    # Augmentation (reference values, SURVEY.md C11).
    max_rotation_deg: float = 30.0
    # Probability of applying rotation at all (hourglass-lineage training
    # rotates only a fraction of samples; 1.0 = always).
    rotation_prob: float = 1.0
    scale_range: tuple[float, float] = (0.75, 1.25)
    flip_prob: float = 0.5
    color_jitter: float = 0.2  # per-channel scale in U(1-j, 1+j); 0 = off
    # Bilinear warp implementation.  'shear' (default) = shear-decomposed
    # multi-pass: per-row shifts via the row_shift kernel
    # (ops/cuda/row_shift.cu on the card) + two resampling matmuls — equal to
    # direct 2-D bilinear for every rotation-free affine (the deterministic
    # eval path).  'gather' = direct 2-D bilinear (the shear path's oracle).
    warp_method: str = "shear"
    # ImageNet normalization constants (torchvision-pretrained lineage).
    mean: tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: tuple[float, float, float] = (0.229, 0.224, 0.225)
    synthetic_size: int = 256  # samples in the synthetic fixture
    # Loader sample-fetch threads (GIL-free native decode + h5py/mmap reads
    # release the GIL, so threads scale on host cores; 4 keeps the loader
    # ahead of the chip on the flagship config — see docs/DESIGN.md section 5).
    workers: int = 4
    # Optional torchvision ResNet state_dict (.pth/.npz) to initialize the
    # ResNet backbone from (ImageNet-pretrained, reference C7 parity).
    pretrained_resnet: str = ""
    # Stage the train split in device memory and gather each batch there
    # (the JAX package's data/resident.py; not ported yet).
    device_resident: str = "auto"  # 'auto' | 'on' | 'off'
    # Pack-as-you-stream: when the train split is decode-backed (raw
    # MPIIDataset — no packed archive yet) in a single-host run, epoch 0
    # writes every decoded canvas into the packed-archive layout as a side
    # effect of streaming; at the epoch boundary the archive is atomically
    # published and the trainer hot-swaps to the mmap reader (and, per
    # device_resident, into HBM residency).  Fresh runs thus converge to
    # resident-path speed from epoch 1 without a manual data.pack step.
    auto_pack: bool = True

    def __post_init__(self):
        if self.device_resident not in ("auto", "on", "off"):
            raise ValueError(
                f"device_resident must be auto|on|off, got {self.device_resident!r}")


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32  # global batch (sharded over the data mesh axis)
    epochs: int = 120
    seed: int = 12345
    out_dir: str = "out"
    experiment_id: str = ""  # '' = timestamp-derived
    checkpoint_every_epochs: int = 1
    # Mid-epoch checkpointing every N optimizer steps (0 = off): enables
    # exact resume inside a long epoch (loader replays from the stored
    # step offset; augmentation is fold_in(rng, step)-keyed, so a resumed
    # run matches the uninterrupted one bit-for-bit).
    checkpoint_every_steps: int = 0
    keep_checkpoints: int = 3
    log_every_steps: int = 20
    eval_every_epochs: int = 1
    donate: bool = True
    # Eval-time horizontal-flip averaging (reference evaluate.py option):
    # average decoded coords with the unflipped ones from a mirrored pass.
    flip_eval: bool = False
    # Eval-time multi-scale averaging (SURVEY C16): decode at each crop
    # scale (same semantics as the train-time scale augmentation factor —
    # larger zooms in), map every pass back to ORIGINAL-image pixels and
    # average there. (1.0,) = single canonical pass (the default).
    # Composes with flip_eval (the mirrored pass runs per scale).
    eval_scales: tuple = (1.0,)
    # Optimizer steps per host dispatch (lax.scan over a stacked super-batch);
    # >1 amortizes host/transport latency. Numerics identical to 1.
    steps_per_dispatch: int = 1
    # Tensor-parallel width: size of the mesh's 'model' axis.  Devices split
    # as (data = n/model_parallel, model = model_parallel); conv/dense
    # kernels are column-sharded over 'model' (parallel/tp.py) and XLA
    # inserts the collectives.  1 = pure data parallelism (default; right
    # for every reference-sized model — see parallel/tp.py docstring).
    model_parallel: int = 1


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


# ---------------------------------------------------------------------------
# (De)serialization
# ---------------------------------------------------------------------------

def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    return obj


def config_to_json(cfg: Config) -> str:
    return json.dumps(_to_dict(cfg), indent=2, sort_keys=True)


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) or f.name in ("model", "optim", "data", "train"):
            sub = {"model": ModelConfig, "optim": OptimConfig,
                   "data": DataConfig, "train": TrainConfig}[f.name]
            kwargs[f.name] = _from_dict(sub, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def config_from_json(s: str) -> Config:
    d = json.loads(s)
    # Configs serialized before the model_version field existed are of
    # UNKNOWN vintage (0): the stem-padding fix landed before the field did,
    # so a field-less config may be either side of it — loaders warn
    # tentatively for 0 and definitively for an explicit old version.
    if isinstance(d.get("model"), dict):
        d["model"].setdefault("model_version", 0)
    return _from_dict(Config, d)
