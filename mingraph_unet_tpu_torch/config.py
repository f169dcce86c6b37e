"""Typed configuration system: the port's own copy of
``mingraph_unet_tpu/config.py`` (the same dataclasses, fields, defaults and
YAML loading), so that the port imports nothing of the JAX package. PyYAML
is imported only where a file is read or written.

Mirrors the reference's four-domain YAML split (``dataset.yaml`` /
``model.yaml`` / ``preprocessing.yaml`` / ``training.yaml``; reference
``configs/*.yaml`` and the plain-dict ``load_config`` /
``get_config_recursively`` helpers at ``scripts/train_end_to_end.py:92-103``)
but as validated dataclasses. The reference ships a malformed
``configs/dataset.yaml`` (the YAML is wrapped in stray Markdown fences,
``configs/dataset.yaml:1-7``) which silently breaks ``yaml.safe_load`` — the
loader here strips Markdown code fences before parsing and validates the
result, so that failure mode is caught loudly instead.
"""

from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "DatasetConfig",
    "ModelConfig",
    "UNetConfig",
    "GraphConstructionConfig",
    "GATConfig",
    "MinCutConfig",
    "FusionDetectionConfig",
    "LossWeightsConfig",
    "PreprocessingConfig",
    "TrainingConfig",
    "PipelineConfig",
    "load_yaml",
    "get_by_path",
    "load_config",
]


# ---------------------------------------------------------------------------
# YAML helpers
# ---------------------------------------------------------------------------

_FENCE_RE = re.compile(r"^\s*```.*$", re.MULTILINE)
_MD_HEADING_RE = re.compile(r"^\s*\*\*`?[^`\n]*`?\*\*\s*$", re.MULTILINE)


def _strip_markdown(text: str) -> str:
    """Remove Markdown code fences / bold-heading lines wrapping a YAML body.

    The reference's ``configs/dataset.yaml`` begins with a ``---`` + a bold
    filename heading + an opening code fence; ``yaml.safe_load`` then yields a
    string instead of the intended mapping. We tolerate that format.
    """
    text = _FENCE_RE.sub("", text)
    text = _MD_HEADING_RE.sub("", text)
    # A leading bare document separator is fine for YAML, keep it.
    return text


def load_yaml(path: str) -> Dict[str, Any]:
    """Load a YAML file into a dict, tolerating Markdown-wrapped bodies."""
    import yaml

    with open(path, "r") as f:
        raw = f.read()
    try:
        data = yaml.safe_load(raw)
    except yaml.YAMLError:
        data = None
    if not isinstance(data, dict):
        data = yaml.safe_load(_strip_markdown(raw))
    if not isinstance(data, dict):
        raise ValueError(f"Config file {path!r} did not parse to a mapping (got {type(data).__name__}).")
    return data


def load_config(config_dir: str, config_name: str) -> Dict[str, Any]:
    """Dict-level loader, API-compatible with the reference's ``load_config``
    (``scripts/train_end_to_end.py:92-94``)."""
    return load_yaml(os.path.join(config_dir, config_name))


def get_by_path(cfg: Any, key_path: str, default: Any = None) -> Any:
    """Dotted-path getter over nested dicts/dataclasses.

    Equivalent of the reference's ``get_config_recursively``
    (``scripts/train_end_to_end.py:96-103``), extended to dataclasses.
    """
    current = cfg
    for part in key_path.split("."):
        if isinstance(current, dict):
            if part not in current:
                return default
            current = current[part]
        elif dataclasses.is_dataclass(current) and hasattr(current, part):
            current = getattr(current, part)
        else:
            return default
    return current


def _filter_kwargs(cls, data: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in data.items() if k in names}


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


@dataclass
class DatasetConfig:
    """Dataset layout + label-space config (reference ``configs/dataset.yaml``,
    intended content at lines 8-26 of the malformed file)."""

    dataset_name: str = "BanginapalleMangoDataset"
    data_root: str = "data/"
    train_dir: str = "train/"
    val_dir: str = "val/"
    test_dir: str = "test/"
    image_folder: str = "images/"
    mask_folder: str = "masks/"
    video_data_path: str = ""
    image_height: int = 128
    image_width: int = 128
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    num_classes: int = 2
    num_semantic_regions: int = 2
    num_detection_classes: int = 1
    # COCO-style instance annotations (data/annotations.py): enables
    # per-instance GT for the dense detection head and the shape loss's
    # intended instance path (reference shape_loss.py:150-180). Relative
    # paths resolve under data_root/train_dir.
    annotations_file: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DatasetConfig":
        d = dict(d)
        for k in ("mean", "std"):
            if k in d and d[k] is not None:
                d[k] = tuple(float(x) for x in d[k])
        cfg = cls(**_filter_kwargs(cls, d))
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.num_classes < 1:
            raise ValueError(f"num_classes must be >= 1, got {self.num_classes}")
        if len(self.mean) != 3 or len(self.std) != 3:
            raise ValueError("mean/std must have 3 channel entries")
        if self.image_height <= 0 or self.image_width <= 0:
            raise ValueError("image dimensions must be positive")


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclass
class UNetConfig:
    """U-Net topology (reference ``configs/model.yaml`` ``unet`` block and
    ``model/unet/unet_model.py:7`` defaults)."""

    in_channels: int = 3
    out_channels: int = 2
    init_features: int = 32
    depth: int = 4
    use_batchnorm: bool = True
    # Rematerialize ConvBlocks in the backward pass (jax.checkpoint): trades
    # FLOPs for HBM at large training resolutions. TPU-native addition.
    remat: bool = False
    # Space-to-depth lowering of the full-resolution levels (exact
    # reparameterization, ~2× faster at 512² on v5e; ops/s2d.py).
    s2d_level0: bool = True
    # Extend s2d one level down (256-lane convs at encoder block1 / decoder
    # i=1). Exact reparameterization. None = auto (r4): engage at inference
    # exactly when the 256-lane phase-select kernel will run (712 → 737
    # img/s at 512² b8 v5e; a loss without it — models/unet.py::_psconv_auto).
    s2d_level1: Optional[bool] = None

    def validate(self) -> None:
        if self.depth < 1:
            raise ValueError("UNet depth must be >= 1")
        if self.init_features < 1:
            raise ValueError("init_features must be >= 1")


@dataclass
class GraphConstructionConfig:
    """Patch-lattice construction (reference ``configs/model.yaml``
    ``graph_construction`` block; 4-connectivity per
    ``preprocessing/graph_construction/patch_graph_construction.py:49-102``)."""

    patch_size: int = 16
    # Dimensionality of the per-patch U-Net feature component. The reference
    # hard-codes a placeholder of 16 (``scripts/train_end_to_end.py:144``); we
    # pool real encoder features and project to this width.
    unet_patch_feature_dim: int = 16

    def validate(self) -> None:
        if self.patch_size < 1:
            raise ValueError("patch_size must be >= 1")


@dataclass
class GATConfig:
    """GAT stack config (reference ``configs/model.yaml`` ``gat`` block and
    ``model/gat/graph_attention.py:162-192``)."""

    hidden_dim: int = 128
    num_heads: int = 4
    output_dim: int = 64
    dropout: float = 0.1
    alpha: float = 0.2
    num_layers: int = 1

    def validate(self) -> None:
        if self.num_heads < 1:
            raise ValueError("num_heads must be >= 1")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError("dropout must be in [0, 1)")


@dataclass
class MinCutConfig:
    """Normalized-cut stage config (reference ``configs/model.yaml`` ``mincut``
    block; ctor params stored-but-unused at
    ``model/graph_partition/mincut_refinement.py:6-27``; the live σ for Ncut
    edge weights is hard-coded 1.0 at line 50)."""

    gamma_unet_priors: float = 0.5
    sigma_intensity: float = 10.0
    sigma_features: float = 1.0
    # σ used by the Ncut Gaussian edge-weight kernel (reference hard-codes 1.0).
    sigma_ncut: float = 1.0

    def validate(self) -> None:
        if self.sigma_ncut <= 0:
            raise ValueError("sigma_ncut must be > 0")


@dataclass
class FusionDetectionConfig:
    """Fusion + detection head config (reference ``configs/model.yaml``
    ``fusion_detection`` block; head layout at
    ``model/fusion_detection/detection_head.py:32-67``)."""

    fc_hidden_dim: int = 256
    num_detection_outputs: int = 5
    fusion_method: str = "concat"
    # TPU-native additions: optional multi-instance dense head + its training.
    use_dense_detection: bool = False
    max_instances: int = 16
    # Pre-pool the fused map to ≤S×S before the detection conv stack (TPU
    # fast path; None = reference-exact full-resolution convs). See
    # models/detection.py::DetectionHead.
    detection_pre_pool: Optional[int] = None

    def validate(self) -> None:
        if self.fusion_method not in ("concat", "add"):
            raise ValueError("fusion_method must be 'concat' or 'add'")
        if self.detection_pre_pool is not None and self.detection_pre_pool < 1:
            raise ValueError("detection_pre_pool must be >= 1 or null")


@dataclass
class AblationConfig:
    """Pipeline stage toggles for the paper's Table-3 ablations (reference
    ``experiments/ablation_study.py:36-40, 78-85`` names the requirement —
    "instantiate the ablated model" — without implementing switches)."""

    use_patch_gat: bool = True
    use_partition: bool = True
    use_region_gat: bool = True
    use_fusion: bool = True


@dataclass
class LossWeightsConfig:
    """L_total weights (reference ``configs/model.yaml`` ``losses`` block and
    ``scripts/train_end_to_end.py:472-476``)."""

    l_shape_weight: float = 0.1
    l_feature_weight: float = 0.1
    l_partition_weight: float = 0.5
    l_smooth_weight: float = 0.2
    feature_loss_margin: float = 1.0
    # Partition supervision (framework addition, default OFF): patch-level
    # cross-entropy between the MinCut soft assignments and the GT patch
    # labels y_p already computed for L_feature. The reference's stated
    # intent is partitions that respect object boundaries
    # (mincut_refinement.py:9-10, graph_refinement.py:89-103); the
    # unsupervised Ncut alone was measured NOT to align with fruit (r4
    # value study) — this is the supervised escape hatch.
    l_partition_sup_weight: float = 0.0
    # Soft-Dice weight used by the U-Net-only trainer (CE + dice at
    # ``scripts/train_segmentation.py:127-131``).
    dice_weight: float = 1.0


@dataclass
class ModelConfig:
    unet: UNetConfig = field(default_factory=UNetConfig)
    graph_construction: GraphConstructionConfig = field(default_factory=GraphConstructionConfig)
    gat: GATConfig = field(default_factory=GATConfig)
    mincut: MinCutConfig = field(default_factory=MinCutConfig)
    fusion_detection: FusionDetectionConfig = field(default_factory=FusionDetectionConfig)
    losses: LossWeightsConfig = field(default_factory=LossWeightsConfig)
    ablation: AblationConfig = field(default_factory=AblationConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        def build(sub_cls, key):
            sub = d.get(key) or {}
            return sub_cls(**_filter_kwargs(sub_cls, sub))

        cfg = cls(
            unet=build(UNetConfig, "unet"),
            graph_construction=build(GraphConstructionConfig, "graph_construction"),
            gat=build(GATConfig, "gat"),
            mincut=build(MinCutConfig, "mincut"),
            fusion_detection=build(FusionDetectionConfig, "fusion_detection"),
            losses=build(LossWeightsConfig, "losses"),
            ablation=build(AblationConfig, "ablation"),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        self.unet.validate()
        self.graph_construction.validate()
        self.gat.validate()
        self.mincut.validate()
        self.fusion_detection.validate()


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------


@dataclass
class PreprocessingConfig:
    """Preprocessing / augmentation config (reference
    ``configs/preprocessing.yaml:1-16``). Unlike the reference
    (``image_preprocess.py:151-154``), geometric augmentations here are
    applied with a shared PRNG key so image and mask stay in sync."""

    resize_dim: Tuple[int, int] = (128, 128)
    normalization_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    normalization_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    horizontal_flip_prob: float = 0.5
    rotation_degrees: float = 15.0
    random_crop_prob: float = 0.5
    sobel_kernel_size: int = 3
    gaussian_blur_kernel: Tuple[int, int] = (5, 5)
    gaussian_blur_sigma: float = 1.0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PreprocessingConfig":
        d = dict(d)
        # Accept the reference's field spellings (configs/preprocessing.yaml).
        aug = d.pop("augmentation", None) or {}
        d.setdefault("horizontal_flip_prob", aug.get("random_horizontal_flip_prob", 0.5))
        d.setdefault("rotation_degrees", aug.get("random_rotation_degrees", 15.0))
        d.setdefault("random_crop_prob", aug.get("random_crop_prob", 0.5))
        if "gaussian_blur_kernel_size" in d:
            d.setdefault("gaussian_blur_kernel", d.pop("gaussian_blur_kernel_size"))
        if "resize_dim" in d and d["resize_dim"] is not None:
            d["resize_dim"] = tuple(int(x) for x in d["resize_dim"])
        if "gaussian_blur_kernel" in d and d["gaussian_blur_kernel"] is not None:
            d["gaussian_blur_kernel"] = tuple(int(x) for x in d["gaussian_blur_kernel"])
        for k in ("normalization_mean", "normalization_std"):
            if k in d and d[k] is not None:
                d[k] = tuple(float(x) for x in d[k])
        cfg = cls(**_filter_kwargs(cls, d))
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if any(k % 2 == 0 for k in self.gaussian_blur_kernel):
            raise ValueError("gaussian_blur_kernel sizes must be odd")
        if self.sobel_kernel_size % 2 == 0:
            raise ValueError("sobel_kernel_size must be odd")
        if not 0.0 <= self.horizontal_flip_prob <= 1.0:
            raise ValueError("horizontal_flip_prob must be in [0, 1]")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclass
class TrainingConfig:
    """Optimizer / loop config (reference ``configs/training.yaml:1-24``).

    TPU-native additions: ``bf16`` mixed precision, mesh axis sizes for
    data/spatial parallelism, and checkpoint-resume (absent from the
    reference: training always restarts at epoch 0, SURVEY §5)."""

    batch_size: int = 16
    learning_rate: float = 1.0e-3
    num_epochs: int = 100
    optimizer: str = "adam"
    sgd_momentum: float = 0.9
    weight_decay: float = 1.0e-4
    lr_scheduler: Optional[str] = "steplr"
    lr_step_size: int = 30
    lr_gamma: float = 0.1
    device: str = "tpu"
    num_workers: int = 4
    checkpoint_dir: str = "checkpoints/"
    log_dir: str = "logs/"
    log_interval: int = 10
    save_epoch_interval: int = 5
    # --- TPU-native additions ---
    seed: int = 0
    bf16: bool = False
    data_parallel: int = 1
    spatial_parallel: int = 1
    resume: bool = True
    donate_buffers: bool = True
    debug_nans: bool = False
    # Device-resident multi-step window: lax.scan over K pre-staged batches
    # per host dispatch (one metrics fetch per window). 1 = step-per-dispatch.
    scan_window: int = 1
    # Keep the max_to_keep BEST checkpoints by this epoch metric (e.g.
    # "loss", best_mode below) instead of the newest. None = newest.
    checkpoint_best_metric: Optional[str] = None
    checkpoint_best_mode: str = "min"
    # Two-phase schedule (the value study's measured rescue for multi-loss
    # cold-start collapse, outputs/VALUE_STUDY.md): for the first N epochs
    # the four graph-loss weights (shape/feature/partition/smooth) are
    # zeroed — segmentation(+detection) train alone — then the full L_total
    # engages. 0 = joint from the start (the reference's schedule,
    # train_end_to_end.py:472-476). Resume-safe: the phase derives from the
    # epoch counter.
    graph_warmup_epochs: int = 0
    # In-step instance decomposition (soft shape loss + CC-derived dense-
    # detection GT): "fast" = scatter-free stencil CC + dense top-K
    # (ops/cc.py, ~free on TPU; exact for ≤~16 compact blobs — the domain's
    # images); "exact" = general hook-and-jump CC + histogram top-K
    # (content-exact under speckled/noisy-label masks, but 188 ms at
    # 16×128² / 1102 ms at 8×512² on v5e, r4 probe — noisy-label studies
    # opt in, production training keeps "fast").
    instancing: str = "fast"
    # Multi-task loss balancing over the graph-loss terms: "none" = fixed λ
    # (the reference's scheme, train_end_to_end.py:472-476); "uncertainty" =
    # Kendall-style learned log-variance weights s_i per ACTIVE graph loss
    # (term = exp(-s_i)·λ_i·L_i + s_i/2), trained jointly — a principled
    # balancer for the measured multi-loss cold-start interference
    # (outputs/VALUE_STUDY.md). L_seg and detection stay at fixed weight 1.
    loss_balance: str = "none"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainingConfig":
        cfg = cls(**_filter_kwargs(cls, dict(d)))
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.optimizer.lower() not in ("adam", "sgd"):
            raise ValueError(f"Optimizer {self.optimizer!r} not supported (adam|sgd).")
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.scan_window < 1:
            raise ValueError("scan_window must be >= 1")
        if self.lr_scheduler is not None and self.lr_scheduler.lower() not in ("steplr", "none"):
            raise ValueError("lr_scheduler must be 'steplr', 'none' or null")
        if self.instancing not in ("fast", "exact"):
            raise ValueError("instancing must be 'fast' or 'exact'")
        if self.graph_warmup_epochs < 0:
            raise ValueError("graph_warmup_epochs must be >= 0")
        if self.loss_balance not in ("none", "uncertainty"):
            raise ValueError("loss_balance must be 'none' or 'uncertainty'")


# ---------------------------------------------------------------------------
# Bundle
# ---------------------------------------------------------------------------


@dataclass
class PipelineConfig:
    """The four-domain bundle used by scripts and trainers."""

    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)

    @classmethod
    def from_config_dir(cls, config_dir: str) -> "PipelineConfig":
        return cls(
            dataset=DatasetConfig.from_dict(load_yaml(os.path.join(config_dir, "dataset.yaml"))),
            model=ModelConfig.from_dict(load_yaml(os.path.join(config_dir, "model.yaml"))),
            preprocessing=PreprocessingConfig.from_dict(
                load_yaml(os.path.join(config_dir, "preprocessing.yaml"))
            ),
            training=TrainingConfig.from_dict(load_yaml(os.path.join(config_dir, "training.yaml"))),
        )

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def write_defaults(config_dir: str) -> None:
        """Write the four default YAML files (used by self-bootstrapping
        script ``__main__`` smoke paths, mirroring e.g.
        ``scripts/train_end_to_end.py:532-550``)."""
        import yaml

        os.makedirs(config_dir, exist_ok=True)
        cfg = PipelineConfig()
        domains = {
            "dataset.yaml": dataclasses.asdict(cfg.dataset),
            "model.yaml": dataclasses.asdict(cfg.model),
            "preprocessing.yaml": dataclasses.asdict(cfg.preprocessing),
            "training.yaml": dataclasses.asdict(cfg.training),
        }
        for name, data in domains.items():
            with open(os.path.join(config_dir, name), "w") as f:
                yaml.safe_dump(_tuples_to_lists(data), f, sort_keys=False)


def _tuples_to_lists(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _tuples_to_lists(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [_tuples_to_lists(v) for v in obj]
    return obj
