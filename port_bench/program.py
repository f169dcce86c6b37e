"""The system under test: the port's models built from a configuration file,
with the benchmark's weights loaded, and the reference's view of the same
configuration. The only module of the harness, with the drivers, that
imports ``mingraph_unet_tpu_torch``."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from port_bench.reference import model as ref
from port_bench.weights import draw_weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def set_backend_flags(config: dict) -> None:
    """The precision the configuration states: its TF32 switches."""
    flags = config.get("backend_flags", {})
    if "cudnn.allow_tf32" in flags:
        torch.backends.cudnn.allow_tf32 = bool(flags["cudnn.allow_tf32"])
    if "cuda.matmul.allow_tf32" in flags:
        torch.backends.cuda.matmul.allow_tf32 = bool(flags["cuda.matmul.allow_tf32"])


def spec(config: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    if config["model"] == "MinGraphUNet":
        return ref.pipeline_spec(config["args"])
    u = config["pipeline"]["model"]["unet"]
    return ref.unet_spec("", u["in_channels"], u["out_channels"], u["init_features"], u["depth"], u["use_batchnorm"])


def pipeline_config(config: dict):
    from mingraph_unet_tpu_torch.config import (DatasetConfig, ModelConfig, PipelineConfig, PreprocessingConfig,
                                                TrainingConfig)

    p = config["pipeline"]
    return PipelineConfig(dataset=DatasetConfig.from_dict(p["dataset"]), model=ModelConfig.from_dict(p["model"]),
                          preprocessing=PreprocessingConfig.from_dict(p["preprocessing"]),
                          training=TrainingConfig.from_dict(p["training"]))


def build(config: dict, weights: Dict[str, torch.Tensor], device, train: bool):
    """The port's model of ``config`` on ``device`` holding ``weights``."""
    if config["model"] == "MinGraphUNet":
        from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet

        model = MinGraphUNet(**config["args"], dtype=DTYPES[config["precision"]], device=device)
    else:
        from mingraph_unet_tpu_torch.train.segmentation import build_unet

        cfg = pipeline_config(config)
        if DTYPES[config["precision"]] != (torch.bfloat16 if cfg.training.bf16 else torch.float32):
            raise ValueError("the configuration's precision and its training.bf16 disagree")
        model = build_unet(cfg, device)
    model.load_state_dict(weights, strict=True)
    return model.train(train)


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return draw_weights(spec(config), seed, device)


def normalization(config: dict) -> Tuple[List[float], List[float]]:
    if config["model"] == "MinGraphUNet":
        a = config["args"]
        return list(a["normalization_mean"]), list(a["normalization_std"])
    pre = config["pipeline"]["preprocessing"]
    return list(pre["normalization_mean"]), list(pre["normalization_std"])
