"""MinGraphUNet: U-Net → patch features → lattice GAT → MinCut → region GAT
→ fusion → detection. Counterpart of
``mingraph_unet_tpu/models/pipeline.py::MinGraphUNet`` with the single-box
detection head, in eval and in train mode.

Detection input, decided from the shape as in JAX:

- the pooled path (``detection_pre_pool == H / patch_size == W /
  patch_size``, the serving configuration): the head reads the patch-pooled
  decoder features concatenated with the patch-level graph embeddings, and
  the full-resolution fused map is never built;
- the reference-exact path (any other ``detection_pre_pool``, None included,
  the end-to-end trainer's default): ``fuse_features`` concatenates the
  full-resolution decoder features with the graph embeddings broadcast to
  pixels, and the head (after its own average pool when
  ``detection_pre_pool`` is set) runs its convs on that map.

``model.eval()`` (the default) runs under ``torch.no_grad()`` with the BN
running statistics, and the U-Net's s2d sites launch K1–K3 on the card.
``model.train()`` runs the U-Net in train mode (K4 at the s2d conv2s), the
GAT / MinCut / head dropout from the ``gen`` passed to :meth:`forward`, and
updates every BN's running statistics in place to the values flax's
``mutable=["batch_stats"]`` returns; hist-eq and Sobel (functions of the
input image only) stay outside autograd. The dtype casts follow JAX's, so
the same tensors are f32 in a bf16 model (and f64 in an f64 model, a
reference for the f32 one).

Not ported: the dense detection head and class scores (ROADMAP A3) and the
ablation switches (ROADMAP A2), which the model has no arguments for
(``train/end_to_end.py::mingraph_unet_kwargs`` refuses them in a config),
and Sobel kernels other than 3×3 (``NotImplementedError``).

The parameter tree is flax's (``unet/encoder/block0/conv1/kernel``, ...), so
``convert.py`` loads a JAX checkpoint by renaming; a fresh model draws its
weights from ``torch.Generator().manual_seed(seed)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from mingraph_unet_tpu_torch.device import resolve_device
from mingraph_unet_tpu_torch.models.detection import DetectionHead
from mingraph_unet_tpu_torch.models.fusion import fuse_features
from mingraph_unet_tpu_torch.models.gat import GATNetwork, fully_connected_adjacency
from mingraph_unet_tpu_torch.models.layers import Dense
from mingraph_unet_tpu_torch.models.mincut import MinCutRefinement
from mingraph_unet_tpu_torch.models.unet import UNet
from mingraph_unet_tpu_torch.ops import filters
from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
from mingraph_unet_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD, denormalize
from mingraph_unet_tpu_torch.ops.patches import broadcast_patch_to_pixels, patch_reduce_mean
from mingraph_unet_tpu_torch.ops.segment import gather_rows, segment_mean

__all__ = ["MinGraphUNet"]


class MinGraphUNet(nn.Module):
    """The full pipeline. ``forward(images (B, H, W, C) normalized NHWC,
    gen=None)`` returns a dict of tensors (``logits``, ``pred_bboxes``,
    ``pred_confidence``, ``l_partition``, ``soft_assignments``,
    ``hard_patch_labels``, ``gat_feats``, ``f_unet_patches``,
    ``region_embeddings``, ...). ``gen`` (a ``torch.Generator`` on the
    model's device) is required in train mode and draws the dropout masks.

    ``device=None`` runs on the CUDA card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch path. ``full_res_outputs=True``
    adds the full-resolution ``encoder_skips``, ``f_u``, ``f_g_pixel`` and,
    on the reference-exact path, ``fused``, which nothing after the forward
    needs (about 0.5 GB for ``f_g_pixel`` at 512² b8 f32), so they are not
    kept by default."""

    def __init__(
        self,
        num_classes: int = 2,
        init_features: int = 32,
        depth: int = 4,
        patch_size: int = 16,
        unet_patch_feature_dim: int = 16,
        sobel_kernel_size: int = 3,
        normalization_mean: Sequence[float] = IMAGENET_MEAN,
        normalization_std: Sequence[float] = IMAGENET_STD,
        gat_hidden_dim: int = 128,
        gat_output_dim: int = 64,
        gat_num_heads: int = 4,
        gat_num_layers: int = 1,
        gat_dropout: float = 0.1,
        gat_alpha: float = 0.2,
        num_segments: int = 2,
        sigma_ncut: float = 1.0,
        fc_hidden_dim: int = 256,
        detection_pre_pool: Optional[int] = None,
        in_channels: int = 3,
        dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        if num_segments < 2:
            raise ValueError("num_segments must be at least 2 (the region graph needs two nodes)")
        if sobel_kernel_size != 3:
            raise NotImplementedError(f"sobel_kernel_size={sobel_kernel_size}: only the 3x3 Sobel is ported")
        dev = resolve_device(device)
        self.dtype = dtype
        self.patch_size = patch_size
        self.normalization_mean = tuple(normalization_mean)[:3]
        self.normalization_std = tuple(normalization_std)[:3]
        self.num_segments = num_segments
        self.detection_pre_pool = detection_pre_pool
        gen = torch.Generator().manual_seed(seed)
        self.unet = UNet(gen, in_channels, num_classes, init_features, depth, dtype)
        self.patch_feature_proj = Dense(init_features, unet_patch_feature_dim, gen, dtype)
        self.patch_gat = GATNetwork(unet_patch_feature_dim + 4, gat_hidden_dim, gat_output_dim, gat_num_heads,
                                    gen, gat_num_layers, gat_alpha, "lattice", dtype, gat_dropout)
        self.feature_consistency_proj = Dense(init_features, gat_output_dim, gen, dtype)
        self.mincut = MinCutRefinement(gat_output_dim, num_segments, gen, sigma_ncut, gat_output_dim // 2,
                                       max(1, gat_num_heads // 2), gat_alpha, dtype, gat_dropout)
        self.region_gat = GATNetwork(gat_output_dim, gat_hidden_dim, gat_output_dim, gat_num_heads, gen, 1,
                                     gat_alpha, "dense", dtype, gat_dropout)
        self.detection_head = DetectionHead(init_features + gat_output_dim, gen, fc_hidden_dim, dtype)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.patch_feature_proj.kernel.device

    def _pooled_fast(self, h: int, w: int) -> bool:
        s = self.detection_pre_pool
        return (
            s is not None and h > s and h % s == 0 and w % s == 0
            and h // s == self.patch_size and w // s == self.patch_size
        )

    def forward(self, images: torch.Tensor, gen: Optional[torch.Generator] = None,
                full_res_outputs: bool = False) -> Dict[str, object]:
        if not self.training:
            with torch.no_grad():
                return self._forward(images, None, full_res_outputs)
        if gen is None:
            raise ValueError("train mode draws dropout masks: pass gen, a torch.Generator on the model's device")
        return self._forward(images, gen, full_res_outputs)

    def _forward(self, images: torch.Tensor, gen: Optional[torch.Generator],
                 full_res_outputs: bool) -> Dict[str, object]:
        b, h, w, c_in = images.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} must be a multiple of patch_size={p}")
        if c_in < 3:
            raise ValueError("MinGraphUNet expects >= 3 input bands")
        images = images.to(self.device)
        dt = self.dtype
        acc = torch.promote_types(dt, torch.float32)  # JAX's f32 tensors: f64 in an f64 model

        # Stage 1: U-Net.
        u = self.unet(images, full_res_outputs=full_res_outputs)
        skip0_s2d, f_u0_s2d = u["skip_s2d"].get(0), u["f_u_s2d"].get(0)
        if skip0_s2d is None or f_u0_s2d is None:
            raise NotImplementedError("the port needs U-Net level 0 in s2d layout (even H, W)")

        # Stage 2: patch-node features. Sobel and hist-eq are functions of
        # the input image alone: no gradient reaches them.
        unet_patch = self.patch_feature_proj(s2d_ops.patch_reduce_mean_s2d(skip0_s2d, p))
        with torch.no_grad():
            rgb255 = torch.clamp(
                denormalize(images[..., :3].float(), self.normalization_mean, self.normalization_std), 0.0, 1.0
            ) * 255.0
            sobel_patch = filters.sobel_patch_mean(rgb255, p)
            histeq = filters.equalize_histogram_rgb_batched(
                torch.clamp(torch.round(rgb255), 0, 255).to(torch.uint8)
            ).float()
            histeq_patch = patch_reduce_mean(histeq / 255.0, p)
        patch_feats = torch.cat([unet_patch.to(acc), sobel_patch.to(acc), histeq_patch.to(acc)], dim=-1)

        # Stage 3: patch GAT over the lattice.
        gat_feats = self.patch_gat(patch_feats.to(dt), gen=gen)
        f_unet_patches = self.feature_consistency_proj(s2d_ops.patch_reduce_mean_s2d(f_u0_s2d, p)).to(acc)

        # Stage 4: MinCut partition.
        l_partition, soft_assign = self.mincut(gat_feats, gen=gen)
        hard_labels = torch.argmax(soft_assign, dim=-1)
        nph, npw = gat_feats.shape[1], gat_feats.shape[2]

        # Stage 5: region pooling + region GAT.
        flat_feats = gat_feats.reshape(b, nph * npw, -1).to(acc)
        flat_labels = hard_labels.reshape(b, nph * npw)
        region_feats, region_counts = segment_mean(flat_feats, flat_labels, self.num_segments)
        adj = fully_connected_adjacency(self.num_segments, device=self.device)
        region_embeds = self.region_gat(region_feats.to(dt), adj, gen=gen).to(acc)
        f_g_patch = gather_rows(region_embeds, flat_labels).reshape(b, nph, npw, -1)

        # Stages 6-7: fusion and detection.
        fused = None
        if self._pooled_fast(h, w):
            # The patch mean of f_u[0] beside the patch-constant graph
            # embedding: pooling the fused map with the patch as window.
            pooled_u = s2d_ops.patch_reduce_mean_s2d(f_u0_s2d.to(dt), p)
            det_in = torch.cat([pooled_u, f_g_patch.to(dt)], dim=-1)
            det_pre_pool = None
        else:
            f_u0 = u["f_u"][0] if u["f_u"][0] is not None else s2d_ops.depth_to_space(f_u0_s2d)
            # The embedding is cast before it is broadcast: the same values
            # as JAX's cast of the f32 pixel map, at half its traffic.
            fused = fuse_features([f_u0.to(dt)], broadcast_patch_to_pixels(f_g_patch.to(dt), p), (h, w))
            det_in = fused
            det_pre_pool = self.detection_pre_pool
        bboxes, confidence = self.detection_head(det_in, det_pre_pool, gen)

        out = {
            "logits": u["logits"],
            "patch_feats": patch_feats,
            "gat_feats": gat_feats.to(acc),
            "f_unet_patches": f_unet_patches,
            "l_partition": l_partition,
            "soft_assignments": soft_assign,
            "hard_patch_labels": hard_labels,
            "region_embeddings": region_embeds,
            "region_counts": region_counts,
            "pred_bboxes": bboxes,
            "pred_confidence": confidence,
        }
        if full_res_outputs:
            out["encoder_skips"] = u["skips"]
            out["f_u"] = u["f_u"]
            out["f_g_pixel"] = broadcast_patch_to_pixels(f_g_patch, p)
            if fused is not None:
                out["fused"] = fused
        return out
