"""MinGraphUNet: U-Net → patch features → lattice GAT → MinCut → region GAT
→ fusion → detection. Counterpart of
``mingraph_unet_tpu/models/pipeline.py::MinGraphUNet``, in eval and in train
mode, with the single-box head (class scores when
``num_detection_classes > 1``), the optional dense multi-instance head and
the four ablation switches.

Detection input, decided from the shape as in JAX:

- the pooled path (``detection_pre_pool == H / patch_size == W /
  patch_size``, the serving configuration): the head reads the patch-pooled
  decoder features concatenated with the patch-level graph embeddings, and
  the full-resolution fused map is built only for the dense head;
- the reference-exact path (any other ``detection_pre_pool``, None included,
  the end-to-end trainer's default): ``fuse_features`` concatenates the
  full-resolution decoder features with the graph embeddings broadcast to
  pixels, and the head (after its own average pool when
  ``detection_pre_pool`` is set) runs its convs on that map.

``forward(..., unet_outputs=u)`` skips the U-Net and reads its outputs from
``u``, a dict with the U-Net's keys: ``logits``, level 0's full-resolution
``skips[0]`` and ``f_u[0]``, or their s2d forms ``skip_s2d[0]`` and
``f_u_s2d[0]``, which are pooled as the U-Net's own are (the large-scene
forward, ``train/infer.py::pipeline_forward_large``, runs the U-Net tile by
tile; the spatial-parallel trainer gathers the H-sharded U-Net's outputs,
``parallel/spatial.py::spatial_sharded_unet``).

``model.eval()`` (the default) runs under ``torch.no_grad()`` with the BN
running statistics, and the U-Net's s2d sites launch K1–K3 and K5 on the
card. ``model.train()`` runs the U-Net in train mode (K4 at the s2d conv2s),
the GAT / MinCut / head dropout from the ``gen`` passed to :meth:`forward`,
and updates every BN's running statistics in place to the values flax's
``mutable=["batch_stats"]`` returns; hist-eq and Sobel (functions of the
input image only) stay outside autograd. The dtype casts follow JAX's, so
the same tensors are f32 in a bf16 model (and f64 in an f64 model, a
reference for the f32 one).

``use_batchnorm`` and ``remat`` are the U-Net's (``models/unet.py``);
``sobel_kernel_size`` picks the Sobel patch feature's kernel
(``ops/filters.py::sobel_patch_mean``).

The parameter tree is flax's (``unet/encoder/block0/conv1/kernel``, ...), so
``convert.py`` loads a JAX checkpoint by renaming; an ablation switch that
is off removes its stage's parameters as flax does. A fresh model draws its
weights from ``torch.Generator().manual_seed(seed)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from mingraph_unet_tpu_torch.device import resolve_device
from mingraph_unet_tpu_torch.models.detection import DenseDetectionHead, DetectionHead
from mingraph_unet_tpu_torch.models.fusion import fuse_features
from mingraph_unet_tpu_torch.models.gat import GATNetwork, fully_connected_adjacency
from mingraph_unet_tpu_torch.models.layers import Dense
from mingraph_unet_tpu_torch.models.mincut import MinCutRefinement
from mingraph_unet_tpu_torch.models.unet import UNet
from mingraph_unet_tpu_torch.ops import filters
from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
from mingraph_unet_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD, denormalize
from mingraph_unet_tpu_torch.ops.kernels.pool import decoder_d2s
from mingraph_unet_tpu_torch.ops.patches import broadcast_patch_to_pixels, patch_reduce_mean
from mingraph_unet_tpu_torch.ops.segment import gather_rows, segment_mean
from mingraph_unet_tpu_torch.utils.profiling import span

__all__ = ["MinGraphUNet"]


class MinGraphUNet(nn.Module):
    """The full pipeline. ``forward(images (B, H, W, C) normalized NHWC,
    gen=None)`` returns a dict of tensors (``logits``, ``pred_bboxes``,
    ``pred_confidence``, ``l_partition``, ``soft_assignments``,
    ``hard_patch_labels``, ``gat_feats``, ``f_unet_patches``,
    ``region_embeddings``, ...; ``pred_class_scores`` when
    ``num_detection_classes > 1``; ``dense_objectness_logits`` and
    ``dense_boxes`` with ``use_dense_detection``). ``gen`` (a
    ``torch.Generator`` on the model's device) is required in train mode
    and draws the dropout masks.

    ``device=None`` runs on the CUDA card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch path. ``full_res_outputs=True``
    adds the full-resolution ``encoder_skips``, ``f_u``, ``f_g_pixel`` and,
    where it is built, ``fused``, which nothing after the forward needs
    (about 0.5 GB for ``f_g_pixel`` at 512² b8 f32), so they are not kept
    by default.

    Ablation switches (JAX's, each off removes its stage's parameters):
    ``use_patch_gat=False`` projects the patch features to the GAT width
    (``patch_passthrough_proj``) instead of the lattice GAT;
    ``use_partition=False`` drops MinCut and the region stage (zero
    ``l_partition``, every patch in segment 0, the patch embeddings
    broadcast to pixels); ``use_region_gat=False`` keeps the pooled segment
    means without the region GAT; ``use_fusion=False`` feeds the heads
    ``f_u[0]`` alone."""

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
        num_detection_classes: int = 1,
        use_dense_detection: bool = False,
        use_patch_gat: bool = True,
        use_partition: bool = True,
        use_region_gat: bool = True,
        use_fusion: bool = True,
        in_channels: int = 3,
        use_batchnorm: bool = True,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        if num_segments < 2:
            raise ValueError("num_segments must be at least 2 (the region graph needs two nodes)")
        if sobel_kernel_size % 2 == 0 or sobel_kernel_size < 3:
            raise ValueError(f"sobel_kernel_size={sobel_kernel_size} must be odd and >= 3")
        dev = resolve_device(device)
        self.dtype = dtype
        self.num_classes = num_classes
        self.init_features = init_features
        self.patch_size = patch_size
        self.sobel_kernel_size = sobel_kernel_size
        self.normalization_mean = tuple(normalization_mean)[:3]
        self.normalization_std = tuple(normalization_std)[:3]
        self.num_segments = num_segments
        self.detection_pre_pool = detection_pre_pool
        self.num_detection_classes = num_detection_classes
        self.use_dense_detection = use_dense_detection
        self.use_patch_gat = use_patch_gat
        self.use_partition = use_partition
        self.use_region_gat = use_region_gat
        self.use_fusion = use_fusion
        gen = torch.Generator().manual_seed(seed)
        self.unet = UNet(gen, in_channels, num_classes, init_features, depth, dtype, use_batchnorm, remat)
        self.patch_feature_proj = Dense(init_features, unet_patch_feature_dim, gen, dtype)
        if use_patch_gat:
            self.patch_gat = GATNetwork(unet_patch_feature_dim + 4, gat_hidden_dim, gat_output_dim, gat_num_heads,
                                        gen, gat_num_layers, gat_alpha, "lattice", dtype, gat_dropout,
                                        span="graph.patch_gat")
        else:
            self.patch_passthrough_proj = Dense(unet_patch_feature_dim + 4, gat_output_dim, gen, dtype)
        self.feature_consistency_proj = Dense(init_features, gat_output_dim, gen, dtype)
        if use_partition:
            self.mincut = MinCutRefinement(gat_output_dim, num_segments, gen, sigma_ncut, gat_output_dim // 2,
                                           max(1, gat_num_heads // 2), gat_alpha, dtype, gat_dropout)
            if use_region_gat:
                self.region_gat = GATNetwork(gat_output_dim, gat_hidden_dim, gat_output_dim, gat_num_heads, gen, 1,
                                             gat_alpha, "dense", dtype, gat_dropout, span="graph.region_gat")
        head_in = init_features + gat_output_dim if use_fusion else init_features
        self.detection_head = DetectionHead(head_in, gen, fc_hidden_dim, dtype, num_detection_classes)
        if use_dense_detection:
            self.dense_detection_head = DenseDetectionHead(head_in, gen, patch_size, dtype=dtype)
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
                full_res_outputs: bool = False,
                unet_outputs: Optional[Dict[str, object]] = None) -> Dict[str, object]:
        """``unet_outputs``: precomputed outputs of the U-Net, as its forward
        returns them (``logits``, and level 0 as ``skips[0]`` / ``f_u[0]``
        or as ``skip_s2d[0]`` / ``f_u_s2d[0]``); the U-Net then does not
        run, and its parameters are unused in that call."""
        if not self.training:
            with torch.no_grad():
                return self._forward(images, None, full_res_outputs, unet_outputs)
        if gen is None:
            raise ValueError("train mode draws dropout masks: pass gen, a torch.Generator on the model's device")
        return self._forward(images, gen, full_res_outputs, unet_outputs)

    def _forward(self, images: torch.Tensor, gen: Optional[torch.Generator], full_res_outputs: bool,
                 unet_outputs) -> Dict[str, object]:
        b, h, w, c_in = images.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} must be a multiple of patch_size={p}")
        if c_in < 3:
            raise ValueError("MinGraphUNet expects >= 3 input bands")
        images = images.to(self.device)
        dt = self.dtype
        acc = torch.promote_types(dt, torch.float32)  # JAX's f32 tensors: f64 in an f64 model

        # Stage 1: U-Net. Level 0 in s2d layout is pooled from that layout.
        u = self.unet(images, full_res_outputs=full_res_outputs) if unet_outputs is None else unet_outputs
        logits, skips, f_u = u["logits"], u["skips"], u["f_u"]
        skip0_s2d, f_u0_s2d = u.get("skip_s2d", {}).get(0), u.get("f_u_s2d", {}).get(0)

        # Stage 2: patch-node features. Sobel and hist-eq are functions of
        # the input image alone: no gradient reaches them.
        if skip0_s2d is not None:
            unet_patch = s2d_ops.patch_reduce_mean_s2d(skip0_s2d, p)
        else:
            unet_patch = patch_reduce_mean(skips[0], p)
        unet_patch = self.patch_feature_proj(unet_patch)
        with torch.no_grad(), span("aux"):
            rgb255 = torch.clamp(
                denormalize(images[..., :3].float(), self.normalization_mean, self.normalization_std), 0.0, 1.0
            ) * 255.0
            sobel_patch = filters.sobel_patch_mean(rgb255, p, self.sobel_kernel_size)
            histeq = filters.equalize_histogram_rgb_batched(
                torch.clamp(torch.round(rgb255), 0, 255).to(torch.uint8)
            ).float()
            histeq_patch = patch_reduce_mean(histeq / 255.0, p)
        patch_feats = torch.cat([unet_patch.to(acc), sobel_patch.to(acc), histeq_patch.to(acc)], dim=-1)

        # Stage 3: patch GAT over the lattice (or the ablation's projection).
        if self.use_patch_gat:
            gat_feats = self.patch_gat(patch_feats.to(dt), gen=gen)
        else:
            gat_feats = self.patch_passthrough_proj(patch_feats.to(dt))
        f_u0_patch = (s2d_ops.patch_reduce_mean_s2d(f_u0_s2d, p) if f_u0_s2d is not None
                      else patch_reduce_mean(f_u[0], p))
        f_unet_patches = self.feature_consistency_proj(f_u0_patch).to(acc)
        nph, npw = gat_feats.shape[1], gat_feats.shape[2]
        k = self.num_segments

        if self.use_partition:
            # Stage 4: MinCut partition.
            l_partition, soft_assign = self.mincut(gat_feats, gen=gen)
            # Stage 5: region pooling + region GAT.
            with span("graph.regions"):
                hard_labels = torch.argmax(soft_assign, dim=-1)
                flat_feats = gat_feats.reshape(b, nph * npw, -1).to(acc)
                flat_labels = hard_labels.reshape(b, nph * npw)
                region_feats, region_counts = segment_mean(flat_feats, flat_labels, k)
            if self.use_region_gat:
                adj = fully_connected_adjacency(k, device=self.device)
                region_embeds = self.region_gat(region_feats.to(dt), adj, gen=gen).to(acc)
            else:
                region_embeds = region_feats
            with span("graph.regions"):
                f_g_patch = gather_rows(region_embeds, flat_labels).reshape(b, nph, npw, -1)
        else:
            # No partition: every patch in segment 0, the patch embeddings
            # broadcast to pixels directly.
            zeros = dict(dtype=acc, device=self.device)
            l_partition = torch.zeros((b,), **zeros)
            soft_assign = torch.zeros((b, nph, npw, k), **zeros)
            soft_assign[..., 0] = 1.0
            hard_labels = torch.zeros((b, nph, npw), dtype=torch.long, device=self.device)
            region_embeds = torch.zeros((b, k, gat_feats.shape[-1]), **zeros)
            region_counts = torch.zeros((b, k), **zeros)
            f_g_patch = gat_feats.to(acc)

        # Stages 6-7: fusion and detection. The fused map is built where a
        # head reads it.
        pooled = self._pooled_fast(h, w)
        fused = None
        if not pooled or self.use_dense_detection:
            f_u0 = f_u[0] if f_u[0] is not None else decoder_d2s(f_u0_s2d, self.training)
            if self.use_fusion:
                # The embedding is cast before it is broadcast: the same
                # values as JAX's cast of the f32 pixel map, at half its
                # traffic.
                fused = fuse_features([f_u0.to(dt)], broadcast_patch_to_pixels(f_g_patch.to(dt), p), (h, w))
            else:
                fused = f_u0.to(dt)
        if pooled:
            # The patch mean of f_u[0] beside the patch-constant graph
            # embedding: pooling the fused map with the patch as window.
            pooled_u = (s2d_ops.patch_reduce_mean_s2d(f_u0_s2d.to(dt), p) if f_u0_s2d is not None
                        else patch_reduce_mean(f_u[0].to(dt), p))
            det_in = torch.cat([pooled_u, f_g_patch.to(dt)], dim=-1) if self.use_fusion else pooled_u
            det_pre_pool = None
        else:
            det_in = fused
            det_pre_pool = self.detection_pre_pool
        det = self.detection_head(det_in, det_pre_pool, gen)

        out = {
            "logits": logits,
            "patch_feats": patch_feats,
            "gat_feats": gat_feats.to(acc),
            "f_unet_patches": f_unet_patches,
            "l_partition": l_partition,
            "soft_assignments": soft_assign,
            "hard_patch_labels": hard_labels,
            "region_embeddings": region_embeds,
            "region_counts": region_counts,
            "pred_bboxes": det[0],
            "pred_confidence": det[1],
        }
        if len(det) > 2:
            out["pred_class_scores"] = det[2]
        if self.use_dense_detection:
            dense = self.dense_detection_head(fused)
            out["dense_objectness_logits"] = dense["objectness_logits"]
            out["dense_boxes"] = dense["boxes"]
        if full_res_outputs:
            out["encoder_skips"] = skips
            out["f_u"] = f_u
            out["f_g_pixel"] = broadcast_patch_to_pixels(f_g_patch, p)
            if fused is not None:
                out["fused"] = fused
        return out
