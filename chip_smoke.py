#!/usr/bin/env python3
"""Drive the PyTorch port's serving, large-scene serving, segmentation-training,
end-to-end training, torch.distributed and spatial-parallel training paths,
the model options the trainers take, training on annotated instances, the
paper's evaluations, the command-line entry points, the profiling hooks
and the data layer on image files without OpenCV, on one CUDA card and
check them.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

1. Build the hand-written CUDA kernels from ``mingraph_unet_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) into
   ``mingraph_unet_tpu_torch/build/``, and print each one's registers,
   spills and any ptxas warning that it serializes wgmma instructions
   (fatal for K8, the psel kernels, bf16 and f32, and K2's f32 split
   kernel: their tensor-core paths must not be serialized).
2. Hold each kernel against its plain PyTorch version at the shapes the
   512² b8 serving path gives it, on seeded bf16 inputs. The plain version
   runs in f32 on the same (bf16) inputs; a conv kernel must agree within
   ``CONV_TOL`` of max |plain| (one bf16 rounding of its f32 sum is 2^-9
   relative) over its whole output and again over its border rows and
   columns, the pool bit for bit. The depth-to-space kernel (K5) must be
   bit-equal to its plain version at the serving shape and the large
   scene's two shapes (bf16), in f32 and at an odd shape.
3. Run ``MinGraphUNet(dtype=bfloat16, detection_pre_pool=32)`` at 512² b8
   with seeded weights, perturbed BN running statistics and seeded
   non-constant images. The launch counters must read psel 4, dec-conv1 2,
   pool 2, d2s 1 and hist-eq 1, and every output must be finite. At batch 1 the card's f32
   outputs (TF32 off) must agree with the same port and weights on the CPU
   within ``CPU_TOL`` of max |CPU|. The f32 serving forward at 128² b16
   launches psel 4, dec-conv1 2, pool 2, d2s 1, hist-eq 1, K8 5 and K10's
   narrow forward 2 (the detection head's convs on the pre-pooled map),
   and the profiler's kernel names show every psel launch on the split
   psel kernel and every K2 launch on K2's split kernel.
4. Time the forward (ms/step, images/s, and the host's time to issue a
   step) and each kernel at each shape with CUDA events, beside its plain
   version, its one-call PyTorch counterpart where there is one, and its
   bound on an H100 SXM (3.35 TB/s, 989 bf16 TFLOP/s dense). K1 (and K4
   in phase 6, K9 in phase 12) also gets its device time (torch.profiler:
   the kernel alone, and every device operation of the call), its device
   operations and host µs a call, the library call's device time, and K1
   prints the bytes of weights its tiling moves from L2 a call (worked
   out, not measured, so not in the kernels line). K2 gets its device time the same
   way, its L2 -> SM bytes of weights and halos (worked out, printed only),
   and as context, having no one-call library counterpart, the same
   function by cuDNN (``conv_transpose2d``, ``cat``, ``conv2d``: held
   against K2's plain version within ``CONV_TOL``, timed by events and
   device time). K2's bound counts its least work, 2·17·C² operations a
   full-resolution pixel (the skip taps and the ConvTranspose folded into
   the four live x_prev taps of the pixel's phase). The f32 kernels of
   phase 2 are timed the same way (device operations a call: 1) beside
   their plain version, the full-resolution ``F.conv2d`` in f32 with TF32
   off (channels-last; TF32 on as context) and the split form's bound: f32
   x in and y out at 3.35 TB/s against three bf16 products of 9·C²
   (K2: 17·C²) multiply-adds a full-res pixel at 989 TFLOP/s, with the
   f32 FMA figure (67 TFLOP/s) printed as context.
5. Train the U-Net of the repo's model widths (``configs/model.yaml``: init
   32, depth 4, 2 classes) in bf16 at 512² b8 with the segmentation
   trainer's step (augmentation, CE + Dice, backward, Adam lr 1e-3 weight
   decay 1e-4): 3 warm-up and 10 timed steps. Every step's loss must be
   finite; each step must launch the training conv kernel (K4) 4 times
   forward and 4 times dgrad and K1–K3, K5 and hist-eq never; every parameter must get a
   finite gradient and the BN running statistics must move; on one fixed
   batch without augmentation the loss must fall over 10 steps. At batch
   2, 128², the card's f32 step (TF32 off) must agree with the same step
   in f64 on the CPU, leaf by leaf (see ``_train_vs_cpu``). Then the
   segmentation step as ``configs/*.yaml`` configure it (f32, 128², batch
   16, Adam) for 3 + 10 steps: K4 4 + 4 a step, all 8 on the split kernel
   (profiler), a finite loss and gradients;
   ms/step, host issue ms and peak memory.
6. Hold K4's forward, dgrad and autograd gradients against their plain
   versions at both train shapes, bf16 and f32 (the kernel gradient of
   bf16 inputs within ``DK_TOL``: it is summed and returned in f32), and
   time them and the kernel gradient (PyTorch) beside their bounds; the
   f32 gradients again at 128² b16.
7. Hold the hist-eq kernel (K6) bit for bit against its plain version on
   the orchard-like luma at 512² b8, a constant image, a two-valued image,
   an odd shape (3, 37, 53) and a 1024² scene luma; it must put one device
   operation on the card a call (torch.profiler: no memset, no second
   kernel). Timed at 512² b8 and at the scene (one thread block cluster).
8. Train the end-to-end MinGraphUNet (``PipelineConfig()``: init 32, depth
   4, GAT 128/64 with 4 heads, patch 16, the reference-exact full-resolution
   detection path, fast instancing) in bf16 at 512² b8 with
   ``make_e2e_train_step`` (augmentation, detection trained, Adam lr 1e-3
   weight decay 1e-4): 3 warm-up and 5 timed steps. Every term must be
   finite each step; each step must launch K4 4 + 4 times, hist-eq once and
   K1–K3 and K5 never; every gradient must be finite and the graph branch's
   non-zero; the BN statistics of the U-Net and of the detection head must
   move; on one fixed batch without augmentation the total loss must fall
   over 10 steps. At batch 2, 128², the card's f32 step (TF32 off, dropout
   the identity) must agree with a CPU f64 step that replays its discrete
   decisions, leaf by leaf (``_e2e_vs_cpu``).
9. Serve a 1024² scene (BASELINE config 4 with the dense head):
   ``pipeline_forward_large(MinGraphUNet(dtype=bfloat16,
   detection_pre_pool=32, use_dense_detection=True), scene, tile=512,
   halo=64)`` (the U-Net over four 640² windows, the graph branch once over
   the 64×64 patch lattice) and ``decode_dense_detections(cell_size=16,
   top_k=32)`` on the card. The launch counters must read psel 4,
   dec-conv1 2, pool 2, d2s 2 and hist-eq 1; every output must be finite;
   each valid box must have x1 ≤ x2, y1 ≤ y2, its centre inside the scene
   and its size within the scene's (the decode does not clip, as in JAX),
   and invalid slots zero boxes and scores; the card's decode must equal
   the plain decode on the CPU over the card's own dense outputs, bit for
   bit. Timed (ms/scene, megapixels/s, host issue time, peak memory) and
   profiled. At a 256² scene (tile 128, halo 32), full widths with class
   scores, the card's f32 outputs (TF32 off) must agree with the same port
   and weights on the CPU within ``CPU_TOL`` of max |CPU|, and the hard
   patch labels wherever the top two soft assignments differ by more.
10. Hold the windowed s2d conv (K7) at the eight s2d conv sites of the
   serving U-Net, with the activations one serving forward gives them and
   their BN-folded weights: enc0 conv1 (s2d of the image, 3 → 32), enc0
   conv2, enc1 conv1 (s2d of the pool output, 32 → 64), enc1 conv2, the
   decoder conv1s over [skip ‖ s2d(upsample)] (groups (64, 64) → 64 and
   (32, 32) → 32) and their conv2s. Kernel vs plain within ``CONV_TOL``
   (bf16) and ``F32_TOL`` (f32), whole output and borders; at the conv2
   sites against K1 within ``CONV_TOL``; odd shapes (Cin 5, groups (2, 4),
   Cin 3, odd Cout, odd W/2, H/2 not a multiple of the tile) in both
   dtypes. Timed
   beside its plain version, the dense-s2d ``F.conv2d`` and the op the
   serving forward runs at the site (K1, K2 or the windowed cuDNN conv),
   with the kernel's and the library call's device time (torch.profiler),
   and, on the printed lines only (they are worked out, not measured), the
   windowed form's floor (its 16/9 of the operations at the bf16 rate) and
   the L2 -> SM weight bytes of its tiling against the compulsory bytes.
   The bf16 serving forward, the scene and both trainers launch K7 and K8
   never (the f32 eval forward runs K8 at its standard blocks).
11. Hold the fused ConvBlock (K8) at the five standard-layout ConvBlocks of
   the same forward (enc block2, enc block3, bottleneck, dec block0, dec
   block1) with each block's conv kernels and ``fold_bn`` of its BN: kernel
   vs plain (f32 cuDNN, TF32 off) within ``CONV_TOL``, against the block's
   own bf16 ``ConvBlock.forward`` within ``BLOCK_TOL``, f32 odd shapes
   (Cin 1 and 3, every b1 > 0 in four, every channel tile, and C 1024 and
   600 in several 256-channel tiles) within ``F32_TOL``; timed beside its
   plain version and, as context, the block's two bf16 cuDNN convs, with
   its device time (torch.profiler), its bound (the split form's bf16
   products at 989 TFLOP/s: the kernel computes the f32 function on the
   tensor cores) and, printed only, the f32-FMA figure the SIMT kernel it
   replaced was held to and the weight bytes its tiling moves from L2
   (worked out). Then K8 in f32 as the f32 eval forward calls it, on the
   five blocks' inputs of the f32 serving model at 512² b8 with
   ``ConvBlock.scale_shift``'s arguments: against its plain version (TF32
   off) and the block's ``ConvBlock.forward`` within ``F32_TOL``, timed,
   with its device time and its bound (three bf16 products a term for f32
   x). K7's odd
   shapes include five groups (tensor cores in bf16, SIMT in f32), f32 Cin
   256 (a halo staged in two chunks) and bf16 Cin 512 (128 K chunks).
12. K9 (``psel_conv3x3_halo``) and K2's sharded entry (``dec_conv1_halo``)
   on H-shards in one process: the serving forward's captured L0 (8, 256,
   256, 128) and L1 (8, 128, 128, 256) conv2 inputs (for f32 K9 those of
   the f32 forward of phase 13, with its weights) and both decoder conv1
   sites, cut into 4 equal and 4 uneven shards, each given its neighbours'
   rows by hand. Stitched, they must equal K1 and K2 on the whole tensor
   bit for bit, in bf16 and f32, and the plain versions within
   ``CONV_TOL`` / ``F32_TOL``. One inner shard is timed, bf16 and f32,
   beside its bound, the plain version, the JAX form (concat + K1 + slice)
   and the library's dense-s2d ``F.conv2d`` on the extended shard, each by
   CUDA events and by device time, with K9's L2 -> SM weight bytes worked
   out from its tiling (printed only).
13. The torch.distributed paths over NCCL in a group of one rank (the card
   machine has one card): ``spatial_sharded_apply`` of the serving U-Net
   at 512² b8 bf16 against the unsharded forward within ``CONV_TOL`` of
   max |logits| (in f32, TF32 off, within ``F32_TOL``), bit-equal to K1 / K2 at each K9 / sharded-K2 site on the
   inputs it got, launching K9 4, sharded K2 2, pool 2, d2s 1 and K1, K2
   never; one data-parallel segmentation step and one e2e step (bf16 512²
   b8) against the one-card steps within 1e-3 of each loss, gradient and
   BN statistic, launching K4 4 + 4 (and hist-eq 1) as before. Each step
   is then timed against the one-card step and against itself with its
   NCCL calls made no-ops (24 steps a side in chunks of 3, interleaved,
   median chunk), both are profiled (the kernels and host ops the
   data-parallel step adds are printed), the host and card time of one
   all-reduce and of the flat gradient all-reduce are timed, and a
   collective issued behind a long kernel shows whether it holds the host. Every earlier path launches K9 and sharded K2 never.
14. Spatial-parallel training, the spatial train path: the segmentation and
   the e2e train step (512² b8, bf16 and f32) made on a one-rank NCCL mesh with
   their spatial switch set on (one card holds no spatial axis of two
   ranks), so that the U-Net runs on its one H-shard through every sharded
   train site and its outputs go through the gather; each step must launch
   K4 on a shard 4 forward and 4 dgrad (hist-eq once in e2e; in f32 all
   8 on the split kernel by the profiler's names), K4 itself and K1-K3
   never, and agree with the one-card step within 1e-3. Then K4
   on H-shards (``psconv_fwd_halo``, ``psconv_dgrad_halo``) at the train
   shapes L0 (8, 256, 256, 128) and L1 (8, 128, 128, 256), bf16 and f32,
   on 4 equal and 4 uneven shards cut in one process with the halo rows by
   hand: the stitched forward and dx bit-equal to K4 (``psconv_fwd``,
   ``psconv_dgrad``) on the whole tensor, directly and through the autograd
   Function ``psconv_train_halo``, the shards' kernel gradients summed
   within ``DK_TOL`` of the whole one; one inner shard's forward and dgrad
   timed beside their bound, the plain version, the library's dense-s2d
   ``F.conv2d`` and the unsharded K4's device time over 4, with the host's
   µs a call (``time.perf_counter`` over ``HOST_CALLS`` calls issued with
   no sync) and the device operations a call, which must be 1: the kernel
   lays out the raw weights itself. Every earlier path launches K4 on a
   shard never.
15. The model options the trainers take, at ``PipelineConfig()`` widths in
   bf16 at 512² b8: (a) the e2e step with the dense detection head, trained
   on connected-component ground truth (fast instancing): 3 warm-up and 5
   timed steps, every term (``l_dense_obj``, ``l_dense_box`` too) finite,
   K4 4 + 4 and hist-eq 1 a step and K1-K3, K5 never, a non-zero gradient
   in every leaf of the dense head, a total that falls over 10 steps on a
   fixed batch, the stencil CC's calls a step and device operations a call;
   at 128² b2 the card's f32 step against the CPU f64 step that replays its
   decisions, under fast and exact instancing. (b) Each ablation variant
   (``ABLATION_VARIANTS``), ``use_fusion=False`` and class scores: 2 steps
   each, the launches as in (a), a finite, non-zero gradient in every leaf
   the total reaches. (c) The U-Net without BN: the serving forward
   (launches psel 4, dec-conv1 2, pool 2, d2s 1, hist-eq 1; batch-1 f32 vs
   CPU within ``CPU_TOL``) and the segmentation step (K4 4 + 4; 128² b2 vs
   the CPU f64 step). (d) Remat: one segmentation and one e2e step with
   ``remat=True`` against the same step without, from the same weights,
   batch and generator: losses, gradients and BN statistics within 1e-3,
   the running statistics equal; K4's launches a step and both steps' peak
   memory and time printed, the segmentation step's peak lower with remat.
   (e) ``sobel_kernel_size`` 5 and 7 in the serving forward as (c). (f)
   Phase 14's spatial e2e step at one NCCL rank with the dense head on,
   against the one-card step within 1e-3. The kernels line gives each
   kernel's launches on these paths (``launches_options``).
16. Annotated training and the paper's evaluations, at ``PipelineConfig()``
   widths with the dense head, bf16 512² b8, ``max_instances`` 16: (a) the
   e2e step on seeded instance masks (8, 16, 512, 512) of rotated ellipses
   drawn with torch (between 8 and 16 an image), the mask their union: 3
   warm-up and 5 timed steps, every term finite, K4 4 + 4 and hist-eq 1 a
   step, K1-K3 and K5 never, no connected-component call (phase 15 (a)
   makes 2 a step), a non-zero gradient in every dense-head leaf, a total
   that falls over 10 steps on a fixed batch, the augmented instances
   inside their warped mask; timed beside phase 15 (a)'s step; at 128² b2
   with the uncertainty balancer the card's f32 step against the CPU f64
   step that replays its decisions (``_e2e_vs_cpu``). (b) (a)'s weights
   saved by the port's checkpoint manager and read back by
   ``load_variables``; each detector's device function
   (``segmentation_count_detect`` for ``unet``, ``mingraph-unet`` and
   ``mingraph-unet-refined``, ``dense_head_detect``) at batch 1 on 8
   seeded 512² images: launches a forward psel 4, dec-conv1 2, pool 2 and
   d2s 1 for the U-Net (its level-1 handoff), d2s 2 and hist-eq 1 for the
   MinGraph-UNet forms (``f_u[0]`` at full resolution, as the dense head
   and the config's full-resolution fusion need it), the dense decode and
   the CC instancing equal to the plain ones on the CPU over the card's own
   outputs (boxes and areas bit for bit), finite yield metrics and AP,
   images/s; ``evaluate_segmentation_model``'s forward at batch 8 for the
   three forms (the same launches, finite Table-1 metrics) and
   ``region_blend_logits`` against the CPU within ``F32_TOL``. (c) The C++
   PNG loader built with g++ and held bit for bit against 8 RGB and 8 gray
   512² PNGs written by the package's zlib + struct writer
   (``data/png.py``, every row filter). The kernels line gives each kernel's launches on (a) and (b)
   (``launches_annotated``).
17. The CLIs, in process through each ``main(argv)`` without ``--cpu``,
   at ``configs/*.yaml``'s widths (U-Net init 32, depth 4; patch 16; GAT
   128/64, 4 heads; f32, as ``training.yaml`` says): two config
   directories read from ``configs/`` and written back by the port's YAML
   code (512², batch 8, one epoch, their own checkpoint and log
   directories), 16 orchard-like RGB 512² PNGs with masks, a 512² image and
   a 1024² scene written by ``data/png.py``. ``train_segmentation`` and
   ``train_end_to_end`` (2 steps each): every batch decoded by the C++
   loader, K4 4 + 4 a step (and hist-eq 1 in e2e) and nothing else, a
   finite epoch loss, the checkpoint read back bit-equal to the trained
   weights; ``infer_segmentation`` on the image and with ``--large_scene
   --tile 512 --halo 64`` on the scene: psel 4, dec-conv1 2, pool 2, d2s 1
   (the four 640² windows in one forward), the label PNG decoded by the C++
   loader equal to the labels returned; ``graph_refinement``: hist-eq 1, a
   finite L_partition; no CLI imports OpenCV. Then ``setup_host()`` and
   ``trace_if`` around 5 serving forwards (as phase 3), ``parse_device_trace``
   and ``attribute_stages``: each hand-written kernel in the rows as often
   a forward as its counter says, from its wrapper's frame, in a stage; the
   stage sums equal to the rows' total; ``StepTimer`` within 5% of CUDA
   events. Prints each CLI's wall seconds and peak memory and the training
   images/s; the kernels line gives each kernel's launches a step (a call)
   of each CLI and of the traced forward (``launches_cli``).
18. The data layer on files, without OpenCV: the phase runs with
   ``sys.modules["cv2"] = None``, so that ``import cv2`` fails there
   whether or not the machine has OpenCV (it says which), and fails if an
   earlier phase or the data layer imported it; at
   ``configs/*.yaml``'s widths: (a) every fixture of ``tests/fixtures/jpeg``
   (the 1024×768 scene JPEG, grey, 4:4:4, 4:2:2, progressive, restart,
   EXIF-rotated and odd-sized JPEGs, a 16-bit and an interlaced PNG)
   decoded by the port (``data/native_loader.py::decode``) in colour and
   grey, each array's SHA-256 equal to that of ``cv2.imread``'s recorded
   in the fixtures' manifest; the scene's decode rate on one thread and
   ``load_batch`` on 4 threads into 8 × 512². (b)
   ``generate_orchard_dataset`` writes 16 scenes of 512² (images/s), and
   the seeded 512² scene's mask and instance list equal the JAX
   generator's digests in the manifest. (c) ``train_end_to_end`` (its CLI)
   on 8 copies of the scene JPEG with a COCO file of its fruit polygons
   (written from the committed ``scene.json``), bf16, the dense head,
   512² b8, 2 epochs of one step: both batches decoded by the thread pool
   with OpenCV's semantics, K4 4 + 4 and hist-eq 1 a step and nothing
   else, finite losses. (d) ``infer_segmentation`` on the scene JPEG with
   seeded U-Net weights, then with ``--large_scene --tile 512 --halo 64``
   (four windows of the 768×1024 scene in one forward): psel 4, dec-conv1
   2, pool 2, d2s 1 each, the label PNG equal to the labels returned. (e)
   The four CLIs with no arguments (their ``make_dummy_run`` smoke runs)
   and ``run_results --quick`` end to end on the card: Tables 1-3 finite.
   Prints each call's wall seconds and peak memory, the decode and
   generation rates; the kernels line gives each kernel's launches a step
   (a call) of (c) and (d) (``launches_data``).
19. The split-form train conv (K10, ``ops/kernels/conv3x3.py``) in the
   f32 U-Net step of the ``unet_f32.train_b16`` cell (512², batch 16, TF32
   off; run after phase 6): K10 forward 10 and dgrad 10 launches a step
   (20 forward with remat), K4 4 + 4 and nothing else; at the ten
   standard-block convs, on the inputs, weights and cotangents one step
   gives them, forward and dgrad against their plain versions (cuDNN f32)
   within ``F32_TOL``, timed beside the plain version, the library call
   and the split form's bound; the step's time and its levels 2-4 device
   ms by pass, with those convs on cuDNN (before) and on K10 (after)
   (``_conv3x3_path``). Then the end-to-end step of the
   ``mgu_e2e_f32.e2e_b16`` cell (512², batch 16, the full-resolution
   detection head): K10 12 + 12 a step, of them the narrow tile 2 + 2 at
   the head's convs (96 → 48 → 24) and the wide tile 10 + 10; the head's
   two convs held and timed as the standard sites are (with the bound of
   the work padded to the wide tile beside it); the step with the head's
   convs on cuDNN and on K10, the head's forward, K10 dgrad and
   ``convolution_backward`` (dW, or dX and dW) device ms by operation
   (``_k10_head_path``). The phases that run an f32 train step (5, 17)
   expect K10's 10 + 10 a step (the e2e CLI 12 + 12).

It prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``. It also prints the
forward's and the train step's device time by kernel (torch.profiler) and
their busy shares.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

BATCH, SIZE = 8, 512
SCENE, TILE, HALO = 1024, 512, 64   # the large-scene cell (BASELINE config 4)
CONV_TOL = 1e-2      # kernel (bf16 out) vs plain (f32) on bf16 inputs, of max |plain|
CPU_TOL = 1e-3       # card f32 vs CPU f32 (forward at batch 1) and vs CPU f64 (train step at batch 2)
F32_TOL = 1e-4       # an f32 kernel vs its plain version, TF32 off, of max |plain|
DK_TOL = 5e-4        # K4's kernel gradient of bf16 inputs vs plain f32 on the same values, of max |plain|;
#                      a result rounded to bf16 is off by up to 2^-9 (2e-3) of an entry
BLOCK_TOL = 2e-2     # K8 (f32 inside) vs the model's bf16 ConvBlock.forward, of max |block|: the block
#                      rounds its folded weights, conv1's sum, h and conv2's sum to bf16 (2^-9 each)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_SIMT_FLOPS = 67e12
FORWARD_ITERS, KERNEL_ITERS = 20, 20
HOST_CALLS = 200     # calls issued back to back for a wrapper's host µs a call
K8_ITERS = 3         # K8's plain version (f32 cuDNN, TF32 off): up to ~27 ms a call
TRAIN_WARMUP, TRAIN_ITERS, FIXED_BATCH_STEPS = 3, 10, 10
E2E_WARMUP, E2E_ITERS = 3, 5
OPTION_STEPS = 2     # phase 15 (b), (c): steps of each model option
SCENE_WARMUP, SCENE_ITERS = 2, 10
DP_ROUNDS, DP_STEPS, DP_PROFILE_STEPS, DP_TOP = 4, 3, 3, 8   # phase 13: data-parallel vs one-card steps
SPIN_CYCLES = 100_000_000   # ~50 ms of card clock: phase 13's test of whether a collective holds the host
SCENE_CPU_SEED = 13
LR, WEIGHT_DECAY = 1e-3, 1e-4

PSCONV_SRC = "mingraph_unet_tpu/ops/pallas/psconv.py"
POOL_SRC = "mingraph_unet_tpu/ops/pallas/pool.py"
HISTEQ_SRC = "mingraph_unet_tpu/ops/pallas/histeq.py"
WCONV_SRC = "mingraph_unet_tpu/ops/pallas/wconv.py"
CONV_BLOCK_SRC = "mingraph_unet_tpu/ops/pallas/conv_block.py"
# Phase 19: K10 (the split-form train conv) in the f32 U-Net step of the
# unet_f32.train_b16 cell (512², batch 16): its launches a step, and the ten
# standard-block convs it runs, in forward order.
K10_STEP = {"k10_fwd": 10, "k10_dgrad": 10}
K10_BATCH, K10_STEPS = 16, 3
K10_SITES = ("enc2 conv1", "enc2 conv2", "enc3 conv1", "enc3 conv2", "bottleneck conv1", "bottleneck conv2",
             "dec3 conv1", "dec3 conv2", "dec2 conv1", "dec2 conv2")
K10_LEVELS = ("mgu.unet.enc2", "mgu.unet.enc3", "mgu.unet.bottleneck", "mgu.unet.dec3", "mgu.unet.dec2")
# ... and in the end-to-end step of the mgu_e2e_f32.e2e_b16 cell (512², batch
# 16, the full-resolution detection head): the head's two convs on K10's
# narrow tile besides the ten standard ones, a step.
K10_E2E_STEP = {"k10_fwd": 12, "k10_dgrad": 12}
K10_HEAD_SITES = ("head conv1", "head conv2")
K10_NARROW = re.compile(r"conv3x3_kernel<(24|48|96)>")


def _fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, by CUDA events after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _wrappers():
    """Every kernel wrapper of the port, by the name its launch count goes
    under."""
    from mingraph_unet_tpu_torch.ops.kernels import conv3x3, conv_block, histeq, pool, psconv, wconv

    return {"psel": psconv.psel_conv3x3, "dec1": psconv.dec_conv1_fused, "pool": pool.phase_max_pool_kernel,
            "d2s": pool.depth_to_space_kernel, "k4_fwd": psconv.psconv_fwd, "k4_dgrad": psconv.psconv_dgrad,
            "histeq": histeq.equalize_channel, "wconv": wconv.wconv3x3_s2d, "conv_block": conv_block.fused_conv_block,
            "k9": psconv.psel_conv3x3_halo, "dec1_halo": psconv.dec_conv1_halo,
            "k4_fwd_halo": psconv.psconv_fwd_halo, "k4_dgrad_halo": psconv.psconv_dgrad_halo,
            "k10_fwd": conv3x3.conv3x3_fwd, "k10_dgrad": conv3x3.conv3x3_dgrad}


def _reset_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0


def _counts():
    return {k: w.launches for k, w in _wrappers().items()}


def _edge(t):
    """The border rows and columns of an NHWC tensor, flattened, in f32."""
    import torch

    return torch.cat([e.flatten() for e in (t[:, 0], t[:, -1], t[:, :, 0], t[:, :, -1])]).float()


def _check_close(name: str, got, ref, tol: float, border: bool = True, what: str = "its plain version") -> float:
    """``got`` within ``tol`` of max |ref| over the whole tensor and, with
    ``border``, again over its border rows and columns against their own
    scale; fatal otherwise. Returns the max abs error."""
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = err <= tol * scale and bool(torch.isfinite(got.float()).all())
    msg = f"max_abs_err {err:.6g} (rel {err / max(scale, 1e-30):.3g}), tolerance {tol} * max|plain| = {tol * scale:.4g}"
    if border:
        b_err = (_edge(got) - _edge(ref)).abs().max().item()
        b_scale = _edge(ref).abs().max().item()
        ok = ok and b_err <= tol * b_scale
        msg += f"; border {b_err:.6g} vs {tol * b_scale:.4g}"
    print(f"[chip_smoke] {name}: {msg}: {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"{name} disagrees with {what}")
    return err


def _kernel_cases(dev):
    """Main-path inputs of each kernel (bf16, seeded), with the bytes it must
    move and the least operations its function needs. Biases are drawn at
    unit scale, so a fault in dec-conv1's border class table stands well
    above the tolerance."""
    import torch

    from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
    from mingraph_unet_tpu_torch.ops.kernels import psconv

    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale  # noqa: E731
    b, cases = BATCH, []
    for lvl, c in ((0, 32), (1, 64)):
        hh = SIZE // 2 ** (lvl + 1)
        full_px = b * (2 * hh) ** 2
        x = rnd(b, hh, hh, 4 * c).to(torch.bfloat16)
        k, bias = rnd(3, 3, c, c, scale=(1.0 / (9 * c)) ** 0.5), rnd(c)
        cases.append(dict(
            kind="psel", level=lvl, args=(x, k, bias),
            bytes=2 * x.numel() * 2 + k.numel() * 2 + bias.numel() * 4,
            ops=2 * full_px * 9 * c * c, rate=BF16_TENSOR_FLOPS,
        ))
        cp = 2 * c  # x_prev: the deeper level's output, twice the channels
        x_skip, x_prev = rnd(b, hh, hh, 4 * c).to(torch.bfloat16), rnd(b, hh, hh, cp).to(torch.bfloat16)
        kernel = rnd(3, 3, 2 * c, c, scale=(1.0 / (18 * c)) ** 0.5)
        kt, bias_up = rnd(2, 2, cp, c, scale=(1.0 / (4 * cp)) ** 0.5), rnd(c)
        k_skip, k_prev = psconv.dec_conv1_weights(kernel, c, s2d_ops.s2d_convt2x2_kernel(kt))
        t9 = psconv.dec_conv1_bias_table(kernel, c, bias_up, bias)
        cases.append(dict(
            kind="dec1", level=lvl, args=(x_skip, x_prev, k_skip, k_prev, t9), unfolded=(kernel, bias, kt, bias_up),
            bytes=(x_skip.numel() + x_prev.numel() + x_skip.numel()) * 2
            + (k_skip.numel() + k_prev.numel()) * 2 + t9.numel() * 4,
            # Least work: the skip taps (9 c² a full-res pixel) and, of the
            # ConvTranspose folded into x_prev's taps, the 4 live taps of the
            # pixel's phase (4 · 2c · c): 17 c², less than the explicit
            # ConvTranspose then the conv over [skip ‖ up] (20 c²).
            ops=2 * full_px * 17 * c * c,
            rate=BF16_TENSOR_FLOPS,
        ))
        y = rnd(b, hh, hh, 4 * c).to(torch.bfloat16)
        cases.append(dict(
            kind="pool", level=lvl, args=(y,),
            bytes=y.numel() * 2 + y.numel() // 4 * 2,
            ops=3 * y.numel() // 4, rate=F32_SIMT_FLOPS,
        ))
    return cases


def _kernel_table(dev, launches, scene_launches):
    """Phases 2 and 4 for the kernels: compare with the plain version, time."""
    import torch
    import torch.nn.functional as F

    from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
    from mingraph_unet_tpu_torch.ops.kernels import pool, psconv

    meta = {
        "psel": ("psel_conv3x3", "mingraph_unet_tpu_torch/csrc/psel_conv.cu", f"{PSCONV_SRC}:258",
                 psconv.psel_conv3x3, psconv.psel_conv3x3_plain),
        "dec1": ("dec_conv1_fused", "mingraph_unet_tpu_torch/csrc/dec_conv1.cu", f"{PSCONV_SRC}:599",
                 psconv.dec_conv1_fused, psconv.dec_conv1_fused_plain),
        "pool": ("phase_max_pool", "mingraph_unet_tpu_torch/csrc/phase_pool.cu", f"{POOL_SRC}:72",
                 pool.phase_max_pool_kernel, s2d_ops.phase_max_pool),
    }
    rows = []
    for case in _kernel_cases(dev):
        name, source, replaces, kernel_fn, plain_fn = meta[case["kind"]]
        args = case["args"]
        got = kernel_fn(*args)
        ref = plain_fn(*[a.float() if a.dtype == torch.bfloat16 else a for a in args])
        torch.cuda.synchronize()
        shape = tuple(args[0].shape)
        tag = f"{name} L{case['level']} {shape}"
        if case["kind"] == "pool":
            err = (got.float() - ref.float()).abs().max().item()
            ok = torch.equal(got, ref.to(got.dtype))
            print(f"[chip_smoke] {tag}: max_abs_err {err:.6g}, tolerance bit-equal: {'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"{name} at L{case['level']} disagrees with its plain version")
        else:
            # Whole output, then the border rows and columns (where the
            # padding and dec-conv1's class table act) against their own scale.
            err = _check_close(tag, got, ref, CONV_TOL)
        ms = _time_ms(lambda: kernel_fn(*args), KERNEL_ITERS)
        plain_ms = _time_ms(lambda: plain_fn(*args), KERNEL_ITERS)
        if case["kind"] == "psel":
            x, k, _ = args
            w = s2d_ops.s2d_conv3x3_kernel(k).to(x.dtype).permute(3, 2, 0, 1).contiguous()
            xn = x.permute(0, 3, 1, 2)
            library_ms = _time_ms(lambda: F.conv2d(xn, w, padding=1), KERNEL_ITERS)
        elif case["kind"] == "pool":
            y = args[0]
            library_ms = _time_ms(lambda: y.view(*y.shape[:3], 4, y.shape[3] // 4).amax(dim=3), KERNEL_ITERS)
        else:
            library_ms = None
        t_bytes = case["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = case["ops"] / case["rate"] * 1e3
        extra = {}
        if case["kind"] == "dec1":
            # The card's time of the kernel alone and of the call, and as
            # context (no one-call library) the same function by cuDNN.
            call_ms, dev_ms = _device_ms(tag, lambda: kernel_fn(*args), own="dec1_wgmma_kernel")
            cudnn = _dec1_cudnn(args[0], args[1], *case["unfolded"])
            c_err = _check_close(f"{tag} cuDNN route", _s2d_of(cudnn().relu()), ref, CONV_TOL, what="K2's plain version")
            cudnn_ms = _time_ms(cudnn, KERNEL_ITERS)
            cudnn_dev_ms = _device_ms(f"{tag} cuDNN route", cudnn)
            extra = {"device_ms": dev_ms, "call_device_ms": call_ms, "context_cudnn_route_ms": cudnn_ms,
                     "context_cudnn_route_device_ms": cudnn_dev_ms}
            print(f"[chip_smoke] {name} L{case['level']}: device {dev_ms * 1e3:.1f} us (call {call_ms * 1e3:.1f}); "
                  f"cuDNN route (conv_transpose2d, cat, conv2d: 3 calls, ReLU not counted; max_abs_err {c_err:.4g}) "
                  f"{cudnn_ms * 1e3:.1f} us, device {cudnn_dev_ms * 1e3:.1f} us; L2 -> SM (from the tiling) "
                  f"{_dec1_l2_bytes(shape, dev) / 1e6:.1f} MB a call against {case['bytes'] / 1e6:.1f} MB compulsory")
        if case["kind"] == "pool":
            dev_ms = _device_ms(tag, lambda: kernel_fn(*args))
            extra = {"device_ms": dev_ms}
            print(f"[chip_smoke] {name} L{case['level']}: device {dev_ms * 1e3:.1f} us")
        if case["kind"] == "psel":
            # The card's time: the kernel alone, and the call (every device
            # operation of it); the host's; the weights it moves L2 -> SM.
            call_ms, dev_ms, dev_ops = _device_ms(tag, lambda: kernel_fn(*args), own="psel_wgmma_kernel", count=True)
            host_us = _host_us(lambda: kernel_fn(*args))
            lib_dev_ms = _device_ms(f"{tag} library", lambda: F.conv2d(xn, w, padding=1))
            extra = {"device_ms": dev_ms, "call_device_ms": call_ms, "library_device_ms": lib_dev_ms,
                     "host_us": host_us, "device_ops": dev_ops}
            print(f"[chip_smoke] {name} L{case['level']}: device {dev_ms * 1e3:.1f} us (call {call_ms * 1e3:.1f} in "
                  f"{dev_ops} operations), host {host_us:.1f} us a call, library device {lib_dev_ms * 1e3:.1f} us; "
                  f"weights L2 -> SM (from the tiling) {_psel_weight_l2_bytes(shape, dev, k.element_size()) / 1e6:.2f}"
                  f" MB a call against {case['bytes'] / 1e6:.1f} MB compulsory")
        rows.append({
            "name": f"{name} L{case['level']}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[case["kind"]],
            "launches_scene": scene_launches[case["kind"]],
            "shape": list(shape),
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            **extra,
        })
        print(f"[chip_smoke] {name} L{case['level']}: {ms * 1e3:.1f} us/launch, plain {plain_ms * 1e3:.1f} us, "
              f"library {'-' if library_ms is None else f'{library_ms * 1e3:.1f} us'}, "
              f"bound {max(t_bytes, t_ops) * 1e3:.1f} us ({rows[-1]['bound_by']})")
    return rows


def _images(b: int, size: int, seed: int):
    """Seeded normalized NHWC images: a disc on a background, plus noise."""
    import torch

    g = torch.Generator().manual_seed(seed)
    base = torch.rand((b, 1, 1, 3), generator=g)
    fg = torch.rand((b, 1, 1, 3), generator=g)
    cy, cx = (torch.rand((2, b, 1, 1), generator=g) * 0.6 + 0.2) * size
    yy, xx = torch.meshgrid(torch.arange(size), torch.arange(size), indexing="ij")
    disc = (((yy - cy) ** 2 + (xx - cx) ** 2) < (0.3 * size) ** 2)[..., None]
    img = (torch.where(disc, fg, base) + 0.05 * torch.randn((b, size, size, 3), generator=g)).clamp(0, 1)
    mean = torch.tensor([0.485, 0.456, 0.406])
    std = torch.tensor([0.229, 0.224, 0.225])
    return (img - mean) / std


def _perturb_bn(model, seed: int) -> None:
    """Random running means and positive variances, so the BN fold is real."""
    import torch

    g = torch.Generator().manual_seed(seed)
    for name, buf in model.named_buffers():
        if name.endswith(".mean"):
            buf.copy_(torch.randn(buf.shape, generator=g) * 0.2)
        elif name.endswith(".var"):
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)


def _serving_model(dev, dtype=None, **options):
    """The serving configuration (with the model ``options``; bf16 unless
    ``dtype`` says otherwise) with seeded weights, perturbed BN running
    statistics, and its seeded batch of images."""
    import torch

    from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet

    model = MinGraphUNet(dtype=dtype or torch.bfloat16, detection_pre_pool=32, device=dev, seed=0, **options)
    _perturb_bn(model, seed=1)
    return model, _images(BATCH, SIZE, seed=2).to(dev)


def _main_path(dev, label: str = "main path", **options):
    """Phase 3: the serving forward through the kernels, then batch-1 card
    vs CPU (phase 15: with the model ``options``). Returns (model, images,
    launch counts)."""
    import torch

    from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet

    model, x = _serving_model(dev, **options)

    _reset_counts()
    out = model(x)
    torch.cuda.synchronize()
    launches = _counts()
    print(f"[chip_smoke] {label} launches: {launches}")
    if launches != {"psel": 4, "dec1": 2, "pool": 2, "d2s": 1, "k4_fwd": 0, "k4_dgrad": 0, "histeq": 1,
                    "wconv": 0, "conv_block": 0, "k9": 0, "dec1_halo": 0,
                    "k4_fwd_halo": 0, "k4_dgrad_halo": 0, "k10_fwd": 0, "k10_dgrad": 0}:
        _fail(f"{label}: expected psel 4, dec1 2, pool 2, d2s 1, histeq 1 and no K4, K7, K8, K9 or sharded K2 "
              f"launches per forward, got "
              f"{launches}")
    expect = {"logits": (BATCH, SIZE, SIZE, 2), "pred_bboxes": (BATCH, 4), "pred_confidence": (BATCH, 1),
              "l_partition": (BATCH,), "soft_assignments": (BATCH, SIZE // 16, SIZE // 16, 2)}
    for k, shape in expect.items():
        if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
            _fail(f"{k}: shape {tuple(out[k].shape)} (expected {shape}) or non-finite values")
    print(f"[chip_smoke] bf16 {BATCH}x{SIZE}^2 outputs finite; counts per segment "
          f"{out['region_counts'].sum(0).tolist()}")

    # Batch 1, f32: the card (TF32 off) against the same port on the CPU.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state = {k: v.float().cpu() for k, v in model.state_dict().items()}
    card = MinGraphUNet(dtype=torch.float32, detection_pre_pool=32, device=dev, **options)
    cpu = MinGraphUNet(dtype=torch.float32, detection_pre_pool=32, device="cpu", **options)
    card.load_state_dict(state)
    cpu.load_state_dict(state)
    x1 = _images(1, SIZE, seed=4)  # both segments populated, top-2 margin ~1e-3 on CPU
    t0 = time.perf_counter()
    o_cpu = cpu(x1)
    o_card = card(x1.to(dev))
    torch.cuda.synchronize()
    soft = o_cpu["soft_assignments"].topk(2, dim=-1).values
    margin = (soft[..., 0] - soft[..., 1]).min().item()
    labels_equal = torch.equal(o_cpu["hard_patch_labels"], o_card["hard_patch_labels"].cpu())
    print(f"[chip_smoke] {label} batch-1 f32 card vs CPU ({time.perf_counter() - t0:.1f}s): "
          f"hard labels equal {labels_equal}, min top-2 margin {margin:.3g}")
    for k in ("logits", "pred_bboxes", "pred_confidence", "l_partition"):
        ref, got = o_cpu[k], o_card[k].cpu()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        ok = err <= CPU_TOL * max(scale, 1e-6)
        print(f"[chip_smoke]   {k}: max_abs_err {err:.3g}, tolerance {CPU_TOL} * max|cpu| = "
              f"{CPU_TOL * scale:.3g}: {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"{label}: card and CPU disagree on {k}")
    torch.backends.cudnn.allow_tf32 = True
    del card, cpu
    return model, x, launches


def _forward_time(model, x):
    """Phase 4: ms/step of the bf16 serving forward, consuming the outputs
    (as bench.py does: logits, confidence and boxes summed)."""
    import torch

    sink = torch.zeros((), device=x.device)

    def step():
        out = model(x)
        sink.add_(out["logits"].sum() + out["pred_confidence"].sum() + out["pred_bboxes"].sum())

    for _ in range(3):
        step()
    torch.cuda.reset_peak_memory_stats()
    ms = _time_ms(step, FORWARD_ITERS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # Host time to issue one step (the card is idle when this reaches ms/step).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FORWARD_ITERS):
        step()
    host_ms = (time.perf_counter() - t0) * 1e3 / FORWARD_ITERS
    torch.cuda.synchronize()
    print(f"[chip_smoke] forward bf16 {BATCH}x{SIZE}^2: {ms:.3f} ms/step, {BATCH / ms * 1e3:.1f} images/s, "
          f"host issue time {host_ms:.3f} ms/step, peak memory {peak:.2f} GiB")
    return ms


def _psel_weight_l2_bytes(shape, dev, weight_bytes: int) -> int:
    """Bytes of weights the bf16 psel kernel (K1, K4, K9) moves from L2 into
    shared memory a call, worked out from its tiling in
    ``csrc/psel_conv.cu``, not read from the card: the raw 9·C·C kernel
    (``weight_bytes`` a weight: 4 for an f32 parameter), staged by bulk
    copies and laid out by the block, once a block of its persistent grid,
    min(tiles, SMs) blocks over tiles of TH × 16 s2d pixels (TH 8 at C = 32,
    4 at C = 64)."""
    import torch

    b, hh, ww, c4 = shape
    c = c4 // 4
    th = 8 if c == 32 else 4
    tiles = b * -(-hh // th) * -(-ww // 16)
    return min(tiles, torch.cuda.get_device_properties(dev).multi_processor_count) * 9 * c * c * weight_bytes


def _wconv_weight_l2_bytes(shape, packed) -> int:
    """Bytes of weights the bf16 K7 kernel moves from L2 into shared memory
    a call, worked out from its tiling in ``csrc/wconv.cu``, not read from
    the card: every block tile (8 × 16 s2d pixels at N = 256, 16 × 16 below)
    of every column block loads each chunk's 4 × 16 × N slab once, so the
    call moves its packed weights (``wgmma_weight_chunks``: column blocks,
    chunks, 4, N/8, 2, 8, 8) once a tile position."""
    b, hh, ww, _ = shape
    th = 8 if packed.shape[3] == 32 else 16
    return b * -(-hh // th) * -(-ww // 16) * packed.numel() * 2


def _dec1_l2_bytes(shape, dev) -> int:
    """Bytes of live weights and halos the bf16 K2 kernel moves from L2 into
    shared memory a call, worked out from its tiling in
    ``csrc/dec_conv1.cu``, not read from the card: 4 × 16 s2d tiles, each
    tile's two halos (6 × 18 pixels of 4C + 2C channels) once (at C = 64
    once a cluster of four blocks, by multicast), and the live weights once
    a block: all of them (9C² + 32C²) on min(tiles, SMs) blocks at C = 32,
    W_skip and one phase's block (9C² + 8C²) on each block of min(tiles,
    SMs / 4) clusters at C = 64 (at most: the card may hold fewer)."""
    import torch

    b, hh, ww, c4 = shape
    c = c4 // 4
    tiles = b * -(-hh // 4) * -(-ww // 16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    halo = tiles * 6 * 18 * 6 * c * 2
    if c == 32:
        return halo + min(tiles, sms) * 41 * c * c * 2
    return halo + 4 * min(tiles, sms // 4) * 17 * c * c * 2


def _dec1_cudnn(x_skip, x_prev, kernel, bias, kt, bias_up):
    """K2's function by cuDNN, as context (the port never calls it): the
    ConvTranspose (flax applies its kernel flipped), the concat with the
    full-resolution skip, the 3x3 conv with bias; three calls on
    channels-last NCHW views in bf16, before the ReLU."""
    import torch
    import torch.nn.functional as F

    from mingraph_unet_tpu_torch.ops import s2d as s2d_ops

    dt = x_skip.dtype
    skip_full = s2d_ops.depth_to_space(x_skip).permute(0, 3, 1, 2)
    xp = x_prev.permute(0, 3, 1, 2)
    wt = kt.flip(0, 1).permute(2, 3, 0, 1).to(dt).contiguous(memory_format=torch.channels_last)
    wc = kernel.permute(3, 2, 0, 1).to(dt).contiguous(memory_format=torch.channels_last)
    bu, bc = bias_up.to(dt), bias.to(dt)
    return lambda: F.conv2d(torch.cat([skip_full, F.conv_transpose2d(xp, wt, bu, stride=2)], dim=1), wc, bc, padding=1)


def _s2d_of(y_nchw):
    """A full-resolution NCHW tensor in the s2d layout (B, H/2, W/2, 4C)."""
    from mingraph_unet_tpu_torch.ops import s2d as s2d_ops

    return s2d_ops.space_to_depth(y_nchw.permute(0, 2, 3, 1))


def _warm_profile(activities, **kwargs):
    """This checkout's ``utils/profiling.py::warm_profile`` (torch.profiler
    after a discarded warm-up step), loaded from its file: the module
    imports only torch, and ``tools/kernel_ab.py`` then measures an older
    checkout's port the same way."""
    if "_smoke_profiling" not in sys.modules:
        import importlib.util

        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mingraph_unet_tpu_torch", "utils",
                            "profiling.py")
        spec = importlib.util.spec_from_file_location("_smoke_profiling", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules["_smoke_profiling"] = module
    return sys.modules["_smoke_profiling"].warm_profile(activities, **kwargs)


def _is_device_op(e) -> bool:
    """Whether a ``key_averages()`` entry is an operation on the card. The
    program's own ranges (``mgu.*`` spans), which the profiler also lists
    on the device, span other operations and are none."""
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("mgu."))


def _device_ops(fn, iters: int):
    """Every operation ``fn`` puts on the card (kernels, memsets, copies),
    by torch.profiler over ``iters`` calls after a warm-up, as (name, µs a
    launch, launches a call), the longest first. The session starts with
    the profiler's own warm-up step (``utils/profiling.py::warm_profile``:
    without it a process that has profiled for a while loses a session's
    first kernels, at times all of a window's); each operation counts its
    mean time per recorded launch times its launches per call, rounded,
    and a window that records no device operation is taken again, up to
    three times in all (``_is_device_op``)."""
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with _warm_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ops = [(e.key, e.self_device_time_total / e.count, max(1, round(e.count / iters)))
               for e in prof.key_averages() if _is_device_op(e) and e.count]
        if ops:
            break
    return sorted(ops, key=lambda k: k[1] * k[2], reverse=True)


def _device_ms(label: str, fn, iters: int = 10, own: str = "", count: bool = False):
    """Device time per call of ``fn``: the summed time of every CUDA kernel
    it launches (``_device_ops``), printed with its kernels. Where a call
    is short, the CUDA-event time of ``_time_ms`` is the host's time to
    issue it; this is the card's. With ``own``, returns (the call's time,
    the time of the kernels whose name holds ``own``: the hand-written
    kernel without the wrapper's packing), and with ``count`` also the
    device operations a call."""
    kernels = _device_ops(fn, iters)
    ms = sum(t * n for _, t, n in kernels) / 1e3
    ops = sum(n for _, _, n in kernels)
    print(f"[chip_smoke]   device time per call of {label}: {ms * 1e3:.1f} us in {ops} operations: " + "; ".join(
        f"{key[:60]} {t:.1f} us x{n}" for key, t, n in kernels[:4]))
    if not own:
        return ms
    own_ms = sum(t * n for key, t, n in kernels if own in key) / 1e3
    if own_ms <= 0:
        _fail(f"{label}: the profiler recorded no kernel named {own!r}")
    return (ms, own_ms, ops) if count else (ms, own_ms)


def _host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host µs a call of ``fn``: ``time.perf_counter`` over ``calls`` calls
    issued back to back with no sync (the card runs behind), after a
    warm-up; the sync after the window is not counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _profile(label: str, step, step_ms: float, steps: int = 5, top: int = 15):
    """Device time by kernel over ``steps`` calls of ``step`` with
    torch.profiler, and the busy share of the unprofiled step. Returns
    ``{kernel: (ms, launches)}`` and ``{host op: (self ms, calls)}`` per
    step (the host ops' self time on every thread, under the profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    step()
    torch.cuda.synchronize()
    with _warm_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if _is_device_op(e) and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    print(f"[chip_smoke] profile {label}: {busy_ms:.3f} ms of kernel time per step, {launches:.0f} kernel launches "
          f"per step of {len(kernels)} distinct kernels; busy share of the {step_ms:.3f} ms step {busy_ms / step_ms:.3f}")
    for e in kernels[:top]:
        print(f"[chip_smoke]   {e.self_device_time_total / 1e3 / steps:8.3f} ms/step  "
              f"{e.count / steps:5.1f}/step  {e.key[:100]}")
    host = {e.key: (e.self_cpu_time_total / 1e3 / steps, e.count / steps) for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0}
    return {e.key: (e.self_device_time_total / 1e3 / steps, e.count / steps) for e in kernels}, host


def _train_cfg(size: int, bf16: bool, optimizer: str = "adam"):
    """The trainers' config at the repo's model widths (for the end-to-end
    trainer ``scripts/bench_train.py``'s setting: ``PipelineConfig()``, the
    full-resolution detection path, fast instancing). The defaults of
    ``PipelineConfig`` are ``configs/*.yaml``'s (a CPU test holds them
    equal); the files are not read here, as PyYAML need not be installed on
    the card's machine."""
    from mingraph_unet_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.preprocessing.resize_dim = (size, size)
    cfg.training.bf16 = bf16
    cfg.training.optimizer = optimizer
    cfg.training.learning_rate = LR
    cfg.training.weight_decay = WEIGHT_DECAY
    return cfg


def _train_batch(b: int, size: int, seed: int, dev):
    """Seeded uint8 orchard-like images (green ground, orange blobs, noise)
    and their binary blob masks, on ``dev``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(size), torch.arange(size), indexing="ij")
    mask = torch.zeros((b, size, size), dtype=torch.bool)
    for _ in range(6):
        cy, cx = torch.rand((2, b, 1, 1), generator=g) * size
        r = (0.04 + 0.08 * torch.rand((b, 1, 1), generator=g)) * size
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
    ground, fruit = torch.tensor([40.0, 110.0, 35.0]), torch.tensor([230.0, 140.0, 30.0])
    img = torch.where(mask[..., None], fruit, ground) + 20.0 * torch.randn((b, size, size, 3), generator=g)
    return img.clamp(0, 255).to(torch.uint8).to(dev), mask.to(torch.uint8).to(dev)


def _grads_finite(model) -> bool:
    import torch

    return all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in model.parameters())


def _train_path(dev, cfg, label: str, warmup: int, iters: int, fixed: bool = True):
    """Train the U-Net of ``cfg`` (bf16 512² b8, augmentation) for ``warmup``
    untimed and ``iters`` timed steps through K4, checking the launches
    (K4 4 + 4 a step, no other kernel), a finite loss, a finite gradient in
    every leaf and a non-zero one in every leaf but the conv biases that
    feed BN, and moved BN statistics (where it has BN); with ``fixed``, the
    loss then falls on a fixed batch. Returns the launches a step and the
    timings."""
    import torch

    from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer
    from mingraph_unet_tpu_torch.train.segmentation import build_unet, make_train_step

    model = build_unet(cfg)
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    state = TrainState(model, *make_optimizer(model.parameters(), cfg.training, steps_per_epoch=1000))
    step = make_train_step(cfg, augment=True)
    imgs, masks = _train_batch(BATCH, SIZE, seed=3, dev=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    _reset_counts()
    losses = [step(state, imgs, masks, gen)["loss"] for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        losses.append(step(state, imgs, masks, gen)["loss"])
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    launches = _counts()
    n = warmup + iters
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    print(f"[chip_smoke] {label} launches over {n} steps: {launches}; losses {[f'{v:.4f}' for v in losses]}")
    if launches != dict({k: 0 for k in launches}, k4_fwd=4 * n, k4_dgrad=4 * n):
        _fail(f"{label}: expected K4 forward 4 and dgrad 4 launches per train step and no K1-K3, K5, K7-K9, "
              f"sharded K2 or hist-eq, got {launches} over {n} steps")
    if not all(math.isfinite(v) for v in losses):
        _fail(f"{label}: a train step's loss is not finite")
    if not _grads_finite(model):
        _fail(f"{label}: a parameter has no gradient or a non-finite one")
    zero = [k for k, p in model.named_parameters() if not (stats0 and _feeds_bn(k)) and not bool(p.grad.ne(0).any())]
    if zero:
        _fail(f"{label}: leaves with an all-zero gradient: {zero[:5]}")
    unmoved = [k for k, b in model.named_buffers() if torch.equal(b, stats0[k])]
    if unmoved or cfg.model.unet.use_batchnorm != bool(stats0):
        _fail(f"{label}: BN running statistics did not move: {unmoved[:5]} ({len(stats0)} in all)")
    print(f"[chip_smoke] {label} train bf16 {BATCH}x{SIZE}^2: {ms:.3f} ms/step, {BATCH / ms * 1e3:.1f} images/s, "
          f"host issue time {host_ms:.3f} ms/step, peak memory {peak:.2f} GiB; all "
          f"{len(list(model.parameters()))} parameters have finite gradients; all {len(stats0)} BN statistics "
          f"moved")
    if fixed:
        _profile(f"{label} step", lambda: step(state, imgs, masks, gen), ms, steps=3)
        # The same trainer on one fixed batch, without augmentation: the loss falls.
        del state, model
        model = build_unet(cfg)
        state = TrainState(model, *make_optimizer(model.parameters(), cfg.training, steps_per_epoch=1000))
        fixed_step = make_train_step(cfg, augment=False)
        fixed_losses = [float(fixed_step(state, imgs, masks, gen)["loss"]) for _ in range(FIXED_BATCH_STEPS)]
        print(f"[chip_smoke] {label} fixed batch losses {[f'{v:.4f}' for v in fixed_losses]}")
        if not fixed_losses[-1] < fixed_losses[0]:
            _fail(f"{label}: the loss did not fall on a fixed batch: {fixed_losses[0]} -> {fixed_losses[-1]}")
    del state, model
    torch.cuda.empty_cache()
    return {k: v // n for k, v in launches.items()}, ms, host_ms, peak


def _feeds_bn(name: str) -> bool:
    """A U-Net conv bias (in a bare ``UNet`` or under ``unet.``), which feeds
    a train-mode BatchNorm directly: its gradient is zero in exact
    arithmetic (BN subtracts the batch mean). The detection head's conv
    biases are not: a ReLU sits between each and its BN."""
    return re.match(r"(unet\.)?(encoder|decoder)\..*\.conv[12]\.bias$", name) is not None


class _Decisions:
    """Within ``with``: records the U-Net's discrete decisions (the sign of
    every ReLU input, the winners of every max-pool window) in call order,
    or, given a recording, makes them instead of the run's own: a ReLU
    becomes ``x·mask`` and a pool the tie-split sum over its recorded
    winners, which have the gradients ReLU and ``amax`` give. ``flips``
    counts the decisions a replay made other than the run's own."""

    def __init__(self, replay=None):
        self.replay = replay
        self.log, self.flips, self.total = [], 0, 0

    def _decide(self, own):
        if self.replay is None:
            self.log.append(own.cpu())
            return own
        rec = self.replay[len(self.log)].to(own.device)
        self.log.append(rec)
        self.flips += int((rec != own).sum())
        self.total += own.numel()
        return rec

    def _pool(self, v, dims, own_pool):
        """Max over ``dims`` of the windows ``v``: the run's own pool when
        recording, the tie-split sum over the recorded winners in a replay."""
        wins = self._decide(v == v.amax(dims, keepdim=True))
        if self.replay is None:
            return own_pool()
        wins = wins.to(v.dtype)
        return (v * wins).sum(dims) / wins.sum(dims)

    def __enter__(self):
        import torch

        from mingraph_unet_tpu_torch.models import unet

        self._saved = (torch.relu, unet.s2d_ops.phase_max_pool, unet._max_pool_2x2)
        relu, phase_pool, pool2 = self._saved

        def relu_d(x):
            positive = self._decide(x > 0)
            return relu(x) if self.replay is None else x * positive.to(x.dtype)

        def phase_pool_d(y, r=2):
            b, hh, ww, cc = y.shape
            return self._pool(y.reshape(b, hh, ww, r * r, cc // (r * r)), 3, lambda: phase_pool(y, r))

        def pool2_d(x):
            b, h, w, c = x.shape
            v = x[:, : h // 2 * 2, : w // 2 * 2].reshape(b, h // 2, 2, w // 2, 2, c)
            return self._pool(v, (2, 4), lambda: pool2(x))

        torch.relu, unet.s2d_ops.phase_max_pool, unet._max_pool_2x2 = relu_d, phase_pool_d, pool2_d
        return self

    def __exit__(self, *exc):
        import torch

        from mingraph_unet_tpu_torch.models import unet

        torch.relu, unet.s2d_ops.phase_max_pool, unet._max_pool_2x2 = self._saved
        if exc[0] is None and self.replay is not None and len(self.log) != len(self.replay):
            _fail(f"decision replay: {len(self.log)} decisions made, {len(self.replay)} recorded")
        return False


def _train_vs_cpu(dev, change=None, exact_zero=None, label: str = "train step") -> None:
    """Phase 5, card vs CPU: one f32 train step at batch 2, 128², TF32 off,
    same weights and batch, held against the same step in f64 on the CPU.
    SGD with momentum, so that the update is linear in the gradient: Adam's
    first step is lr·sign(g), which would turn the rounding noise of
    near-zero gradients into differences of 2·lr (Adam is held to JAX on
    the CPU by tests/test_torch_train.py).

    The f64 step makes the card's discrete decisions (``_Decisions``): a
    ReLU input or a pool's runner-up within f32 rounding of its kink may
    fall on the other side in f32, which moves a deep leaf's gradient by
    up to 10% of its scale; the decision-matched f64 step measures the
    card's arithmetic, and the flips are counted and printed with each f32
    step's distance from the plain f64 step. Each leaf (gradient, updated
    parameter) of the card's step must lie within CPU_TOL of its own max
    |f64|. A conv bias before a train-mode BN has a zero gradient in exact
    arithmetic; its gradient is held to CPU_TOL of the model's largest
    gradient and its update to lr times that. The CPU's f32 step is held to
    the same limits the same way. Phase 15 passes a config ``change`` (the
    U-Net without BN, whose biases have no zero gradient: ``exact_zero``)."""
    import torch

    from mingraph_unet_tpu_torch.models.unet import UNet
    from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer
    from mingraph_unet_tpu_torch.train.segmentation import build_unet, make_train_step

    exact_zero = exact_zero or _feeds_bn
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _train_cfg(128, bf16=False, optimizer="sgd")
    if change:
        change(cfg)
    u = cfg.model.unet
    weights = build_unet(cfg, device="cpu").state_dict()
    imgs, masks = _train_batch(2, 128, seed=5, dev="cpu")

    def step(where, dtype, decisions):
        if dtype == torch.float64:
            model = UNet(torch.Generator(), u.in_channels, u.out_channels, u.init_features, u.depth, dtype,
                         u.use_batchnorm, u.remat)
            model = model.double().train()
        else:
            model = build_unet(cfg, device=where)
        model.load_state_dict(weights)
        state = TrainState(model, *make_optimizer(model.parameters(), cfg.training, steps_per_epoch=1000))
        with decisions:
            loss = float(make_train_step(cfg, augment=False)(state, imgs.to(where), masks.to(where), None)["loss"])
        return loss, {(kind, n): (p.grad if kind == "grad" else p.detach()).cpu().double()
                      for n, p in model.named_parameters() for kind in ("grad", "param")}

    t0 = time.perf_counter()
    plain_loss, plain = step("cpu", torch.float64, _Decisions())
    top_grad = max(t.abs().max().item() for (kind, _), t in plain.items() if kind == "grad")
    results = {}
    for name, where in (("card", dev), ("CPU", "cpu")):
        rec = _Decisions()
        loss, got = step(where, torch.float32, rec)
        ref = _Decisions(replay=rec.log)
        ref_loss, ref_leaves = step("cpu", torch.float64, ref)
        rows = []
        for key, r in ref_leaves.items():
            kind, n = key
            err, own = (got[key] - r).abs().max().item(), r.abs().max().item()
            plain_err = (got[key] - plain[key]).abs().max().item() / max(plain[key].abs().max().item(), 1e-30)
            limit = CPU_TOL * top_grad * (1.0 if kind == "grad" else LR) if exact_zero(n) else CPU_TOL * own
            rows.append((err / limit, kind, n, err / max(own, 1e-30), plain_err, exact_zero(n)))
        rows.sort(reverse=True)
        results[name] = (abs(loss - ref_loss) / abs(ref_loss), rows, ref.flips, ref.total)
    torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32 = True
    print(f"[chip_smoke] {label} f32 vs f64, batch 2, 128^2, TF32 off ({time.perf_counter() - t0:.1f}s): "
          f"f64 loss {plain_loss:.9f}")
    for name, (loss_rel, rows, flips, total) in results.items():
        worst_plain = max((r for r in rows if not r[5]), key=lambda r: r[4])
        print(f"[chip_smoke]   {name} f32: loss rel err {loss_rel:.3g}; {flips} of {total} ReLU and pool decisions "
              f"differ from the plain f64 step's; worst leaf vs the plain f64 step {worst_plain[4]:.3g} of its "
              f"scale ({worst_plain[1]} {worst_plain[2]}); vs the decision-matched f64 step, share of limit, "
              f"error of max |f64 leaf|:")
        for share, kind, n, rel, _, _ in rows[:5]:
            print(f"[chip_smoke]     {share:.3g}  {kind} {n}: {rel:.3g}")
        outside = [(kind, n) for share, kind, n, *_ in rows if not share <= 1.0]
        if loss_rel > CPU_TOL or outside:
            _fail(f"{label} {name} f32 vs f64: loss rel err {loss_rel:.3g}, {len(outside)} leaves outside "
                  f"their limit, first {outside[:3]}")
    print(f"[chip_smoke] {label} f32 card and CPU vs f64: loss and all {len(rows)} leaves within their "
          f"limits: ok")


def _k4_table(dev, launches, e2e_launches):
    """Phase 6: K4 forward and dgrad against their plain versions (bf16 and
    f32) and timed, the autograd Function's gradients against plain
    autograd, and the kernel gradient's time beside its bound."""
    import torch
    import torch.nn.functional as F

    from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
    from mingraph_unet_tpu_torch.ops.kernels import psconv

    g = torch.Generator(device=dev).manual_seed(7)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale  # noqa: E731
    source = "mingraph_unet_tpu_torch/csrc/psel_conv.cu"
    rows = []
    for lvl, c in ((0, 32), (1, 64)):
        hh = SIZE // 2 ** (lvl + 1)
        full_px = BATCH * (2 * hh) ** 2
        x = rnd(BATCH, hh, hh, 4 * c).to(torch.bfloat16)
        cot = rnd(BATCH, hh, hh, 4 * c).to(torch.bfloat16)
        k = rnd(3, 3, c, c, scale=(1.0 / (9 * c)) ** 0.5)
        t_bytes = (2 * x.numel() * 2 + k.numel() * 2) / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * full_px * 9 * c * c / BF16_TENSOR_FLOPS * 1e3
        for name, fn, plain, inp, kk, line in (
            ("psconv_fwd", psconv.psconv_fwd, psconv.psconv_train_plain, x, k, 416),
            ("psconv_dgrad", psconv.psconv_dgrad, psconv.psconv_dgrad_plain, cot, k, 433),
        ):
            tag = f"{name} L{lvl} {tuple(inp.shape)}"
            err = _check_close(f"{tag} bf16", fn(inp, kk), plain(inp.float(), kk), CONV_TOL)
            torch.backends.cudnn.allow_tf32 = False
            _check_close(f"{tag} f32", fn(inp.float(), kk), plain(inp.float(), kk), F32_TOL)
            torch.backends.cudnn.allow_tf32 = True
            ms = _time_ms(lambda: fn(inp, kk), KERNEL_ITERS)
            plain_ms = _time_ms(lambda: plain(inp, kk), KERNEL_ITERS)
            kd = kk if name == "psconv_fwd" else kk.flip(0, 1).transpose(2, 3)
            w = s2d_ops.s2d_conv3x3_kernel(kd).to(inp.dtype).permute(3, 2, 0, 1).contiguous()
            xn = inp.permute(0, 3, 1, 2)
            library_ms = _time_ms(lambda: F.conv2d(xn, w, padding=1), KERNEL_ITERS)
            call_ms, dev_ms, dev_ops = _device_ms(tag, lambda: fn(inp, kk), own="psel_wgmma_kernel", count=True)
            host_us = _host_us(lambda: fn(inp, kk))
            rows.append({
                "name": f"{name} L{lvl}", "route": "cuda", "source": source, "device_ms": dev_ms,
                "call_device_ms": call_ms, "device_ops": dev_ops, "host_us": host_us,
                "replaces": f"{PSCONV_SRC}:{line}", "launches": launches[f"k4_{name.split('_')[1]}"],
                "launches_e2e": e2e_launches[f"k4_{name.split('_')[1]}"],
                "shape": list(inp.shape), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms,
            })
            print(f"[chip_smoke] {name} L{lvl}: {ms * 1e3:.1f} us/launch, host {host_us:.1f} us a call, device "
                  f"{dev_ms * 1e3:.1f} us ({dev_ops} operations a call), plain "
                  f"{plain_ms * 1e3:.1f} us, library {library_ms * 1e3:.1f} us, bound {max(t_bytes, t_ops) * 1e3:.1f} us "
                  f"({rows[-1]['bound_by']})")

        # The autograd Function's dx and dK for the seeded cotangent, bf16
        # and f32, against the plain version under ordinary autograd in f32
        # on the same values. dx of bf16 inputs is bf16 (CONV_TOL); dK is
        # summed in f32 either way, so DK_TOL tells it from a bf16 result.
        for dt, tol, dk_tol in ((torch.bfloat16, CONV_TOL, DK_TOL), (torch.float32, F32_TOL, F32_TOL)):
            torch.backends.cudnn.allow_tf32 = False
            grads = []
            for fn, xin, gin in ((psconv.psconv_train, x.to(dt), cot.to(dt)),
                                 (psconv.psconv_train_plain, x.float(), cot.float())):
                xi, ki = xin.clone().requires_grad_(), k.clone().requires_grad_()
                fn(xi, ki).backward(gin)
                grads.append((xi.grad, ki.grad))
            torch.backends.cudnn.allow_tf32 = True
            (dx, dk), (dx_ref, dk_ref) = grads
            dname = "bf16" if dt == torch.bfloat16 else "f32"
            _check_close(f"psconv_train L{lvl} {dname} dx", dx, dx_ref, tol)
            if dk.dtype != torch.float32:
                _fail(f"psconv_train L{lvl} {dname}: the kernel gradient is {dk.dtype}, not float32")
            _check_close(f"psconv_train L{lvl} {dname} dK", dk[None], dk_ref[None], dk_tol, border=False)

        # The kernel gradient (PyTorch: the dense s2d weight gradient pulled
        # back through the tap map): least work = read x and g once, write
        # dK in f32; 2·9·C² operations per full-res pixel.
        dk_ms = _time_ms(lambda: psconv.psconv_wgrad(x, cot, k), KERNEL_ITERS)
        dk_dev_ms = _device_ms(f"psconv_wgrad L{lvl}", lambda: psconv.psconv_wgrad(x, cot, k))
        b_bytes = ((x.numel() + cot.numel()) * 2 + k.numel() * 4) / HBM_BYTES_PER_S * 1e3
        b_ops = 2 * full_px * 9 * c * c / BF16_TENSOR_FLOPS * 1e3
        print(f"[chip_smoke] psconv_wgrad L{lvl} (PyTorch): {dk_ms * 1e3:.1f} us/call, device "
              f"{dk_dev_ms * 1e3:.1f} us, bound {max(b_bytes, b_ops) * 1e3:.1f} us "
              f"({'bytes' if b_bytes >= b_ops else 'operations'})")
    return rows


# ---------------------------------------------------------------------------
# The configured precision (f32): the split psel kernel (phases 3, 5, 6)
# ---------------------------------------------------------------------------

F32_CELLS = ((BATCH, SIZE), (16, 128))  # the bf16 rows' 512² b8, configs/*.yaml's 128² b16
F32_STEP_WARMUP, F32_STEP_ITERS = 3, 10
SPLIT_KERNEL, DEC1_SPLIT = "psel_split_kernel", "dec1_split_kernel"


def _split_bound(shape, ops_terms: int, extra_bytes: int = 0):
    """(bound ms, bound_by, SIMT ms) of an f32 conv over the s2d ``shape``
    computed on the tensor cores in the split form: f32 x read and y written
    once (plus ``extra_bytes``) at 3.35 TB/s against three bf16 products of
    ``ops_terms`` multiply-adds a full-res pixel (9·C² for psel, 17·C² for
    K2) at 989 TFLOP/s; the SIMT figure is the same function's 2·ops_terms
    operations a pixel at 67 f32 TFLOP/s, context only."""
    b, hh, ww, z = shape
    t_bytes = (2 * b * hh * ww * z * 4 + extra_bytes) / HBM_BYTES_PER_S * 1e3
    ops = 2 * b * (2 * hh) * (2 * ww) * ops_terms
    t_ops = 3 * ops / BF16_TENSOR_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", ops / F32_SIMT_FLOPS * 1e3


def _kernel_names(label: str, fn, iters: int = 2):
    """(psel split, K2 split) kernel launches a call of ``fn`` by
    torch.profiler's kernel names, printed."""
    ops = _device_ops(fn, iters)
    names = {key: n for key, _, n in ops}
    split, dec1 = (sum(n for key, n in names.items() if name in key) for name in (SPLIT_KERNEL, DEC1_SPLIT))
    print(f"[chip_smoke] {label}: {split} {SPLIT_KERNEL} and {dec1} {DEC1_SPLIT} launches a call (profiler)")
    return split, dec1


def _configured_step(dev, iters: int):
    """The segmentation step as ``configs/*.yaml`` configure it (f32, 128²,
    batch 16, Adam; PyTorch's default TF32 setting) on a seeded batch, timed
    over ``iters`` steps after F32_STEP_WARMUP: ms/step by CUDA events, host
    issue ms/step by ``time.perf_counter``, peak memory in GiB, the
    launches a step and every step's loss; with the model and a call of
    one more step. Shared with ``tools/kernel_ab.py``'s f32 case."""
    import torch

    from mingraph_unet_tpu_torch.config import PipelineConfig
    from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer
    from mingraph_unet_tpu_torch.train.segmentation import build_unet, make_train_step

    cfg = PipelineConfig.from_config_dir(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs"))
    b, size = cfg.training.batch_size, cfg.preprocessing.resize_dim[0]
    if cfg.training.bf16 or (b, size) != F32_CELLS[1] or cfg.training.optimizer != "adam":
        _fail(f"configs/*.yaml no longer configure f32 Adam at {F32_CELLS[1][1]}² b{F32_CELLS[1][0]}")
    model = build_unet(cfg)
    state = TrainState(model, *make_optimizer(model.parameters(), cfg.training, steps_per_epoch=1000))
    step = make_train_step(cfg, augment=True)
    imgs, masks = _train_batch(b, size, seed=3, dev=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = [step(state, imgs, masks, gen)["loss"] for _ in range(F32_STEP_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        losses.append(step(state, imgs, masks, gen)["loss"])
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return {"ms": start.elapsed_time(end) / iters, "host_ms": host_ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "counts": {k: v // iters for k, v in _counts().items()}, "losses": [float(v) for v in losses],
            "model": model, "step": lambda: step(state, imgs, masks, gen)}


def _f32_path(dev):
    """The configured precision's paths on the card, counted and profiled:
    the f32 serving forward at 128² b16 (psel 4, dec-conv1 2, pool 2, d2s 1,
    hist-eq 1, K8 5: every standard-layout ConvBlock of an f32 eval
    forward, and K10 2 on its narrow tile: the detection head's convs; the
    profiler's kernel names: every psel and K2 launch on a split
    tensor-core kernel) and the segmentation step as
    ``configs/*.yaml`` configure it (f32, 128², batch 16, Adam lr 1e-3
    weight decay 1e-4, PyTorch's default TF32 setting): K4 4 + 4 a step,
    every one the split kernel; finite losses and
    gradients; ms/step by CUDA events, host issue ms, peak memory; and the
    f32 serving forward's device time at 512² b8 (torch.profiler; K8 5
    again). Returns the launches a forward and a step."""
    import torch

    from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet

    b, size = F32_CELLS[1]  # the configured cell (``_configured_step`` holds configs/*.yaml to it)
    with torch.no_grad():
        model = MinGraphUNet(dtype=torch.float32, detection_pre_pool=size // 16, device=dev, seed=0)
        _perturb_bn(model, seed=1)
        x = _images(b, size, seed=2).to(dev)
        _reset_counts()
        out = model(x)
        torch.cuda.synchronize()
        fwd = _counts()
        if fwd != dict({k: 0 for k in fwd}, psel=4, dec1=2, pool=2, d2s=1, histeq=1, conv_block=5, k10_fwd=2):
            _fail(f"f32 serving forward {size}² b{b}: launches {fwd}")
        if not torch.isfinite(out["logits"]).all():
            _fail("f32 serving forward: non-finite logits")
        names = _kernel_names(f"f32 serving forward {size}² b{b}", lambda: model(x))
        if names != (fwd["psel"], fwd["dec1"]):
            _fail(f"f32 serving forward: {names} psel split and K2 split launches, expected psel "
                  f"{fwd['psel']} and K2 {fwd['dec1']} on their split kernels")
    del model, x, out
    with torch.no_grad():  # the f32 serving forward at the bf16 path's 512² b8: its device time
        model, x = _serving_model(dev, dtype=torch.float32)
        _reset_counts()
        model(x)
        if _counts()["dec1"] != 2 or _counts()["conv_block"] != 5:
            _fail(f"f32 serving forward {SIZE}² b{BATCH}: launches {_counts()}, expected dec1 2 and conv_block 5")
        fwd_dev_ms = _device_ms(f"f32 serving forward {SIZE}^2 b{BATCH}", lambda: model(x), iters=3)
        print(f"[chip_smoke] f32_forward_device_ms {fwd_dev_ms:.4f} ({SIZE}² b{BATCH}, TF32 as PyTorch's default)")
    del model, x
    torch.cuda.empty_cache()

    run = _configured_step(dev, F32_STEP_ITERS)
    ms, host_ms, peak, counts, losses = run["ms"], run["host_ms"], run["peak_gib"], run["counts"], run["losses"]
    if counts != dict({k: 0 for k in counts}, k4_fwd=4, k4_dgrad=4, k10_fwd=10, k10_dgrad=10):
        _fail(f"configured f32 step: launches a step {counts}")
    if not all(math.isfinite(v) for v in losses) or not _grads_finite(run["model"]):
        _fail("configured f32 step: a non-finite loss or gradient")
    names = _kernel_names("configured f32 step", run["step"])
    if names != (8, 0):
        _fail(f"configured f32 step: {names} psel split and K2 split launches a step, expected K4's 8 on the "
              f"split kernel")
    print(f"[chip_smoke] configured segmentation step (configs/*.yaml: f32, {size}² b{b}, Adam): {ms:.3f} ms/step, "
          f"{b / ms * 1e3:.1f} images/s, host issue time {host_ms:.3f} ms/step, peak memory {peak:.3f} GiB; "
          f"losses {[f'{v:.4f}' for v in losses]}")
    print(f"[chip_smoke] f32_step_ms {ms:.4f} f32_step_host_ms {host_ms:.4f} f32_step_peak_gib {peak:.3f}")
    del run
    torch.cuda.empty_cache()
    return fwd, counts


def _f32_table(dev, fwd_launches, step_launches):
    """Phases 2, 4 and 6 in f32: K1, K4 forward and dgrad at the 512² b8
    shapes and the configured 128² b16 ones of both s2d levels (C = 32, 64:
    the split kernel) held against their plain versions within F32_TOL
    (TF32 off), whole output and borders, and timed: events a launch, the
    kernel's device time, its device operations a call (must be 1) and
    host µs, the plain version, the full-resolution ``F.conv2d`` in f32
    (channels-last; TF32 off, and on as context), the split form's bound and
    the SIMT figure; the autograd Function's f32 gradients at 128² b16
    (512² b8: phase 6). K2 in f32 (its split kernel) at its bf16 shapes on
    the model's strided weights, checked, timed (device operations a call:
    1) beside its split-form bound and, having no one-call library, the
    cuDNN route in f32 as context; and K2's sharded entry in f32, 4 equal
    and 4 uneven shards stitched bit-equal to the whole launch, the inner
    shard of 4 checked and timed the same way (its launches: phase 13's
    f32 sharded forward)."""
    import torch
    import torch.nn.functional as F

    from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
    from mingraph_unet_tpu_torch.ops.kernels import psconv

    g = torch.Generator(device=dev).manual_seed(23)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale  # noqa: E731
    source = "mingraph_unet_tpu_torch/csrc/psel_conv.cu"
    rows = []
    torch.backends.cudnn.allow_tf32 = False
    for b, size in F32_CELLS:
        cell = f"{size}^2 b{b}"
        for lvl, c in ((0, 32), (1, 64)):
            hh = size // 2 ** (lvl + 1)
            x, cot = rnd(b, hh, hh, 4 * c), rnd(b, hh, hh, 4 * c)
            k, bias = rnd(3, 3, c, c, scale=(1.0 / (9 * c)) ** 0.5), rnd(c)
            xf = s2d_ops.depth_to_space(x).permute(0, 3, 1, 2)  # channels-last NCHW view
            wf = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            library = lambda: F.conv2d(xf, wf, padding=1)  # noqa: E731
            _check_close(f"library F.conv2d f32 {cell} L{lvl}", s2d_ops.space_to_depth(library().permute(0, 2, 3, 1)),
                         psconv.psconv_train_plain(x, k), F32_TOL, what="K4's plain version")
            lib_ms = _time_ms(library, KERNEL_ITERS)
            lib_dev = _device_ms(f"library f32 {cell} L{lvl}", library)
            torch.backends.cudnn.allow_tf32 = True
            tf32_ms, tf32_dev = _time_ms(library, KERNEL_ITERS), _device_ms(f"library TF32 {cell} L{lvl}", library)
            torch.backends.cudnn.allow_tf32 = False
            bound, bound_by, simt = _split_bound(x.shape, 9 * c * c, k.numel() * 4)
            for name, fn, plain, args, line, counter in (
                ("psel_conv3x3", psconv.psel_conv3x3, psconv.psel_conv3x3_plain, (x, k, bias), "258", "psel"),
                ("psconv_fwd", psconv.psconv_fwd, psconv.psconv_train_plain, (x, k), "416", "k4_fwd"),
                ("psconv_dgrad", psconv.psconv_dgrad, psconv.psconv_dgrad_plain, (cot, k), "433", "k4_dgrad"),
            ):
                tag = f"{name} f32 {cell} L{lvl}"
                first = fn(*args)
                err = _check_close(f"{tag} {tuple(x.shape)}", first, plain(*args), F32_TOL)
                call = lambda: fn(*args)  # noqa: E731
                ms, plain_ms = _time_ms(call, KERNEL_ITERS), _time_ms(lambda: plain(*args), KERNEL_ITERS)
                if not torch.equal(call(), first):  # every stage of the ring reused many times by now
                    _fail(f"{tag}: a later launch differs from the first on the same input")
                call_ms, dev_ms, dev_ops = _device_ms(tag, call, own=SPLIT_KERNEL, count=True)
                if dev_ops != 1:
                    _fail(f"{tag}: {dev_ops} device operations a call, expected the split kernel alone")
                host_us = _host_us(call)
                launches = fwd_launches if counter == "psel" else step_launches
                rows.append({
                    "name": tag, "route": "cuda", "source": source, "replaces": f"{PSCONV_SRC}:{line}",
                    "launches": launches[counter], "launches_path": "f32 serving forward 128^2 b16" if
                    counter == "psel" else "configured f32 segmentation step", "shape": list(x.shape),
                    "dtype": "float32", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": lib_ms, "device_ms": dev_ms, "call_device_ms": call_ms,
                    "device_ops": dev_ops, "host_us": host_us, "library_device_ms": lib_dev,
                    "library_tf32_ms": tf32_ms, "library_tf32_device_ms": tf32_dev,
                })
                print(f"[chip_smoke] {tag}: {ms * 1e3:.1f} us/launch, device {dev_ms * 1e3:.1f} us ({dev_ops} "
                      f"operation a call), host {host_us:.1f} us a call, plain {plain_ms * 1e3:.1f} us, library f32 "
                      f"(TF32 off) {lib_ms * 1e3:.1f} us / device {lib_dev * 1e3:.1f} us (TF32 on, context: "
                      f"{tf32_ms * 1e3:.1f} / {tf32_dev * 1e3:.1f} us), bound {bound * 1e3:.1f} us ({bound_by}, the "
                      f"split form's bf16 products); f32 FMA figure {simt * 1e3:.1f} us (context)")
            if b != BATCH:  # phase 6 holds the 512² b8 gradients
                grads = []
                for fn in (psconv.psconv_train, psconv.psconv_train_plain):
                    xi, ki = x.clone().requires_grad_(), k.clone().requires_grad_()
                    fn(xi, ki).backward(cot)
                    grads.append((xi.grad, ki.grad))
                (dx, dk), (dx_ref, dk_ref) = grads
                _check_close(f"psconv_train f32 {cell} L{lvl} dx", dx, dx_ref, F32_TOL)
                _check_close(f"psconv_train f32 {cell} L{lvl} dK", dk[None], dk_ref[None], F32_TOL, border=False)

    for case in _kernel_cases(dev):
        if case["kind"] != "dec1":
            continue
        # k_skip, k_prev and t9 as the model makes them (a slice of conv1's
        # kernel, the einsum's k_prev, the table): strided views, which the
        # split kernel reads as they lie.
        args = [a.float() for a in case["args"]]
        lvl, c, hh = case["level"], args[0].shape[-1] // 4, args[0].shape[1]
        tag = f"dec_conv1_fused f32 {SIZE}^2 b{BATCH} L{lvl}"
        call = lambda: psconv.dec_conv1_fused(*args)  # noqa: E731
        first = call()
        err = _check_close(f"{tag} {tuple(args[0].shape)}", first, psconv.dec_conv1_fused_plain(*args), F32_TOL)
        ms = _time_ms(call, KERNEL_ITERS)
        plain_ms = _time_ms(lambda: psconv.dec_conv1_fused_plain(*args), KERNEL_ITERS)
        if not torch.equal(call(), first):  # every stage of the ring reused many times by now
            _fail(f"{tag}: a later launch differs from the first on the same input")
        call_ms, dev_ms, dev_ops = _device_ms(tag, call, own=DEC1_SPLIT, count=True)
        if dev_ops != 1:
            _fail(f"{tag}: {dev_ops} device operations a call, expected the split kernel alone")
        host_us = _host_us(call)
        cudnn = _dec1_cudnn(args[0], args[1], *case["unfolded"])
        cudnn_ms, cudnn_dev = _time_ms(cudnn, KERNEL_ITERS), _device_ms(f"{tag} cuDNN route", cudnn)
        weight_bytes = (args[2].numel() + args[3].numel() + args[4].numel()) * 4
        bound, bound_by, simt = _split_bound(args[0].shape, 17 * c * c, args[1].numel() * 4 + weight_bytes)
        rows.append({
            "name": tag, "route": "cuda", "source": "mingraph_unet_tpu_torch/csrc/dec_conv1.cu",
            "replaces": f"{PSCONV_SRC}:599", "launches": fwd_launches["dec1"],
            "launches_path": "f32 serving forward 128^2 b16", "shape": list(args[0].shape), "dtype": "float32",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "device_ms": dev_ms, "call_device_ms": call_ms, "device_ops": dev_ops,
            "host_us": host_us, "context_cudnn_route_ms": cudnn_ms, "context_cudnn_route_device_ms": cudnn_dev,
        })
        print(f"[chip_smoke] {tag} (the split kernel): {ms * 1e3:.1f} us/launch, device {dev_ms * 1e3:.1f} us "
              f"({dev_ops} operation a call), host {host_us:.1f} us a call, plain {plain_ms * 1e3:.1f} us, cuDNN "
              f"route f32 (context) {cudnn_ms * 1e3:.1f} / {cudnn_dev * 1e3:.1f} us, bound {bound * 1e3:.1f} us "
              f"({bound_by}, split form), f32 FMA figure {simt * 1e3:.1f} us")

        # The sharded entry: 4 equal and 4 uneven shards stitched bit-equal
        # to the whole launch, then the inner shard of 4 checked and timed.
        views = lambda cuts: zip(_shard_views(args[0], cuts), _shard_views(args[1], cuts))  # noqa: E731
        for cuts in _shard_cuts(hh):
            got = torch.cat([psconv.dec_conv1_halo(s, st, sb, p, pt, pb, *args[2:], row0, hh)
                             for (s, st, sb, row0), (p, pt, pb, _) in views(cuts)], dim=1)
            if not torch.equal(got, first):
                _fail(f"dec_conv1_halo f32 L{lvl} shards {cuts}: not bit-equal to the whole launch (max diff "
                      f"{(got - first).abs().max().item():.3g})")
        (s, st, sb, row0), (p, pt, pb, _) = list(views(_shard_cuts(hh)[0]))[1]
        stag = f"dec_conv1_halo f32 {SIZE}^2 b{BATCH} L{lvl}"
        shard = lambda: psconv.dec_conv1_halo(s, st, sb, p, pt, pb, *args[2:], row0, hh)  # noqa: E731
        shard_plain = lambda: psconv.dec_conv1_halo_plain(s, st, sb, p, pt, pb, *args[2:], row0, hh)  # noqa: E731
        serr = _check_close(f"{stag} inner shard {tuple(s.shape)}", shard(), shard_plain(), F32_TOL)
        sms, splain_ms = _time_ms(shard, KERNEL_ITERS), _time_ms(shard_plain, KERNEL_ITERS)
        scall_ms, sdev_ms, sops = _device_ms(f"{stag} inner shard", shard, own=DEC1_SPLIT, count=True)
        if sops != 1:
            _fail(f"{stag}: {sops} device operations a call, expected the split kernel alone")
        shost = _host_us(shard)
        rows_in = (st.numel() + sb.numel() + pt.numel() + pb.numel()) * 4
        sbound, sbound_by, ssimt = _split_bound(s.shape, 17 * c * c, p.numel() * 4 + rows_in + weight_bytes)
        rows.append({
            "name": stag, "route": "cuda", "source": "mingraph_unet_tpu_torch/csrc/dec_conv1.cu",
            "replaces": f"{PSCONV_SRC}:599", "launches": None,  # set from phase 13's f32 sharded forward
            "launches_path": "f32 sharded serving forward 512^2 b8 (phase 13)", "shape": list(s.shape),
            "shards": 4, "dtype": "float32", "max_abs_err": serr, "ms": sms, "plain_ms": splain_ms,
            "bound_ms": sbound, "bound_by": sbound_by, "library_ms": None, "device_ms": sdev_ms,
            "call_device_ms": scall_ms, "device_ops": sops, "host_us": shost,
            "unsharded_device_ms_over_4": dev_ms / 4,
        })
        print(f"[chip_smoke] {stag} inner shard {tuple(s.shape)} (4 equal and 4 uneven shards bit-equal to the whole "
              f"launch): {sms * 1e3:.1f} us/launch, device {sdev_ms * 1e3:.1f} us ({sops} operation a call; the whole "
              f"launch over 4: {dev_ms / 4 * 1e3:.1f}), host {shost:.1f} us a call, plain {splain_ms * 1e3:.1f} us, "
              f"bound {sbound * 1e3:.1f} us ({sbound_by}, split form), f32 FMA figure {ssimt * 1e3:.1f} us")
    torch.backends.cudnn.allow_tf32 = True
    return rows


def _luma_u8(imgs_u8):
    """The pipeline's uint8 luma of uint8 RGB images (OpenCV's YUV Y)."""
    import torch

    rgb = imgs_u8.float()
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def _histeq_table(dev, launches, e2e_launches, scene_launches):
    """Phase 7: K6 against its plain version bit for bit on four inputs,
    and timed at 512² b8. Its least work is one read and one write of the
    luma, one byte each per pixel."""
    import torch

    from mingraph_unet_tpu_torch.ops.kernels import histeq

    g = torch.Generator(device=dev).manual_seed(11)
    orchard = _luma_u8(_train_batch(BATCH, SIZE, seed=8, dev=dev)[0])
    cases = {
        "orchard luma 512^2 b8": orchard,
        "constant": torch.full((2, 64, 64), 77, dtype=torch.uint8, device=dev),
        "two-valued": torch.where(torch.rand((2, 128, 96), generator=g, device=dev) < 0.3, 12, 200).to(torch.uint8),
        "odd shape": torch.randint(0, 256, (3, 37, 53), generator=g, device=dev).to(torch.uint8),
    }
    errs = {}
    for tag, y in cases.items():
        got = histeq.equalize_channel(y)
        ref = histeq.equalize_channel_plain(y)
        torch.cuda.synchronize()
        ok = torch.equal(got, ref)
        err = errs[tag] = (got.float() - ref.float()).abs().max().item()
        print(f"[chip_smoke] equalize_channel {tag} {tuple(y.shape)}: max_abs_err {err:.6g}, tolerance bit-equal: "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"equalize_channel disagrees with its plain version on the {tag} input")
    ms = _time_ms(lambda: histeq.equalize_channel(orchard), KERNEL_ITERS)
    plain_ms = _time_ms(lambda: histeq.equalize_channel_plain(orchard), KERNEL_ITERS)
    bound_ms = 2 * orchard.numel() / HBM_BYTES_PER_S * 1e3
    # A call is short enough that the wrapper's host work may set the timed
    # rate: the card's own time per call from torch.profiler beside it, and
    # the device operations a call, which must be the one kernel.
    device_ms, ops = _histeq_device(lambda: histeq.equalize_channel(orchard))
    scene = _luma_u8(torch.randint(0, 256, (1, SCENE, SCENE, 3), generator=g, device=dev).to(torch.uint8))
    if not torch.equal(histeq.equalize_channel(scene), histeq.equalize_channel_plain(scene)):
        _fail("equalize_channel disagrees with its plain version on the 1024^2 scene luma")
    scene_ms = _time_ms(lambda: histeq.equalize_channel(scene), KERNEL_ITERS)
    scene_device_ms, scene_ops = _histeq_device(lambda: histeq.equalize_channel(scene))
    for tag, n in (("512^2 b8", ops), ("1024^2 scene", scene_ops)):
        print(f"[chip_smoke] equalize_channel {tag}: {n} device operations a call (one kernel): "
              f"{'ok' if n == 1 else 'FAIL'}")
        if n != 1:
            _fail(f"equalize_channel at {tag} runs {n} device operations a call, not one kernel")
    print(f"[chip_smoke] equalize_channel {tuple(orchard.shape)}: {ms * 1e3:.1f} us/launch, device "
          f"{device_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.1f} us, library -, bound {bound_ms * 1e3:.2f} us "
          f"(bytes); scene {tuple(scene.shape)} (one cluster): {scene_ms * 1e3:.1f} us/launch, device "
          f"{scene_device_ms * 1e3:.2f} us")
    return [{
        "name": "equalize_channel", "route": "cuda", "source": "mingraph_unet_tpu_torch/csrc/histeq.cu",
        "replaces": f"{HISTEQ_SRC}:88", "launches": launches["histeq"], "launches_e2e": e2e_launches["histeq"],
        "launches_scene": scene_launches["histeq"],
        "shape": list(orchard.shape), "max_abs_err": errs["orchard luma 512^2 b8"], "ms": ms, "device_ms": device_ms,
        "device_ops": ops, "scene_ms": scene_ms, "scene_device_ms": scene_device_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None,
    }]


def _histeq_device(fn):
    """(device ms, device operations) a call of K6."""
    ops = _device_ops(fn, KERNEL_ITERS)
    return sum(t * n for _, t, n in ops) / 1e3, sum(n for _, _, n in ops)


def _d2s_table(dev, launches, scene_launches):
    """Phase 2 for K5: bit-equal to its plain version on five inputs (the
    three main-path shapes in bf16, one f32, one odd), then timed at the
    main-path shapes. Its least work is one read and one write of the
    tensor; the library call is the permuted view's ``.contiguous()``."""
    import torch

    from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
    from mingraph_unet_tpu_torch.ops.kernels import pool

    g = torch.Generator(device=dev).manual_seed(13)
    rnd = lambda s, dt: torch.randn(s, generator=g, device=dev).to(dt)  # noqa: E731
    sites = {  # name: (shape, launches of that site's run)
        "serving L1": ((BATCH, SIZE // 4, SIZE // 4, 256), launches),
        "scene L1": ((4, (TILE + 2 * HALO) // 4, (TILE + 2 * HALO) // 4, 256), scene_launches),
        "scene L0": ((4, (TILE + 2 * HALO) // 2, (TILE + 2 * HALO) // 2, 128), scene_launches),
    }
    cases = {f"{k} bf16": rnd(shape, torch.bfloat16) for k, (shape, _) in sites.items()}
    cases["scene L1 f32"] = rnd(sites["scene L1"][0], torch.float32)
    cases["odd f32"] = rnd((3, 5, 7, 64), torch.float32)
    errs = {}
    for tag, y in cases.items():
        got = pool.depth_to_space_kernel(y)
        ref = s2d_ops.depth_to_space(y)
        torch.cuda.synchronize()
        ok = got.dtype == ref.dtype and torch.equal(got, ref)
        err = errs[tag] = (got.float() - ref.float()).abs().max().item()
        print(f"[chip_smoke] depth_to_space {tag} {tuple(y.shape)}: max_abs_err {err:.6g}, tolerance bit-equal: "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"depth_to_space disagrees with its plain version on the {tag} input")
    rows = []
    for name, (shape, counts) in sites.items():
        y = cases[f"{name} bf16"]
        b, hh, ww, cc = y.shape
        ms = _time_ms(lambda: pool.depth_to_space_kernel(y), KERNEL_ITERS)
        plain_ms = _time_ms(lambda: s2d_ops.depth_to_space(y), KERNEL_ITERS)
        library_ms = _time_ms(lambda: y.view(b, hh, ww, 2, 2, cc // 4).permute(0, 1, 3, 2, 4, 5).contiguous(),
                              KERNEL_ITERS)
        bound_ms = 2 * y.numel() * y.element_size() / HBM_BYTES_PER_S * 1e3
        dev_ms = _device_ms(f"depth_to_space {name}", lambda: pool.depth_to_space_kernel(y))
        rows.append({
            "name": f"depth_to_space {name}", "route": "cuda", "source": "mingraph_unet_tpu_torch/csrc/d2s.cu",
            "replaces": f"{POOL_SRC}:168", "launches": counts["d2s"], "launches_serving": launches["d2s"],
            "launches_scene": scene_launches["d2s"], "shape": list(shape), "max_abs_err": errs[f"{name} bf16"],
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms,
        })
        print(f"[chip_smoke] depth_to_space {name} {tuple(shape)}: {ms * 1e3:.1f} us/launch, device "
              f"{dev_ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, library {library_ms * 1e3:.1f} us, bound "
              f"{bound_ms * 1e3:.1f} us (bytes)")
    return rows


def _capture_sites(model, x):
    """One serving forward of ``model`` on ``x`` that records what each U-Net
    conv site is given: every s2d ConvBlock (its input and, at a decoder
    level, the x_prev, ConvTranspose matmul and bias it folds in) with the
    input of its conv2 (K1's arguments), and the input of every
    standard-layout ConvBlock. Returns (s2d sites, standard sites) as
    (name, block, tensors) in call order."""
    import torch

    from mingraph_unet_tpu_torch.models import unet as unet_mod

    s2d_calls, psel_calls, std_calls = [], [], []
    real_s2d, real_psel = unet_mod.ConvBlock.forward_s2d, unet_mod.conv2_s2d

    def forward_s2d(block, inp, fused_up=None, spatial=None):
        s2d_calls.append((block, inp, fused_up))
        return real_s2d(block, inp, fused_up, spatial)

    def psel(inp, k, b):
        psel_calls.append((inp, k, b))
        return real_psel(inp, k, b)

    hooks = [m.register_forward_pre_hook(lambda mod, args: std_calls.append((mod, args[0])))
             for m in model.unet.modules() if isinstance(m, unet_mod.ConvBlock)]
    unet_mod.ConvBlock.forward_s2d, unet_mod.conv2_s2d = forward_s2d, psel
    try:
        with torch.no_grad():
            model(x)
        torch.cuda.synchronize()
    finally:
        unet_mod.ConvBlock.forward_s2d, unet_mod.conv2_s2d = real_s2d, real_psel
        for h in hooks:
            h.remove()
    if len(s2d_calls) != 4 or len(psel_calls) != 4 or len(std_calls) != 5:
        _fail(f"site capture: {len(s2d_calls)} s2d blocks, {len(psel_calls)} psel calls and {len(std_calls)} "
              f"standard blocks, expected 4, 4 and 5")
    s2d_sites = [(name, *call, psel_calls[i])
                 for i, (name, call) in enumerate(zip(("enc0", "enc1", "dec-L1", "dec-L0"), s2d_calls))]
    std_sites = [(name, *call) for name, call in zip(
        ("enc block2", "enc block3", "bottleneck", "dec block0", "dec block1"), std_calls)]
    return s2d_sites, std_sites


def _wconv_sites(s2d_sites):
    """K7's eight sites: (name, x_s2d, full-res kernel, bias, groups,
    what the serving forward runs there as a zero-argument function)."""
    import torch

    from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
    from mingraph_unet_tpu_torch.ops.kernels import psconv

    sites = []
    for name, block, inp, fused_up, (x2, k2, b2) in s2d_sites:
        dt = block.dtype
        k1, b1 = block.folded(1)
        if fused_up is None:
            x1, groups = s2d_ops.space_to_depth(inp.to(dt)), ()
            kw = s2d_ops.windowed_down_kernel(k1)
            full = inp.to(dt)
            model_fn = (lambda full=full, kw=kw, b1=b1: torch.relu(
                s2d_ops.conv3x3_windowed_down(full, kw) + s2d_ops.s2d_vector(b1).to(full.dtype)))
        else:
            x_prev, wt, bias_up = fused_up
            x_prev = x_prev.to(dt)
            skip_c = inp.shape[-1] // 4
            up = x_prev @ wt.to(dt) + s2d_ops.s2d_vector(bias_up).to(dt)  # the s2d ConvTranspose output
            x1, groups = torch.cat([inp.to(dt), up], dim=-1), (skip_c, k1.shape[2] - skip_c)
            k_skip, k_prev = psconv.dec_conv1_weights(k1, skip_c, wt)
            t9 = psconv.dec_conv1_bias_table(k1, skip_c, bias_up, b1)
            skip = inp.to(dt)
            model_fn = (lambda skip=skip, x_prev=x_prev, k_skip=k_skip, k_prev=k_prev, t9=t9:
                        psconv.dec_conv1_fused(skip, x_prev, k_skip, k_prev, t9))
        sites.append((f"{name} conv1", x1.contiguous(), k1, b1, groups, model_fn))
        sites.append((f"{name} conv2", x2, k2, b2, (), lambda x2=x2, k2=k2, b2=b2: psconv.psel_conv3x3(x2, k2, b2)))
    return sites


def _wconv_table(dev, s2d_sites, launches, scene_launches):
    """Phase 10: K7 at the eight s2d conv sites of the serving U-Net, on
    their captured bf16 activations and BN-folded weights, against its plain
    version (bf16 within CONV_TOL, and f32 within F32_TOL) and, at the four
    conv2 sites, against K1 (the same function) within CONV_TOL; f32 and
    bf16 at odd shapes; then timed beside its plain version, the library's
    one call (``F.conv2d`` with the dense s2d kernel, no bias or ReLU), what
    the serving forward runs at the site (K1, K2 or the windowed cuDNN
    conv) and, as context, the same conv at full resolution in cuDNN. Bound: x and y once in bf16 (and the bf16 weights) at
    3.35 TB/s against the conv's useful 2·9·Cin·Cout operations per
    full-res pixel at 989 bf16 TFLOP/s."""
    import torch
    import torch.nn.functional as F

    from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
    from mingraph_unet_tpu_torch.ops.kernels import psconv, wconv

    rows = []
    with torch.no_grad():
        for name, x1, k, bias, groups, model_fn in _wconv_sites(s2d_sites):
            b, hh, ww, c4 = x1.shape
            cin, cout = k.shape[2], k.shape[3]
            w2 = wconv.wconv3x3_weights(k)
            tag = f"wconv3x3_s2d {name} {tuple(x1.shape)} {cin}->{cout}{f' groups {groups}' if groups else ''}"
            got = wconv.wconv3x3_s2d(x1, w2, bias, groups)
            ref = wconv.wconv3x3_s2d_plain(x1.float(), w2.to(x1.dtype), bias, groups)
            torch.cuda.synchronize()
            err = _check_close(f"{tag} bf16", got, ref, CONV_TOL)
            _check_close(f"{tag} f32", wconv.wconv3x3_s2d(x1.float(), w2, bias, groups),
                         wconv.wconv3x3_s2d_plain(x1.float(), w2, bias, groups), F32_TOL)
            if name.endswith("conv2"):
                _check_close(f"{tag} vs K1", got, psconv.psel_conv3x3(x1, k, bias), CONV_TOL, what="K1")
            ms = _time_ms(lambda: wconv.wconv3x3_s2d(x1, w2, bias, groups), KERNEL_ITERS)
            plain_ms = _time_ms(lambda: wconv.wconv3x3_s2d_plain(x1, w2, bias, groups), KERNEL_ITERS)
            wd = s2d_ops.s2d_conv3x3_kernel(k, groups).to(x1.dtype).permute(3, 2, 0, 1).contiguous()
            xn = x1.permute(0, 3, 1, 2)
            library_ms = _time_ms(lambda: F.conv2d(xn, wd, padding=1), KERNEL_ITERS)
            model_ms = _time_ms(model_fn, KERNEL_ITERS)
            # The same conv at full resolution (each group's s2d part turned
            # back and concatenated): what a U-Net without the s2d lowering
            # would run at this site.
            offs = [0]
            for gw in groups or (cin,):
                offs.append(offs[-1] + 4 * gw)
            xf = torch.cat([s2d_ops.depth_to_space(x1[..., a:b_]) for a, b_ in zip(offs, offs[1:])], -1)
            xf = xf.contiguous().permute(0, 3, 1, 2)
            wf = k.to(x1.dtype).permute(3, 2, 0, 1).contiguous()
            fullres_ms = _time_ms(lambda: F.conv2d(xf, wf, padding=1), KERNEL_ITERS)
            compulsory = x1.numel() * 2 + b * hh * ww * 4 * cout * 2 + w2.numel() * 2 + cout * 4
            t_bytes = compulsory / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * b * (2 * hh) * (2 * ww) * 9 * cin * cout / BF16_TENSOR_FLOPS * 1e3
            # The windowed form's own floor: its 16/9 of the operations at the dense bf16 rate.
            form_ms = max(t_bytes, t_ops * 16 / 9)
            path = "wgmma" if wconv.wconv_uses_mma(x1.dtype) else "simt"
            call_ms, dev_ms = _device_ms(tag, lambda: wconv.wconv3x3_s2d(x1, w2, bias, groups),
                                         own="wconv_wgmma_kernel")
            lib_dev_ms = _device_ms(f"{tag} library", lambda: F.conv2d(xn, wd, padding=1))
            weight_l2 = _wconv_weight_l2_bytes(x1.shape, wconv.wgmma_weight_chunks(w2.to(x1.dtype), groups, cout))
            rows.append({
                "name": f"wconv3x3_s2d {name}", "route": "cuda", "source": "mingraph_unet_tpu_torch/csrc/wconv.cu",
                "replaces": f"{WCONV_SRC}:122", "launches": launches["wconv"],
                "launches_scene": scene_launches["wconv"], "shape": list(x1.shape), "groups": list(groups),
                "cout": cout, "path": path, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms, "serving_site_ms": model_ms, "fullres_cudnn_ms": fullres_ms,
                "device_ms": dev_ms, "call_device_ms": call_ms, "library_device_ms": lib_dev_ms,
            })
            print(f"[chip_smoke] wconv3x3_s2d {name} ({path}): {ms * 1e3:.1f} us/launch, "
                  f"plain {plain_ms * 1e3:.1f} us, "
                  f"library (dense s2d F.conv2d) {library_ms * 1e3:.1f} us, serving forward's op here "
                  f"{model_ms * 1e3:.1f} us, full-res cuDNN conv {fullres_ms * 1e3:.1f} us, bound {max(t_bytes, t_ops) * 1e3:.1f} us ({rows[-1]['bound_by']}), "
                  f"form floor {form_ms * 1e3:.1f} us; device {dev_ms * 1e3:.1f} us (call {call_ms * 1e3:.1f}), library "
                  f"device {lib_dev_ms * 1e3:.1f} us; weights L2 -> SM (from the tiling) {weight_l2 / 1e6:.1f} MB a call against "
                  f"{compulsory / 1e6:.1f} MB compulsory")

        # Odd shapes: Cin 5, groups (2, 4), the RGB input's Cin 3, odd Cout, odd W/2,
        # H/2 not a multiple of the tile, widths that are no multiple of 16.
        g = torch.Generator(device=dev).manual_seed(17)
        for b, hh, ww, cin, cout, groups in ((1, 5, 7, 5, 4, ()), (2, 9, 8, 6, 4, (2, 4)), (2, 7, 9, 3, 32, ()),
                                             (1, 5, 9, 5, 3, ()), (1, 6, 7, 6, 5, (2, 4)),
                                             (1, 6, 21, 64, 32, (32, 32)), (1, 5, 9, 80, 32, (16,) * 5),
                                             (1, 5, 9, 20, 8, (2, 3, 4, 5, 6)), (1, 4, 6, 256, 64, (128, 128)),
                                             (1, 4, 17, 512, 64, (256, 256))):
            x = torch.randn((b, hh, ww, 4 * cin), generator=g, device=dev)
            k = torch.randn((3, 3, cin, cout), generator=g, device=dev) * (1.0 / (9 * cin)) ** 0.5
            bias = torch.randn(cout, generator=g, device=dev)
            w2 = wconv.wconv3x3_weights(k)
            for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, CONV_TOL)):
                xd = x.to(dt)
                _check_close(f"wconv3x3_s2d odd {tuple(x.shape)} {cin}->{cout} groups {groups} {dt}",
                             wconv.wconv3x3_s2d(xd, w2, bias, groups),
                             wconv.wconv3x3_s2d_plain(xd.float(), w2.to(dt), bias, groups), tol)
    return rows


def _conv_block_l2_bytes(shape, c) -> int:
    """Bytes of weights the K8 kernel moves from L2 into shared memory a
    call, worked out from its tiling in ``csrc/conv_block.cu``, not read
    from the card: every block (an 8 × 16 output tile of one channel tile)
    streams its channel tile's whole hi/lo weight stream once
    (``conv_block.pack_weights``: 16 KB stages)."""
    from mingraph_unet_tpu_torch.ops.kernels import conv_block as cb

    b, h, w, cin = shape
    nt = cb.channel_tile(c)
    blocks = -(-c // nt) * b * -(-h // 8) * -(-w // 16)
    stages = -(-c // 64) * 9 * (-(-cin // 64) + nt // 64)
    return blocks * stages * cb.STAGE_BYTES


def _conv_block_table(dev, std_sites, f32_sites, launches, scene_launches, f32_launches):
    """Phase 11: K8 at the five standard-layout ConvBlocks of the serving
    U-Net, on their captured bf16 inputs, with each block's own conv kernels
    and ``fold_bn`` of its conv biases and BN: against its plain version
    (f32 cuDNN, TF32 off) within CONV_TOL, and against the block's own
    ``ConvBlock.forward`` (bf16 folded weights, bf16 h, cuDNN) within
    BLOCK_TOL; f32 at small odd shapes within F32_TOL (Cin 1 and 3, every
    b1 > 0 in four of them, every channel tile, C 1024 and 600 in several
    tiles); then timed beside its plain version (few launches: the f32
    cuDNN pair takes up to ~27 ms a call) and, as context, the block's two
    bf16 cuDNN convs, with the kernel's device time (torch.profiler). Bound:
    x and y once, f32 weights, against the split form's operations at the
    bf16 tensor rate (989 TFLOP/s): the function is f32 inside, and the
    least work that computes it to f32 accuracy on the tensor cores is two
    bf16 products a conv1 term of bf16 x and three a conv2 term, 2·9·(2·Cin·C
    + 3·C·C) operations per pixel. Beside it, on the printed line only
    (worked out, not measured): the f32-FMA figure, 2·9·(Cin·C + C·C)
    operations per pixel at 67 TFLOP/s (what a SIMT kernel could reach, and
    the kernel beats), and the weight bytes its tiling moves from L2. The
    row's launches a forward: the bf16 serving forward and scene (0) and the
    f32 serving forward (``f32_launches``: 5).

    Then K8 as the f32 eval forward runs it (``f32_sites``: the five blocks'
    inputs captured from the f32 serving model at 512² b8, the call's
    arguments ``ConvBlock.scale_shift`` as the block passes them): against
    its plain version (TF32 off) within F32_TOL and against the block's own
    ``ConvBlock.forward`` (the same dispatch) within F32_TOL, timed beside
    its plain version, with the kernel's device time; bound: x and y once in
    f32, f32 weights, against the split form's operations for f32 x, three
    bf16 products a term of both convs, 2·9·(3·Cin·C + 3·C·C) operations per
    pixel at 989 TFLOP/s. Its rows are ``fused_conv_block f32 <site>``, with
    the f32 serving forward's launches."""
    import torch

    from mingraph_unet_tpu_torch.ops.kernels import conv_block as cb

    rows = []
    with torch.no_grad():
        for name, block, x in std_sites:
            args = []
            for conv, bn in ((block.conv1, block.bn1), (block.conv2, block.bn2)):
                s, b = cb.fold_bn(conv.bias, bn.scale, bn.bias, bn.mean, bn.var, bn.epsilon)
                args += [conv.kernel, s, b]
            bn_, h, w, cin = x.shape
            c = block.conv1.kernel.shape[-1]
            tag = f"fused_conv_block {name} {tuple(x.shape)} {cin}->{c}"
            got = cb.fused_conv_block(x, *args)
            torch.backends.cudnn.allow_tf32 = False
            ref = cb.fused_conv_block_plain(x.float(), *args)
            torch.cuda.synchronize()
            err = _check_close(f"{tag} bf16", got, ref, CONV_TOL)
            plain_ms = _time_ms(lambda: cb.fused_conv_block_plain(x, *args), K8_ITERS)
            torch.backends.cudnn.allow_tf32 = True
            _check_close(f"{tag} vs the block's ConvBlock.forward", got, block(x), BLOCK_TOL, what="ConvBlock.forward")
            ms = _time_ms(lambda: cb.fused_conv_block(x, *args), KERNEL_ITERS)
            call_ms, dev_ms = _device_ms(tag, lambda: cb.fused_conv_block(x, *args), own="conv_block_kernel")
            pair_ms = _time_ms(lambda: block(x), KERNEL_ITERS)
            px = bn_ * h * w
            fma_ms = 2 * px * 9 * (cin * c + c * c) / F32_SIMT_FLOPS * 1e3
            t_bytes = (x.numel() * 2 + px * c * 2 + 9 * (cin * c + c * c) * 4 + 4 * c * 4) / HBM_BYTES_PER_S
            t_bytes *= 1e3
            t_ops = 2 * px * 9 * (2 * cin * c + 3 * c * c) / BF16_TENSOR_FLOPS * 1e3
            l2 = _conv_block_l2_bytes(tuple(x.shape), c)
            rows.append({
                "name": f"fused_conv_block {name}", "route": "cuda",
                "source": "mingraph_unet_tpu_torch/csrc/conv_block.cu", "replaces": f"{CONV_BLOCK_SRC}:135",
                "launches": launches["conv_block"], "launches_scene": scene_launches["conv_block"],
                "launches_f32": f32_launches["conv_block"],
                "shape": list(x.shape), "cout": c, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                "call_device_ms": call_ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, "context_cudnn_pair_bf16_ms": pair_ms,
            })
            print(f"[chip_smoke] fused_conv_block {name}: {ms * 1e3:.1f} us/launch, device {dev_ms * 1e3:.1f} us "
                  f"(call {call_ms * 1e3:.1f}: the wrapper's split and packing), plain (f32 cuDNN, TF32 off) "
                  f"{plain_ms * 1e3:.1f} us, library -, context: the block's two bf16 cuDNN convs "
                  f"{pair_ms * 1e3:.1f} us; bound {max(t_bytes, t_ops) * 1e3:.1f} us ({rows[-1]['bound_by']}; the "
                  f"bf16 split's products at 989 TFLOP/s {t_ops * 1e3:.1f} us), f32-FMA figure {fma_ms * 1e3:.1f} us "
                  f"(67 TFLOP/s, context only); weights L2 -> SM (from the tiling) {l2 / 1e6:.1f} MB a call")

        torch.backends.cudnn.allow_tf32 = False
        for name, block, x in f32_sites:
            args = [t for i in (1, 2) for t in block.scale_shift(i)]
            x = x.contiguous()
            bn_, h, w, cin = x.shape
            c = block.conv1.kernel.shape[-1]
            tag = f"fused_conv_block f32 {name} {tuple(x.shape)} {cin}->{c}"
            got = cb.fused_conv_block(x, *args)
            err = _check_close(tag, got, cb.fused_conv_block_plain(x, *args), F32_TOL)
            _check_close(f"{tag} vs the block's ConvBlock.forward", got, block(x), F32_TOL, what="ConvBlock.forward")
            plain_ms = _time_ms(lambda: cb.fused_conv_block_plain(x, *args), K8_ITERS)
            ms = _time_ms(lambda: cb.fused_conv_block(x, *args), KERNEL_ITERS)
            call_ms, dev_ms = _device_ms(tag, lambda: cb.fused_conv_block(x, *args), own="conv_block_kernel")
            px = bn_ * h * w
            t_bytes = (x.numel() * 4 + px * c * 4 + 9 * (cin * c + c * c) * 4 + 4 * c * 4) / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * px * 9 * (3 * cin * c + 3 * c * c) / BF16_TENSOR_FLOPS * 1e3
            rows.append({
                "name": f"fused_conv_block f32 {name}", "route": "cuda",
                "source": "mingraph_unet_tpu_torch/csrc/conv_block.cu", "replaces": f"{CONV_BLOCK_SRC}:135",
                "launches": launches["conv_block"], "launches_scene": scene_launches["conv_block"],
                "launches_f32": f32_launches["conv_block"],
                "shape": list(x.shape), "cout": c, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                "call_device_ms": call_ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
            })
            print(f"[chip_smoke] fused_conv_block f32 {name}: {ms * 1e3:.1f} us/launch, device {dev_ms * 1e3:.1f} us "
                  f"(call {call_ms * 1e3:.1f}), plain (f32 cuDNN, TF32 off) {plain_ms * 1e3:.1f} us, library -; "
                  f"bound {max(t_bytes, t_ops) * 1e3:.1f} us ({rows[-1]['bound_by']}; the split's three products a "
                  f"term at 989 TFLOP/s {t_ops * 1e3:.1f} us); device / bound {dev_ms / max(t_bytes, t_ops):.2f}")
        torch.backends.cudnn.allow_tf32 = True

        g = torch.Generator(device=dev).manual_seed(19)
        torch.backends.cudnn.allow_tf32 = False
        for b, h, w, cin, c, positive_b1 in ((1, 9, 7, 1, 8, True), (2, 13, 11, 3, 32, True),
                                             (1, 11, 19, 16, 64, False), (1, 10, 6, 64, 128, True),
                                             (1, 5, 9, 96, 256, False), (1, 6, 5, 256, 512, False),
                                             (1, 4, 6, 512, 1024, False), (2, 5, 3, 40, 600, True)):
            x = torch.randn((b, h, w, cin), generator=g, device=dev)
            w1 = torch.randn((3, 3, cin, c), generator=g, device=dev) * (2.0 / (9 * cin)) ** 0.5
            w2 = torch.randn((3, 3, c, c), generator=g, device=dev) * (2.0 / (9 * c)) ** 0.5
            s1, s2 = torch.rand(c, generator=g, device=dev) + 0.5, torch.rand(c, generator=g, device=dev) + 0.5
            b1 = (torch.rand(c, generator=g, device=dev) + 0.5 if positive_b1
                  else torch.randn(c, generator=g, device=dev) * 0.1)
            b2 = torch.randn(c, generator=g, device=dev) * 0.1
            _check_close(f"fused_conv_block odd f32 {tuple(x.shape)} {cin}->{c}{' b1 > 0' if positive_b1 else ''}",
                         cb.fused_conv_block(x, w1, s1, b1, w2, s2, b2),
                         cb.fused_conv_block_plain(x, w1, s1, b1, w2, s2, b2), F32_TOL)
        torch.backends.cudnn.allow_tf32 = True
    return rows


def _k10_step(dev, remat: bool = False):
    """The U-Net trainer's f32 step at 512² b16, the ``unet_f32.train_b16``
    cell's setting (``configs/*.yaml``'s model, Adam lr 1e-3 weight decay
    1e-4, augmentation) on a seeded batch: (model, one step's call)."""
    import torch

    from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer
    from mingraph_unet_tpu_torch.train.segmentation import build_unet, make_train_step

    cfg = _train_cfg(SIZE, bf16=False)
    cfg.model.unet.remat = remat
    model = build_unet(cfg)
    state = TrainState(model, *make_optimizer(model.parameters(), cfg.training, steps_per_epoch=1000))
    step = make_train_step(cfg, augment=True)
    imgs, masks = _train_batch(K10_BATCH, SIZE, seed=5, dev=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    return model, lambda: step(state, imgs, masks, gen)


def _k10_capture(step):
    """The ten standard-block convs of one step, in forward order: each
    call's input, kernel and bias and the cotangent its output receives
    (a spy on ``ops/kernels/conv3x3.py::conv3x3_train``)."""
    import torch

    from mingraph_unet_tpu_torch.ops.kernels import conv3x3 as c3

    sites, real = [], c3.conv3x3_train

    def spy(x, kernel, bias):
        y = real(x, kernel, bias)
        site = {"x": x.detach().clone(), "k": kernel.detach().clone(), "b": bias.detach().clone()}
        y.register_hook(lambda g, site=site: site.__setitem__("g", g.detach().contiguous().clone()))
        sites.append(site)
        return y

    c3.conv3x3_train = spy
    try:
        step()
        torch.cuda.synchronize()
    finally:
        c3.conv3x3_train = real
    if len(sites) != len(K10_SITES) or not all("g" in site for site in sites):
        _fail(f"phase 19: captured {len(sites)} standard-block train convs, expected {len(K10_SITES)} with cotangents")
    return sites


def _k10_account(step, sites, label: str):
    """One route's step: ms a step by CUDA events over ``K10_STEPS`` steps,
    then ``K10_STEPS`` profiled: the forward's device ms at levels 2-4 (the
    ``mgu.unet.*`` ranges), the device ms of cuDNN's
    ``aten::convolution_backward`` at the ten sites' shapes (dgrad and
    wgrad on cuDNN; wgrad alone with K10) and of K10's kernels outside the
    forward's ranges (its dgrad). Printed and returned, ms a step."""
    import json
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity

    ms = _time_ms(step, K10_STEPS)
    with _warm_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        for _ in range(K10_STEPS):
            step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    levels, by_op = sys.modules["_smoke_profiling"].device_ms_by_range(events, "mgu.unet.", K10_STEPS)
    fwd = {lv[9:]: levels[lv] for lv in K10_LEVELS}
    k10_fwd = sum(v for (lv, op), v in by_op.items() if lv in K10_LEVELS and "conv3x3_kernel" in op)
    k10_dgrad = sum(v for (lv, op), v in by_op.items() if lv == "outside" and "conv3x3_kernel" in op)
    shapes = {(tuple(s["x"].permute(0, 3, 1, 2).shape), (s["k"].shape[3], s["k"].shape[2], 3, 3)) for s in sites}
    bwd = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        ins = e.input_shapes
        if e.key == "aten::convolution_backward" and len(ins) > 2 and (tuple(ins[1]), tuple(ins[2])) in shapes:
            bwd += e.device_time_total / 1e3 / K10_STEPS
    out = {"step_ms": ms, "forward_levels_ms": fwd, "forward_ms": sum(fwd.values()), "k10_forward_ms": k10_fwd,
           "cudnn_backward_ms": bwd, "k10_dgrad_ms": k10_dgrad}
    print(f"[chip_smoke] phase 19 {label}: {ms:.3f} ms a step; levels 2-4 forward {out['forward_ms']:.3f} device ms "
          f"({', '.join(f'{k} {v:.3f}' for k, v in fwd.items())}; K10 {k10_fwd:.3f}); backward at the ten sites: "
          f"cuDNN convolution_backward {bwd:.3f}, K10 dgrad {k10_dgrad:.3f}")
    for (lv, op), v in sorted(by_op.items(), key=lambda kv: -kv[1]):
        if lv in K10_LEVELS and v >= 0.05:
            print(f"[chip_smoke]   {lv[9:]:10s} {v:8.3f} ms  {op[:90]}")
    return out


def _k10_site_rows(sites, names, per_step, label: str):
    """K10 at captured conv sites (each its input, kernel, bias and
    cotangent): forward and dgrad against their plain versions within
    ``F32_TOL``, whole output and borders; each timed (µs a call by CUDA
    events, the kernel's and the call's device µs, host µs a call) beside
    the plain version, the library (``F.conv2d``; dgrad:
    ``aten.convolution_backward`` for the input alone, as autograd makes it)
    by events and device time, and the split form's bound: x in and y out
    at 3.35 TB/s against three bf16 products of 2·9·Cin·Cout operations a
    pixel at 989 TFLOP/s, the f32 FMA figure (67 TFLOP/s) printed beside
    it; where the widths are not multiples of 64, also the bound of the
    work padded to the wide tile (Cin and Cout to multiples of 64). Prints
    the sums as ``k10_<kind>_<label>``; returns the kernels line's rows."""
    import torch
    import torch.nn.functional as F

    from mingraph_unet_tpu_torch.ops.kernels import conv3x3 as c3

    rows, sums = [], {"fwd": [0.0, 0.0, 0.0, 0.0], "dgrad": [0.0, 0.0, 0.0, 0.0]}
    for name, site in zip(names, sites):
        x, k, b, g = site["x"], site["k"], site["b"], site["g"]
        bn_, h, w, cin = x.shape
        cout = k.shape[-1]
        px = bn_ * h * w
        xn, kn, gn = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2)
        for kind in ("fwd", "dgrad"):
            if kind == "fwd":
                fn, plain = (lambda: c3.conv3x3_fwd(x, k, b)), (lambda: c3.conv3x3_plain(x, k, b))
                lib = lambda: F.conv2d(xn, kn, b, padding=1)  # noqa: E731
                inp, out_c = x, cout
            else:
                fn, plain = (lambda: c3.conv3x3_dgrad(g, k)), (lambda: c3.conv3x3_dgrad_plain(g, k))
                lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
                    gn, xn, kn, [cout], [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, False, False])[0]
                inp, out_c = g, cin
            in_c = inp.shape[-1]
            tag = f"conv3x3_{kind} {name} {tuple(inp.shape)} -> {out_c}"
            narrow = getattr(c3, f"conv3x3_{kind}").narrow
            err = _check_close(tag, fn(), plain(), F32_TOL)
            tile = "narrow" if getattr(c3, f"conv3x3_{kind}").narrow > narrow else "wide"
            if (tile == "narrow") != (c3.tile(in_c, out_c)[0] in c3.NARROW):
                _fail(f"{tag}: launched the {tile} tile, expected NT {c3.tile(in_c, out_c)[0]}")
            ms = _time_ms(fn, KERNEL_ITERS)
            call_ms, dev_ms, ops = _device_ms(tag, fn, own="conv3x3_kernel", count=True)
            host_us = _host_us(fn, 50)
            plain_ms = _time_ms(plain, KERNEL_ITERS)
            lib_ms = _time_ms(lib, KERNEL_ITERS)
            lib_dev_ms = _device_ms(f"{tag} library", lib)
            t_ops = 3 * 2 * px * 9 * cin * cout / BF16_TENSOR_FLOPS * 1e3
            t_bytes = (4 * px * (cin + cout) + 9 * cin * cout * 4) / HBM_BYTES_PER_S * 1e3
            padded = 3 * 2 * px * 9 * -(-in_c // 64) * 64 * -(-out_c // 64) * 64 / BF16_TENSOR_FLOPS * 1e3
            fma_ms = 2 * px * 9 * cin * cout / F32_SIMT_FLOPS * 1e3
            bound = max(t_ops, t_bytes)
            for i, v in enumerate((dev_ms, bound, lib_dev_ms, max(padded, t_bytes))):
                sums[kind][i] += v
            rows.append({
                "name": f"conv3x3_{kind} {name}", "route": "cuda", "source": "mingraph_unet_tpu_torch/csrc/conv3x3.cu",
                "replaces": None, "launches_f32_step": per_step[f"k10_{kind}"], "shape": list(inp.shape),
                "cout": out_c, "tile": tile, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                "call_device_ms": call_ms, "device_ops": ops, "host_us": host_us, "plain_ms": plain_ms,
                "library_ms": lib_ms, "library_device_ms": lib_dev_ms, "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bound_padded_ms": max(padded, t_bytes),
            })
            print(f"[chip_smoke] {tag} ({tile} tile): {ms * 1e3:.1f} us/launch, device {dev_ms * 1e3:.1f} us (call "
                  f"{call_ms * 1e3:.1f} in {ops} ops: the packing), host {host_us:.1f} us; plain {plain_ms * 1e3:.1f} "
                  f"us, library {lib_ms * 1e3:.1f} / {lib_dev_ms * 1e3:.1f} us; bound {bound * 1e3:.1f} us "
                  f"({rows[-1]['bound_by']}), padded to the wide tile {max(padded, t_bytes) * 1e3:.1f} us; "
                  f"device / bound {dev_ms / bound:.2f}; f32 FMA figure {fma_ms * 1e3:.1f} us (context)")
    for kind, (dev_ms, bound, lib_dev_ms, padded) in sums.items():
        print(f"[chip_smoke] k10_{kind}_{label} device {dev_ms:.4f} ms, bound {bound:.4f} ms "
              f"({dev_ms / bound:.2f}x), padded bound {padded:.4f} ms, library device {lib_dev_ms:.4f} ms")
    return rows


def _device_ms_under(events, want, steps: int):
    """ms a step by name of the device operations that the host ops for
    which ``want(op)`` holds launched, in the trace ``events``: a kernel is
    tied by its ``correlation`` to its runtime call, and that to the host
    op on the same thread whose span holds it."""
    import collections

    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X" and want(e)]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    out: collections.Counter = collections.Counter()
    for k in events:
        if k.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        r = calls.get(k.get("args", {}).get("correlation"))
        if r is not None and any(o["tid"] == r["tid"] and o["ts"] <= r["ts"] <= o["ts"] + o.get("dur", 0)
                                 for o in ops):
            out[k["name"]] += k.get("dur", 0) / 1e3 / steps
    return out


def _k10_e2e_step(dev):
    """The end-to-end trainer's f32 step at 512² b16, the
    ``mgu_e2e_f32.e2e_b16`` cell's setting (``configs/*.yaml``'s model with
    the full-resolution detection head, Adam, augmentation) on a seeded
    batch: (model, one step's call)."""
    import torch

    from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer
    from mingraph_unet_tpu_torch.train.end_to_end import build_mingraph_unet, make_e2e_train_step

    cfg = _train_cfg(SIZE, bf16=False)
    model = build_mingraph_unet(cfg)
    opt, sched = make_optimizer(model.parameters(), cfg.training, steps_per_epoch=1000)
    state = TrainState(model, opt, sched)
    step = make_e2e_train_step(model, opt, cfg, augment=True, train_detection=True)
    imgs, masks = _train_batch(K10_BATCH, SIZE, seed=9, dev=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    return model, lambda: step(state, imgs, masks, gen)


def _k10_head_account(step, sites, label: str):
    """One route of the detection head's convs in the e2e step: ms a step
    by CUDA events over ``K10_STEPS`` steps, then ``K10_STEPS`` profiled:
    the head's forward device ms (the ``mgu.detection`` range) by
    operation, its K10 dgrad (the narrow tile's kernels outside that
    range) and the device operations that ``aten::convolution_backward``
    launched at the head's weight shapes (dX and dW on cuDNN; dW alone with
    K10) by name. Printed and returned, ms a step."""
    import json
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity

    ms = _time_ms(step, K10_STEPS)
    with _warm_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        for _ in range(K10_STEPS):
            step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ranges, by_op = sys.modules["_smoke_profiling"].device_ms_by_range(events, "mgu.detection", K10_STEPS)
    head_fwd = sum(v for name, v in ranges.items() if name != "outside")
    dgrad = sum(v for (rng, op), v in by_op.items() if rng == "outside" and K10_NARROW.search(op))
    weights = [[s["k"].shape[3], s["k"].shape[2], 3, 3] for s in sites]
    bwd = _device_ms_under(events, lambda e: e["name"] == "aten::convolution_backward"
                           and len(e.get("args", {}).get("Input Dims", [])) > 2
                           and e["args"]["Input Dims"][2] in weights, K10_STEPS)
    out = {"step_ms": ms, "head_forward_ms": head_fwd, "k10_dgrad_ms": dgrad,
           "convolution_backward_ms": sum(bwd.values())}
    print(f"[chip_smoke] phase 19 e2e {label}: {ms:.3f} ms a step; the head's forward {head_fwd:.3f} device ms, "
          f"K10 dgrad {dgrad:.3f}, convolution_backward at the head's shapes {out['convolution_backward_ms']:.3f}")
    for (rng, op), v in sorted(by_op.items(), key=lambda kv: -kv[1]):
        if rng != "outside" and v >= 0.05:
            print(f"[chip_smoke]   head forward {v:8.3f} ms  {op[:100]}")
    for op, v in sorted(bwd.items(), key=lambda kv: -kv[1]):
        print(f"[chip_smoke]   head convolution_backward {v:8.3f} ms  {op[:100]}")
    return out


def _k10_head_path(dev):
    """Phase 19, the end-to-end step (``mgu_e2e_f32.e2e_b16``'s setting):
    (a) its launches a step: K10 forward 12 and dgrad 12, of them the
    narrow tile 2 + 2 (the detection head's convs) and the ten standard
    sites' 10 + 10 wide, K4 4 + 4, hist-eq 1, nothing else. (b) The head's
    two convs, on the inputs, weights and cotangents one step gives them,
    as ``_k10_site_rows`` holds and times the standard sites. (c) The step
    with the head's convs on cuDNN (``conv2d_nhwc``, as before) and on K10
    (``_k10_head_account``). Returns the kernels line's rows."""
    import torch

    from mingraph_unet_tpu_torch.models import detection
    from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc
    from mingraph_unet_tpu_torch.ops.kernels import conv3x3 as c3

    model, step = _k10_e2e_step(dev)
    step()
    torch.cuda.synchronize()
    _reset_counts()
    narrow = (c3.conv3x3_fwd.narrow, c3.conv3x3_dgrad.narrow)
    step()
    torch.cuda.synchronize()
    got = (_counts(), c3.conv3x3_fwd.narrow - narrow[0], c3.conv3x3_dgrad.narrow - narrow[1])
    want = (dict({k: 0 for k in _wrappers()}, k4_fwd=4, k4_dgrad=4, histeq=1, **K10_E2E_STEP), 2, 2)
    if got != want:
        _fail(f"phase 19: the f32 e2e 512² b{K10_BATCH} step launched {got[0]}, narrow {got[1]} + {got[2]}; "
              f"expected {want[0]}, narrow 2 + 2")
    print(f"[chip_smoke] phase 19: f32 e2e 512² b{K10_BATCH} step: K10 forward {K10_E2E_STEP['k10_fwd']} and "
          f"dgrad {K10_E2E_STEP['k10_dgrad']} launches a step, the narrow tile 2 + 2 (the head), wide 10 + 10")

    sites, real = [], c3.conv3x3_train

    def spy(x, kernel, bias):
        y = real(x, kernel, bias)
        if c3.tile(x.shape[-1], kernel.shape[-1])[0] in c3.NARROW:
            site = {"x": x.detach().clone(), "k": kernel.detach().clone(), "b": bias.detach().clone()}
            y.register_hook(lambda g, site=site: site.__setitem__("g", g.detach().contiguous().clone()))
            sites.append(site)
        return y

    c3.conv3x3_train = spy
    try:
        step()
        torch.cuda.synchronize()
    finally:
        c3.conv3x3_train = real
    if len(sites) != len(K10_HEAD_SITES) or not all("g" in site for site in sites):
        _fail(f"phase 19: captured {len(sites)} narrow train convs, expected the head's {len(K10_HEAD_SITES)}")
    real_same = detection.conv3x3_same
    detection.conv3x3_same = lambda x, k, b: conv2d_nhwc(x, k, b, padding=1)
    try:
        before = _k10_head_account(step, sites, "the head's convs on cuDNN (before)")
    finally:
        detection.conv3x3_same = real_same
    after = _k10_head_account(step, sites, "the head's convs on K10 (after)")
    print(f"[chip_smoke] k10_head_step_ms before {before['step_ms']:.3f} after {after['step_ms']:.3f}; the head's "
          f"forward {before['head_forward_ms']:.3f} -> {after['head_forward_ms']:.3f} device ms; its conv backward "
          f"{before['convolution_backward_ms']:.3f} -> {after['k10_dgrad_ms'] + after['convolution_backward_ms']:.3f} "
          f"(K10 dgrad {after['k10_dgrad_ms']:.3f} + cuDNN wgrad {after['convolution_backward_ms']:.3f})")
    del model, step
    torch.cuda.empty_cache()
    return _k10_site_rows(sites, K10_HEAD_SITES, K10_E2E_STEP, "head")


def _conv3x3_path(dev):
    """Phase 19: K10, the split-form train conv, at the f32 U-Net step of the
    ``unet_f32.train_b16`` cell (512² b16, TF32 off). (a) Its launches a
    step: forward 10 and dgrad 10 (K4 4 + 4, nothing else), with remat
    forward 20 and dgrad 10 (K4 8 + 4). (b) At the ten standard-block
    convs, on the inputs, weights and cotangents one step gives them
    (``_k10_site_rows``). (c) The step before and after: the standard
    blocks' train convs on cuDNN (the dispatch's device check patched to
    false), then on K10 (``_k10_account``). (d) The end-to-end step's
    detection head on the narrow tile (``_k10_head_path``). Returns the
    kernels line's rows."""
    import torch

    from mingraph_unet_tpu_torch.ops.kernels import conv3x3 as c3

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    for remat in (True, False):
        model, step = _k10_step(dev, remat)
        step()
        torch.cuda.synchronize()
        _reset_counts()
        step()
        torch.cuda.synchronize()
        # Remat runs every block's forward again in the backward: K4's and
        # K10's forward twice, their dgrad once.
        want = dict({k: 0 for k in _wrappers()}, k4_fwd=8 if remat else 4, k4_dgrad=4, k10_fwd=20 if remat else 10,
                    k10_dgrad=10)
        if _counts() != want:
            _fail(f"phase 19: the f32 512² b{K10_BATCH} step{' with remat' if remat else ''} launched {_counts()}, "
                  f"expected {want}")
        print(f"[chip_smoke] phase 19: f32 512² b{K10_BATCH} step{' with remat' if remat else ''}: K10 forward "
              f"{want['k10_fwd']} and dgrad {want['k10_dgrad']} launches a step")
        if remat:
            del model, step
            torch.cuda.empty_cache()
    sites = _k10_capture(step)
    real = c3.split_conv
    c3.split_conv = lambda x: False
    try:
        before = _k10_account(step, sites, "standard blocks' train convs on cuDNN (before)")
    finally:
        c3.split_conv = real
    after = _k10_account(step, sites, "standard blocks' train convs on K10 (after)")
    print(f"[chip_smoke] k10_step_ms before {before['step_ms']:.3f} after {after['step_ms']:.3f}; levels 2-4 forward "
          f"{before['forward_ms']:.3f} -> {after['forward_ms']:.3f} device ms; their dgrad + wgrad "
          f"{before['cudnn_backward_ms']:.3f} -> {after['k10_dgrad_ms'] + after['cudnn_backward_ms']:.3f} "
          f"(K10 dgrad {after['k10_dgrad_ms']:.3f} + cuDNN wgrad {after['cudnn_backward_ms']:.3f})")
    del model, step
    torch.cuda.empty_cache()

    rows = _k10_site_rows(sites, K10_SITES, K10_STEP, "ten_sites")
    del sites
    torch.cuda.empty_cache()
    rows += _k10_head_path(dev)
    torch.backends.cudnn.allow_tf32 = tf32
    return rows


def _check_decode(boxes, scores, valid, size: int) -> None:
    """Valid boxes ordered, centred in the scene and no larger than it;
    invalid slots zero."""
    import torch

    x1, y1, x2, y2 = boxes.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    ok = ((x1 <= x2) & (y1 <= y2) & (cx >= 0) & (cx <= size) & (cy >= 0) & (cy <= size)
          & (x2 - x1 <= size) & (y2 - y1 <= size) & (scores >= 0.5))
    if not bool(torch.where(valid, ok, True).all()):
        _fail("a valid decoded box is unordered, centred outside the scene or larger than it")
    if bool(boxes[~valid].any()) or bool(scores[~valid].any()):
        _fail("an invalid decoded slot holds a non-zero box or score")


def _large_scene(dev):
    """Phase 9: the 1024² large-scene forward with the dense head and its
    decode on the card. Returns the launch counts, ms/scene, the host's
    issue time and the peak memory."""
    import torch

    from mingraph_unet_tpu_torch.models.detection import decode_dense_detections
    from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
    from mingraph_unet_tpu_torch.train.infer import pipeline_forward_large

    model = MinGraphUNet(dtype=torch.bfloat16, detection_pre_pool=32, use_dense_detection=True, device=dev, seed=0)
    _perturb_bn(model, seed=1)
    scene = _images(1, SCENE, seed=12).to(dev)
    patch = model.patch_size

    def serve():
        out = pipeline_forward_large(model, scene, tile=TILE, halo=HALO)
        det = decode_dense_detections(out["dense_objectness_logits"], out["dense_boxes"], (SCENE, SCENE),
                                      cell_size=patch, top_k=32, score_threshold=0.5, iou_threshold=0.5)
        return out, det

    _reset_counts()
    out, (boxes, scores, valid) = serve()
    count = valid.sum(-1)
    torch.cuda.synchronize()
    launches = _counts()
    print(f"[chip_smoke] large-scene launches: {launches}")
    if launches != {"psel": 4, "dec1": 2, "pool": 2, "d2s": 2, "k4_fwd": 0, "k4_dgrad": 0, "histeq": 1,
                    "wconv": 0, "conv_block": 0, "k9": 0, "dec1_halo": 0,
                    "k4_fwd_halo": 0, "k4_dgrad_halo": 0, "k10_fwd": 0, "k10_dgrad": 0}:
        _fail(f"expected psel 4, dec1 2, pool 2, d2s 2, histeq 1 and no K4, K7, K8, K9 or sharded K2 launches "
              f"per scene, "
              f"got {launches}")
    g = SCENE // patch
    expect = {"logits": (1, SCENE, SCENE, 2), "pred_bboxes": (1, 4), "pred_confidence": (1, 1), "l_partition": (1,),
              "soft_assignments": (1, g, g, 2), "dense_objectness_logits": (1, g, g), "dense_boxes": (1, g, g, 4)}
    for k, shape in expect.items():
        if tuple(out[k].shape) != shape:
            _fail(f"{k}: shape {tuple(out[k].shape)}, expected {shape}")
    bad = [k for k, v in out.items() if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    if bad:
        _fail(f"large-scene outputs not finite: {bad}")
    _check_decode(boxes, scores, valid, SCENE)
    plain = decode_dense_detections(out["dense_objectness_logits"].cpu(), out["dense_boxes"].cpu(), (SCENE, SCENE),
                                    cell_size=patch, top_k=32, score_threshold=0.5, iou_threshold=0.5)
    same = all(torch.equal(a.cpu(), b) for a, b in zip((boxes, scores, valid), plain))
    print(f"[chip_smoke] bf16 {SCENE}^2 scene: all outputs finite; {int(count[0])} of 32 detections valid; "
          f"card decode equal to the CPU plain decode bit for bit: {'ok' if same else 'FAIL'}")
    if not same:
        _fail("the card's dense decode differs from the plain decode on the CPU")

    sink = torch.zeros((), device=dev)

    def step():
        o, (bx, sc, va) = serve()
        sink.add_(o["logits"].sum() + o["pred_confidence"].sum() + sc.sum() + va.sum())

    for _ in range(SCENE_WARMUP):
        step()
    torch.cuda.reset_peak_memory_stats()
    ms = _time_ms(step, SCENE_ITERS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SCENE_ITERS):
        step()
    host_ms = (time.perf_counter() - t0) * 1e3 / SCENE_ITERS
    torch.cuda.synchronize()
    mpix = SCENE * SCENE / 1e6
    print(f"[chip_smoke] large scene bf16 {SCENE}^2 (tile {TILE}, halo {HALO}, dense head and decode): {ms:.3f} "
          f"ms/scene, {mpix / ms * 1e3:.2f} megapixels/s, host issue time {host_ms:.3f} ms/scene, peak memory "
          f"{peak:.2f} GiB")
    _profile("large scene", step, ms, steps=3)
    del model, scene, out
    torch.cuda.empty_cache()
    _large_scene_vs_cpu(dev)
    return launches, ms, host_ms, peak


def _large_scene_vs_cpu(dev) -> None:
    """Phase 9, card vs CPU: the large-scene forward in f32 (TF32 off) at a
    256² scene, tile 128, halo 32, full widths with the dense head and two
    detection classes, on the card and on the CPU with the same weights."""
    import torch

    from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
    from mingraph_unet_tpu_torch.train.infer import pipeline_forward_large

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(dtype=torch.float32, detection_pre_pool=32, use_dense_detection=True, num_detection_classes=2)
    cpu = MinGraphUNet(device="cpu", seed=3, **cfg)
    _perturb_bn(cpu, seed=4)
    card = MinGraphUNet(device=dev, **cfg)
    card.load_state_dict(cpu.state_dict())
    scene = _images(1, 256, seed=SCENE_CPU_SEED)
    t0 = time.perf_counter()
    o_cpu = pipeline_forward_large(cpu, scene, tile=128, halo=32)
    o_card = pipeline_forward_large(card, scene.to(dev), tile=128, halo=32)
    torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32 = True
    soft = o_cpu["soft_assignments"].topk(2, dim=-1).values
    margin = soft[..., 0] - soft[..., 1]
    decided = margin > CPU_TOL
    labels_ok = torch.equal(o_card["hard_patch_labels"].cpu()[decided], o_cpu["hard_patch_labels"][decided])
    print(f"[chip_smoke] large scene f32 card vs CPU, 256^2, tile 128, halo 32 ({time.perf_counter() - t0:.1f}s): "
          f"hard labels equal on the {int(decided.sum())} of {decided.numel()} patches with a top-2 margin above "
          f"{CPU_TOL}: {labels_ok}; min margin {margin.min().item():.3g}")
    if not labels_ok:
        _fail("card and CPU disagree on a hard patch label with a clear margin")
    for k in ("logits", "pred_bboxes", "pred_confidence", "pred_class_scores", "dense_objectness_logits",
              "dense_boxes", "soft_assignments"):
        ref, got = o_cpu[k], o_card[k].cpu()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        ok = err <= CPU_TOL * max(scale, 1e-6)
        print(f"[chip_smoke]   {k}: max_abs_err {err:.3g}, tolerance {CPU_TOL} * max|cpu| = "
              f"{CPU_TOL * scale:.3g}: {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"card and CPU disagree on the large-scene {k}")


# The graph branch: modules whose gradients come only through the graph
# losses and the detection head.
GRAPH_BRANCH = ("patch_gat", "mincut", "region_gat", "feature_consistency_proj", "detection_head")


def _e2e_run(dev, cfg, label: str, warmup: int, iters: int, train_detection: bool = True, batch=None):
    """Train the end-to-end model of ``cfg`` (bf16 512² b8, augmentation)
    for ``warmup`` untimed and ``iters`` timed steps, checking every term of
    every step is finite, the launches (K4 4 + 4, hist-eq 1 a step, K1-K3,
    K5, K7-K9 and sharded K2 never), a finite gradient in every leaf and a
    non-zero one in every leaf the total reaches (all but the exact zeros
    and the unreached class branch), and moved BN statistics of the U-Net
    (where it has BN) and the head. ``batch``: (images, masks, instances)
    of annotated data, else ``_train_batch``'s. Returns the model, its
    state and step, the batch (``extra``: the step's instance argument),
    the generator, the launches a step and the timings."""
    import torch

    from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer
    from mingraph_unet_tpu_torch.train.end_to_end import build_mingraph_unet, make_e2e_train_step

    model = build_mingraph_unet(cfg)
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    opt, sched = make_optimizer(model.parameters(), cfg.training, steps_per_epoch=1000)
    state = TrainState(model, opt, sched)
    step = make_e2e_train_step(model, opt, cfg, augment=True, train_detection=train_detection)
    imgs, masks, *inst = batch or _train_batch(BATCH, SIZE, seed=9, dev=dev)
    extra = {"instances": inst[0]} if inst else {}
    gen = torch.Generator(device=dev).manual_seed(0)

    def check(aux, i):
        bad = [k for k, v in aux.items() if not bool(torch.isfinite(v))]
        if bad:
            _fail(f"{label} step {i}: non-finite terms {bad}")

    _reset_counts()
    t0 = time.perf_counter()
    for i in range(warmup):
        check(step(state, imgs, masks, gen, **extra), i)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    auxes = []
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        auxes.append(step(state, imgs, masks, gen, **extra))
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, aux in enumerate(auxes):
        check(aux, warmup + i)
    n = warmup + iters
    launches = _counts()
    print(f"[chip_smoke] {label} launches over {n} steps: {launches}; last terms "
          f"{ {k: round(float(v), 4) for k, v in auxes[-1].items()} }")
    if launches != {"psel": 0, "dec1": 0, "pool": 0, "d2s": 0, "k4_fwd": 4 * n, "k4_dgrad": 4 * n, "histeq": n,
                    "wconv": 0, "conv_block": 0, "k9": 0, "dec1_halo": 0,
                    "k4_fwd_halo": 0, "k4_dgrad_halo": 0, "k10_fwd": 0, "k10_dgrad": 0}:
        _fail(f"{label}: expected K4 forward 4, dgrad 4 and histeq 1 launches per e2e step and no K1-K3, K5, "
              f"K7-K9 or sharded K2, got {launches} over {n} steps")
    if not _grads_finite(model):
        _fail(f"{label}: a parameter has no gradient or a non-finite one")
    # The step gives a leaf the total does not reach a zero gradient (as
    # JAX does), so "has a gradient" proves nothing: every leaf whose
    # gradient is not zero in exact arithmetic must have a non-zero one.
    zero = [n for n, p in model.named_parameters()
            if not _zero_in_exact_arithmetic(n) and not _unreached(n, model) and not bool(p.grad.ne(0).any())]
    if zero:
        _fail(f"{label}: leaves with an all-zero gradient: {zero[:5]} ({len(zero)} in all)")
    norms = {m: sum(float(p.grad.float().norm()) for p in getattr(model, m).parameters())
             for m in GRAPH_BRANCH if hasattr(model, m)}
    unmoved = [k for k, b in model.named_buffers() if torch.equal(b, stats0[k])]
    if unmoved or not any(k.startswith("detection_head.") for k in stats0):
        _fail(f"{label}: BN running statistics did not move: {unmoved[:5]}")
    print(f"[chip_smoke] {label} train bf16 {BATCH}x{SIZE}^2: {ms:.3f} ms/step, {BATCH / ms * 1e3:.1f} images/s, "
          f"host issue time {host_ms:.3f} ms/step, peak memory {peak:.2f} GiB, first {warmup} steps "
          f"{first_s:.1f}s; all {len(list(model.parameters()))} parameters have finite gradients, non-zero but "
          f"for the exact zeros and the unreached, graph-branch "
          f"gradient norms { {k: f'{v:.3g}' for k, v in norms.items()} }; all {len(stats0)} BN statistics "
          f"moved")
    return dict(model=model, state=state, step=step, imgs=imgs, masks=masks, extra=extra, gen=gen,
                launches={k: v // n for k, v in launches.items()}, ms=ms, host_ms=host_ms, peak=peak)


def _e2e_fixed(cfg, imgs, masks, gen, label: str, extra=None) -> None:
    """The end-to-end trainer of ``cfg`` on one fixed batch (``extra``: its
    instances), without augmentation, FIXED_BATCH_STEPS steps: the total
    must fall."""
    import torch

    from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer
    from mingraph_unet_tpu_torch.train.end_to_end import build_mingraph_unet, make_e2e_train_step

    model = build_mingraph_unet(cfg)
    opt, sched = make_optimizer(model.parameters(), cfg.training, steps_per_epoch=1000)
    state = TrainState(model, opt, sched)
    fixed = make_e2e_train_step(model, opt, cfg, augment=False, train_detection=True)
    totals = [float(fixed(state, imgs, masks, gen, **(extra or {}))["total"]) for _ in range(FIXED_BATCH_STEPS)]
    print(f"[chip_smoke] {label} fixed batch totals {[f'{v:.4f}' for v in totals]}")
    if not totals[-1] < totals[0]:
        _fail(f"{label}: the total did not fall on a fixed batch: {totals[0]} -> {totals[-1]}")
    del state, model, opt, sched, fixed
    torch.cuda.empty_cache()


def _e2e_path(dev):
    """Phase 8 on the card: the bf16 512² b8 end-to-end train steps, then the
    total loss on a fixed batch. Returns the launch counts per step and the
    timings."""
    import torch

    cfg = _train_cfg(SIZE, bf16=True)
    r = _e2e_run(dev, cfg, "e2e", E2E_WARMUP, E2E_ITERS)
    _profile("e2e train step", lambda: r["step"](r["state"], r["imgs"], r["masks"], r["gen"]), r["ms"], steps=2)
    imgs, masks, gen = r["imgs"], r["masks"], r["gen"]
    out = r["launches"], r["ms"], r["host_ms"], r["peak"]
    del r
    torch.cuda.empty_cache()
    _e2e_fixed(cfg, imgs, masks, gen, "e2e")
    return out


def _unreached(name: str, model) -> bool:
    """A leaf no loss reaches, whose gradient is 0 in JAX as here: the
    single-box head's class scores (JAX trains no class loss) and, without
    fusion, the region GAT (its embeddings feed only the fused map)."""
    return ".fc_class_scores." in name or (not model.use_fusion and name.startswith("region_gat."))


def _zero_in_exact_arithmetic(name: str) -> bool:
    """A leaf whose gradient is zero in exact arithmetic: a conv bias before
    a train-mode BN, or the region GAT's attention vectors at two regions
    (each node attends its single neighbour with weight 1)."""
    return _feeds_bn(name) or name.startswith(("region_gat.layer0.heads.a_src", "region_gat.layer0.heads.a_dst"))


class _E2EDecisions(_Decisions):
    """``_Decisions`` plus the end-to-end model's other discrete decisions:
    the GAT's leaky-ReLU signs, the MinCut argmax labels and the
    connected-component instance masks (the CC threshold at 0.5 and the
    instance selection, under either instancing)."""

    def __enter__(self):
        import torch

        from mingraph_unet_tpu_torch.models import gat
        from mingraph_unet_tpu_torch.ops import cc

        super().__enter__()
        self._saved_e2e = (gat.leaky_relu, torch.argmax, cc.top_instances_dense, cc.top_instances)
        leaky, argmax, top_dense, top_exact = self._saved_e2e

        def leaky_d(x, alpha):
            positive = self._decide(x >= 0)
            return leaky(x, alpha) if self.replay is None else torch.where(positive, x, alpha * x)

        def argmax_d(x, *args, **kwargs):
            return self._decide(argmax(x, *args, **kwargs))

        def top_d(top):
            def top_decided(labels, *args, **kwargs):
                masks, areas = top(labels, *args, **kwargs)
                return self._decide(masks), areas
            return top_decided

        gat.leaky_relu, torch.argmax = leaky_d, argmax_d
        cc.top_instances_dense, cc.top_instances = top_d(top_dense), top_d(top_exact)
        return self

    def __exit__(self, *exc):
        import torch

        from mingraph_unet_tpu_torch.models import gat
        from mingraph_unet_tpu_torch.ops import cc

        gat.leaky_relu, torch.argmax, cc.top_instances_dense, cc.top_instances = self._saved_e2e
        return super().__exit__(*exc)


def _e2e_vs_cpu(dev, change=None, label: str = "e2e step", annotated: bool = False) -> None:
    """Phase 8, card vs CPU: one f32 end-to-end step at batch 2, 128², TF32
    off, dropout the identity, SGD with momentum (an update linear in the
    gradient), against the same step in f64 on the CPU that replays the
    card's discrete decisions (``_E2EDecisions``). The final 1×1 conv is
    scaled so that the foreground probability crosses 0.5 in blobs and the
    shape loss has instances. Every leaf (gradient, updated parameter) must
    lie within CPU_TOL of its own max |f64|; a leaf whose gradient is zero
    in exact arithmetic (or up to f64 rounding) is held to CPU_TOL of the
    model's largest gradient (and its update to lr times that). Phase 15
    passes a config ``change`` (the dense head, exact instancing); phase 16
    ``annotated`` (the batch's instance masks as the step's ground truth)
    and the uncertainty balancer, whose log-variances are leaves too."""
    import torch

    from mingraph_unet_tpu_torch.models import layers
    from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
    from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer
    from mingraph_unet_tpu_torch.train.end_to_end import (
        LossBalance, build_mingraph_unet, make_e2e_train_step, mingraph_unet_kwargs)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _train_cfg(128, bf16=False, optimizer="sgd")
    if change:
        change(cfg)
    weights = build_mingraph_unet(cfg, device="cpu").state_dict()
    weights["unet.decoder.final_conv.kernel"] *= 4.0
    weights["unet.decoder.final_conv.bias"] += torch.tensor([-0.5, 0.5])
    imgs, masks, *inst = (_annotated_batch(2, 128, cfg.model.fusion_detection.max_instances, seed=5, dev="cpu")
                          if annotated else _train_batch(2, 128, seed=5, dev="cpu"))
    dropout = layers.dropout
    layers.dropout = lambda x, p, gen: x

    def step(where, dtype, decisions):
        model = MinGraphUNet(**mingraph_unet_kwargs(cfg), dtype=dtype, device=where)
        if cfg.training.loss_balance == "uncertainty":
            model.loss_balance = LossBalance().to(where)
        model = model.to(dtype=dtype)
        model.load_state_dict(weights)
        model.train()
        opt, sched = make_optimizer(model.parameters(), cfg.training, steps_per_epoch=1000)
        state = TrainState(model, opt, sched)
        gen = torch.Generator(device=where)
        extra = {"instances": inst[0].to(where)} if inst else {}
        with decisions:
            aux = make_e2e_train_step(model, opt, cfg, augment=False)(state, imgs.to(where), masks.to(where), gen,
                                                                      **extra)
        return ({k: float(v) for k, v in aux.items()},
                {(kind, n): (p.grad if kind == "grad" else p.detach()).cpu().double()
                 for n, p in model.named_parameters() for kind in ("grad", "param")})

    try:
        t0 = time.perf_counter()
        rec = _E2EDecisions()
        aux, got = step(dev, torch.float32, rec)
        ref_dec = _E2EDecisions(replay=rec.log)
        ref_aux, ref = step("cpu", torch.float64, ref_dec)
    finally:
        layers.dropout = dropout
        torch.backends.cudnn.allow_tf32 = True
    top_grad = max(t.abs().max().item() for (kind, _), t in ref.items() if kind == "grad")
    rows = []
    for key, r in ref.items():
        kind, n = key
        err, own = (got[key] - r).abs().max().item(), r.abs().max().item()
        # A gradient below 1e-9 of the largest is zero up to f64 rounding
        # (a lattice GAT's a_dst when no node's four scores straddle the
        # leaky ReLU's kink: the softmax does not see it).
        exact_zero = _zero_in_exact_arithmetic(n) or (kind == "grad" and own < 1e-9 * top_grad)
        limit = CPU_TOL * top_grad * (1.0 if kind == "grad" else LR) if exact_zero else CPU_TOL * own
        rows.append((err / max(limit, 1e-300), kind, n, err / max(own, 1e-30)))
    rows.sort(reverse=True)
    terms = {k: abs(aux[k] - ref_aux[k]) / max(abs(ref_aux[k]), 1e-30) for k in ref_aux}
    print(f"[chip_smoke] {label} f32 card vs f64 CPU, batch 2, 128^2, TF32 off ({time.perf_counter() - t0:.1f}s): "
          f"f64 terms { {k: round(v, 6) for k, v in ref_aux.items()} }; {ref_dec.flips} of {ref_dec.total} "
          f"decisions replayed against the f64 step's own; worst term rel err {max(terms.values()):.3g}; worst "
          f"leaves, share of limit, error of max |f64 leaf|:")
    for share, kind, n, rel in rows[:5]:
        print(f"[chip_smoke]     {share:.3g}  {kind} {n}: {rel:.3g}")
    if ref_aux["l_shape"] == 0.0 or ref_aux["l_feature"] == 0.0:
        _fail(f"{label}: the f32-vs-f64 end-to-end step must exercise the shape and feature losses")
    if "l_dense_obj" in ref_aux and not (ref_aux["l_dense_obj"] > 0.0 and ref_aux["l_dense_box"] > 0.0):
        _fail(f"{label}: the f32-vs-f64 end-to-end step must exercise both dense terms")
    outside = [(kind, n) for share, kind, n, _ in rows if not share <= 1.0]
    bad_terms = [k for k, v in terms.items() if not v <= CPU_TOL]
    if outside or bad_terms:
        _fail(f"{label} f32 card vs f64: terms outside {bad_terms}, {len(outside)} leaves outside their limit, "
              f"first {outside[:3]}")
    print(f"[chip_smoke] {label} f32 card vs f64: all {len(terms)} terms and {len(rows)} leaves within their "
          f"limits: ok")


def _shard_views(t, cuts):
    """(shard, top row, bottom row, first row) of each H-shard of ``t``
    between ``cuts``: the halo exchange done by hand in one process, None
    at the global borders."""
    h = t.shape[1]
    return [(t[:, a:e].contiguous(), t[:, a - 1 : a].contiguous() if a > 0 else None,
             t[:, e : e + 1].contiguous() if e < h else None, a) for a, e in zip(cuts[:-1], cuts[1:])]


def _shard_cuts(h):
    """Four equal H-shards, and four uneven ones (1 row, then heights that
    are not multiples of the kernel's 4-row tile)."""
    return [i * h // 4 for i in range(5)], [0, 1, h // 4 + 1, h // 2 + 3, h]


def _k9_timing(x, k2, b2, level: int, launches, err: float):
    """Phase 12's timing of K9 on one inner shard of four of ``x`` (bf16, or
    f32 on the split kernel) beside the JAX form (concat + K1 + slice), the
    plain version, the library's call (dense-s2d ``F.conv2d`` on the
    extended shard; in f32 with TF32 off) and its bound: the shard and its
    two halo rows read, its rows written, at 3.35 TB/s, against 2·9·C²
    operations a full-res pixel at 989 bf16 TFLOP/s (three times that in
    f32: the split form's products). Returns the kernels line's row."""
    import torch
    import torch.nn.functional as F

    from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
    from mingraph_unet_tpu_torch.ops.kernels import psconv

    f32 = x.dtype == torch.float32
    xs, top, bot, _ = _shard_views(x, _shard_cuts(x.shape[1])[0])[1]
    ext = psconv.extend_rows(xs, top, bot)
    ms = _time_ms(lambda: psconv.psel_conv3x3_halo(xs, top, bot, k2, b2), KERNEL_ITERS)
    plain_ms = _time_ms(lambda: psconv.psel_conv3x3_halo_plain(xs, top, bot, k2, b2), KERNEL_ITERS)
    jax_ms = _time_ms(lambda: psconv.psel_conv3x3(psconv.extend_rows(xs, top, bot), k2, b2)[:, 1:-1], KERNEL_ITERS)
    wd = s2d_ops.s2d_conv3x3_kernel(k2).to(xs.dtype).permute(3, 2, 0, 1).contiguous()
    extn = ext.permute(0, 3, 1, 2)
    library_ms = _time_ms(lambda: F.conv2d(extn, wd, padding=1), KERNEL_ITERS)
    tag = f"L{level}{' f32' if f32 else ''} shard"
    dev_ms = {k: _device_ms(f"{k} {tag}", f) for k, f in (
        ("jax", lambda: psconv.psel_conv3x3(psconv.extend_rows(xs, top, bot), k2, b2)[:, 1:-1]),
        ("library", lambda: F.conv2d(extn, wd, padding=1)))}
    k9_call = lambda: psconv.psel_conv3x3_halo(xs, top, bot, k2, b2)  # noqa: E731
    dev_ms["k9"], _, k9_ops = _device_ms(f"k9 {tag}", k9_call, own=SPLIT_KERNEL if f32 else "psel_wgmma_kernel",
                                         count=True)
    k9_host_us = _host_us(k9_call)
    b, h, w, z = xs.shape
    c, esz = z // 4, xs.element_size()
    t_bytes = (ext.numel() * esz + xs.numel() * esz + k2.numel() * esz + c * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = (3 if f32 else 1) * 2 * b * (2 * h) * (2 * w) * 9 * c * c / BF16_TENSOR_FLOPS * 1e3
    row = {
        "name": f"sharded_psconv{' f32' if f32 else ''} L{level}", "route": "cuda",
        "source": "mingraph_unet_tpu_torch/csrc/psel_conv.cu",
        "replaces": "mingraph_unet_tpu/parallel/halo.py:84", "launches": launches["k9"],
        "shape": list(xs.shape), "shards": 4, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "jax_form_ms": jax_ms, "device_ms": dev_ms["k9"],
        "jax_form_device_ms": dev_ms["jax"], "library_device_ms": dev_ms["library"],
        "device_ops": k9_ops, "host_us": k9_host_us,
    }
    if f32:
        row["dtype"] = "float32"
        row["launches_path"] = "f32 sharded serving forward 512^2 b8"
    print(f"[chip_smoke] sharded_psconv {tag} {tuple(xs.shape)}: {ms * 1e3:.1f} us/launch, "
          f"JAX form (concat + K1 + slice) {jax_ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, library "
          f"(dense-s2d F.conv2d on the extended shard) {library_ms * 1e3:.1f} us, bound "
          f"{max(t_bytes, t_ops) * 1e3:.1f} us ({row['bound_by']}); device time per call (profiler): "
          f"K9 {dev_ms['k9'] * 1e3:.1f} us in {k9_ops} operations (host {k9_host_us:.1f} us a call), JAX "
          f"form {dev_ms['jax'] * 1e3:.1f} us, library {dev_ms['library'] * 1e3:.1f} us; weights L2 -> SM "
          f"(from the tiling) {_psel_weight_l2_bytes(xs.shape, xs.device, k2.element_size()) / 1e6:.2f} MB")
    return row


def _k9_table(dev, s2d_sites, launches, f32_sites):
    """Phase 12: K9 and K2's sharded entry on H-shards, in one process. The
    L0 and L1 conv2 inputs and weights of the bf16 serving forward
    (``s2d_sites``) and of the f32 one (``f32_sites``: f32 x, kernel and
    bias, whose low bf16 halves are not zero) are cut into 4
    equal and 4 uneven shards, each given its neighbours' rows: the stitched
    K9 shards must equal K1 on the whole tensor bit for bit, and K1's plain
    version within CONV_TOL (F32_TOL in f32); the same for K2's sharded
    entry at both decoder conv1 sites against unsharded K2. One inner shard
    is timed beside the JAX form (concat + K1 + slice), the plain version,
    the library's call (dense-s2d ``F.conv2d`` on the extended shard) and
    its bound: the shard and its two halo rows read, its rows written,
    at 3.35 TB/s, against 2·9·C² operations a full-res pixel at 989 bf16
    TFLOP/s (PERF.md's K9 row)."""
    import torch

    from mingraph_unet_tpu_torch.ops.kernels import psconv

    sites = {name: (block, inp, fused_up, conv2) for name, block, inp, fused_up, conv2 in s2d_sites}
    rows, errs = [], {}
    torch.backends.cudnn.allow_tf32 = False  # the f32 plain versions are cuDNN convs
    with torch.no_grad():
        for level, (enc, dec) in enumerate((("enc0", "dec-L0"), ("enc1", "dec-L1"))):
            x2 = sites[enc][3][0]
            hh = x2.shape[1]
            inputs = {torch.bfloat16: sites[enc][3], torch.float32: f32_sites[level]}
            for dt, tol in ((torch.bfloat16, CONV_TOL), (torch.float32, F32_TOL)):
                x, k2, b2 = inputs[dt]
                if x.dtype != dt or x.shape != x2.shape:
                    _fail(f"sharded_psconv L{level}: a {dt} input of {tuple(x2.shape)} expected, got {x.dtype} "
                          f"{tuple(x.shape)}")
                whole = psconv.psel_conv3x3(x, k2, b2)
                for cuts in _shard_cuts(hh):
                    got = torch.cat([psconv.psel_conv3x3_halo(xs, top, bot, k2, b2)
                                     for xs, top, bot, _ in _shard_views(x, cuts)], dim=1)
                    torch.cuda.synchronize()
                    if not torch.equal(got, whole):
                        _fail(f"sharded_psconv L{level} {dt} shards {cuts}: not bit-equal to K1 on the whole tensor "
                              f"(max diff {(got.float() - whole.float()).abs().max().item():.3g})")
                errs[dt] = _check_close(f"sharded_psconv L{level} {dt} stitched {tuple(x.shape)}", got,
                                        psconv.psel_conv3x3_plain(x.float(), k2, b2), tol)
            print(f"[chip_smoke] sharded_psconv L{level}: 4 equal and 4 uneven shards bit-equal to K1 (bf16, f32)")
            for dt, dname in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                rows.append(_k9_timing(*inputs[dt], level, launches[dname], errs[dt]))

            block, inp, (x_prev, wt, bias_up), _ = sites[dec]
            k1, b1 = block.folded(1)
            skip_c = inp.shape[-1] // 4
            k_skip, k_prev = psconv.dec_conv1_weights(k1, skip_c, wt)
            t9 = psconv.dec_conv1_bias_table(k1, skip_c, bias_up, b1)
            for dt, tol in ((torch.bfloat16, CONV_TOL), (torch.float32, F32_TOL)):
                skip, prev = inp.to(dt).contiguous(), x_prev.to(dt).contiguous()
                whole = psconv.dec_conv1_fused(skip, prev, k_skip, k_prev, t9)
                for cuts in _shard_cuts(hh):
                    got = torch.cat([psconv.dec_conv1_halo(s, st, sb, p, pt, pb, k_skip, k_prev, t9, row0, hh)
                                     for (s, st, sb, row0), (p, pt, pb, _) in zip(_shard_views(skip, cuts),
                                                                                   _shard_views(prev, cuts))], dim=1)
                    torch.cuda.synchronize()
                    if not torch.equal(got, whole):
                        _fail(f"dec_conv1_halo {dec} {dt} shards {cuts}: not bit-equal to unsharded K2 (max diff "
                              f"{(got.float() - whole.float()).abs().max().item():.3g})")
                err = _check_close(f"dec_conv1_halo {dec} {dt} stitched {tuple(skip.shape)}", got,
                                   psconv.dec_conv1_fused_plain(skip.float(), prev.float(), k_skip, k_prev, t9), tol)
                if dt == torch.bfloat16:
                    err_bf16 = err
            print(f"[chip_smoke] dec_conv1_halo {dec}: 4 equal and 4 uneven shards bit-equal to K2 (bf16, f32)")
            skip, prev = inp.contiguous(), x_prev.to(inp.dtype).contiguous()
            (s, st, sb, row0), (p, pt, pb, _) = (_shard_views(skip, _shard_cuts(hh)[0])[1],
                                                 _shard_views(prev, _shard_cuts(hh)[0])[1])
            ms = _time_ms(lambda: psconv.dec_conv1_halo(s, st, sb, p, pt, pb, k_skip, k_prev, t9, row0, hh),
                          KERNEL_ITERS)
            plain_ms = _time_ms(lambda: psconv.dec_conv1_halo_plain(s, st, sb, p, pt, pb, k_skip, k_prev, t9, row0,
                                                                    hh), KERNEL_ITERS)
            call_ms, dev_ms = _device_ms(f"dec_conv1_halo {dec} shard",
                                         lambda: psconv.dec_conv1_halo(s, st, sb, p, pt, pb, k_skip, k_prev, t9, row0,
                                                                       hh), own="dec1_wgmma_kernel")
            b, h, w, z = s.shape
            c, cp = z // 4, p.shape[-1]
            t_bytes = ((s.numel() + p.numel()) * (h + 2) // h * 2 + s.numel() * 2
                       + (k_skip.numel() + k_prev.numel()) * 2 + t9.numel() * 4) / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * b * (2 * h) * (2 * w) * 17 * c * c / BF16_TENSOR_FLOPS * 1e3  # K2's least work, as above
            rows.append({
                "name": f"dec_conv1_halo {dec}", "route": "cuda", "source": "mingraph_unet_tpu_torch/csrc/dec_conv1.cu",
                "replaces": f"{PSCONV_SRC}:599", "launches": launches["bf16"]["dec1_halo"], "shape": list(s.shape),
                "shards": 4, "max_abs_err": err_bf16, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None, "device_ms": dev_ms,
                "call_device_ms": call_ms,
            })
            print(f"[chip_smoke] dec_conv1_halo {dec} one inner shard {tuple(s.shape)}: {ms * 1e3:.1f} us/launch, "
                  f"plain {plain_ms * 1e3:.1f} us, bound {max(t_bytes, t_ops) * 1e3:.1f} us ({rows[-1]['bound_by']}); "
                  f"device time (profiler) {dev_ms * 1e3:.1f} us, the call {call_ms * 1e3:.1f} us")
    torch.backends.cudnn.allow_tf32 = True
    return rows


def _leaf_check(label, got, ref, tol, exact_zero) -> None:
    """Every gradient and BN statistic of ``got`` within ``tol`` of the
    leaf's largest value in ``ref``; a gradient zero in exact arithmetic
    within ``tol`` of the model's largest gradient. Fatal otherwise."""
    top = max(v.abs().max().item() for (kind, _), v in ref.items() if kind == "grad")
    worst = (0.0, None)
    for key, r in ref.items():
        kind, name = key
        scale = top if kind == "grad" and exact_zero(name) else r.abs().max().item()
        rel = (got[key] - r).abs().max().item() / max(scale, 1e-30)
        if not rel <= tol:
            _fail(f"{label}: {kind} {name} differs by {rel:.3g} of its scale (tolerance {tol})")
        worst = max(worst, (rel, name), key=lambda t: t[0])
    print(f"[chip_smoke] {label}: all {len(ref)} gradients and BN statistics within {tol} of their scale "
          f"(largest {worst[0]:.3g}, {worst[1]})")


def _step_ms(step, steps: int):
    """(ms/step by CUDA events, host issue ms/step) over ``steps`` calls of
    ``step`` after one warm-up call."""
    import torch

    step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        step()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps, host_ms


def _dp_vs_one_card(kind: str, one, dp, params, mesh) -> None:
    """Phase 13's cost of the data-parallel step at one rank. The one-card
    step, the data-parallel step, and the data-parallel step with its NCCL
    calls made no-ops or issued as ``async_op`` + ``wait()`` are timed in
    DP_ROUNDS rounds of that order and its reverse (DP_STEPS steps a
    chunk), with the caching allocator's device allocations, frees,
    retries and syncs; the first two are then profiled,
    printing the kernels and host ops the data-parallel step adds, largest
    first. The collectives' own host cost is then timed
    without the profiler: one BN-sized all-reduce (the step makes two per
    train-mode BN and one of its metrics) and the flat gradient all-reduce
    over ``params``, which the step makes once."""
    import statistics

    import torch
    import torch.distributed as dist

    from mingraph_unet_tpu_torch.parallel.data import all_reduce_gradients

    real = dist.all_reduce

    def with_all_reduce(form):
        def run():
            dist.all_reduce = form
            try:
                return dp()
            finally:
                dist.all_reduce = real
        return run

    # At one rank an all-reduce is the identity: the no-op side does all of
    # the data-parallel step's work but its NCCL calls.
    fns = {"one card": one, "data-parallel": dp,
           "data-parallel, all-reduce a no-op": with_all_reduce(lambda *args, **kwargs: None),
           "data-parallel, all-reduce async_op + wait": with_all_reduce(
               lambda t, op=dist.ReduceOp.SUM, group=None, async_op=False: real(t, op, group, True).wait())}
    alloc_keys = ("num_device_alloc", "num_device_free", "num_alloc_retries", "num_sync_all_streams")
    chunks = {k: [] for k in fns}
    alloc = {k: [0] * len(alloc_keys) for k in fns}
    for _ in range(DP_ROUNDS):
        for side in list(fns) + list(fns)[::-1]:
            before = torch.cuda.memory_stats()
            chunks[side].append(_step_ms(fns[side], DP_STEPS))
            after = torch.cuda.memory_stats()
            alloc[side] = [n + after.get(k, 0) - before.get(k, 0) for n, k in zip(alloc[side], alloc_keys)]
    med = {k: [statistics.median(v) for v in zip(*c)] for k, c in chunks.items()}
    (ms1, _), (ms2, _), (ms3, _), (ms4, _) = med.values()
    calls = 2 * DP_ROUNDS * (DP_STEPS + 1)
    print(f"[chip_smoke] {kind} step bf16 {BATCH}x{SIZE}^2, {len(chunks['one card']) * DP_STEPS} steps a side in "
          f"chunks of {DP_STEPS}, interleaved, median chunk (ms/step, host issue ms/step): "
          + "; ".join(f"{k} {m:.3f}, {h:.3f}" for k, (m, h) in med.items())
          + f"; data-parallel / one card {ms2 / ms1:.3f}: its NCCL calls {ms2 - ms3:+.3f} ms, its other work "
          f"{ms3 - ms1:+.3f} ms; async_op + wait / data-parallel {ms4 / ms2:.3f} (chunks: "
          + "; ".join(f"{k} {[round(t[0], 3) for t in c]}" for k, c in chunks.items()) + ")")
    print(f"[chip_smoke]   {kind} caching allocator per step ({', '.join(alloc_keys)}): " + "; ".join(
        f"{k} {[round(n / calls, 2) for n in v]}" for k, v in alloc.items()))
    k1, h1 = _profile(f"{kind} step, one card", one, ms1, steps=DP_PROFILE_STEPS, top=0)
    k2, h2 = _profile(f"{kind} step, data-parallel (NCCL, 1 rank)", dp, ms2, steps=DP_PROFILE_STEPS, top=0)
    for what, a, b in (("kernels", k1, k2), ("host ops (self time, under the profiler)", h1, h2)):
        added = sorted(((b.get(k, (0, 0))[0] - a.get(k, (0, 0))[0], b.get(k, (0, 0))[1] - a.get(k, (0, 0))[1], k)
                        for k in set(a) | set(b)), reverse=True)
        total = sum(t for t, _ in b.values()) - sum(t for t, _ in a.values())
        print(f"[chip_smoke]   {kind} data-parallel step adds {total:+.3f} ms/step of {what}; largest: " + "; ".join(
            f"{k[:50]} {d:+.3f} ms ({n:+.1f}/step)" for d, n, k in added[:DP_TOP]))

    def host_and_card_us(fn, calls: int = 100):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        host = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
        return host, start.elapsed_time(end) * 1e3 / calls

    stats = torch.zeros((2, 256), device=next(iter(params)).device)
    ar_host, ar_card = host_and_card_us(lambda: dist.all_reduce(stats, group=mesh.batch_group))
    g_host, g_card = host_and_card_us(lambda: all_reduce_gradients(params, mesh), calls=20)
    # Small all-reduces a step: two per train-mode BN (forward, backward),
    # the metrics, and in the e2e step L_shape's and L_bbox's global counts.
    small = 2 * params.n_bn + 1 + (2 if kind == "e2e" else 0)
    print(f"[chip_smoke]   {kind} collectives without the profiler: one BN-sized all-reduce {ar_host:.1f} us of host, "
          f"{ar_card:.1f} us as timed on the card; the flat gradient all-reduce ({len(params)} tensors) "
          f"{g_host:.1f} us of host, {g_card:.1f} us on the card; the step's {small} small all-reduces and the "
          f"gradient all-reduce: ~{(small * ar_host + g_host) / 1e3:.3f} ms of host a step")


def _collective_blocking(group, dev) -> None:
    """Whether a one-rank NCCL all-reduce holds the host until the card
    reaches it: after a ~SPIN_CYCLES-cycle spin kernel, each form's host
    time; a plain in-place add returns at once. Prints the NCCL and
    TORCH_NCCL settings of the environment beside it."""
    import os

    import torch
    import torch.distributed as dist

    from mingraph_unet_tpu_torch.parallel.data import all_reduce_sum

    x = torch.zeros((2, 256), device=dev)
    forms = {"add_": lambda: x.add_(1),
             "all_reduce": lambda: dist.all_reduce(x, group=group),
             "all_reduce async_op, no wait": lambda: dist.all_reduce(x, group=group, async_op=True),
             "all_reduce async_op + work.wait": lambda: dist.all_reduce(x, group=group, async_op=True).wait(),
             "all_reduce async_op + future.wait": lambda: dist.all_reduce(x, group=group,
                                                                          async_op=True).get_future().wait(),
             "all_reduce_sum": lambda: all_reduce_sum(x, group)}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    end.record()
    torch.cuda.synchronize()
    host = {}
    for name, fn in forms.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        fn()
        host[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    env = {k: v for k, v in os.environ.items() if k.startswith(("NCCL_", "TORCH_NCCL", "TORCH_DIST"))}
    print(f"[chip_smoke] host ms of a call issued behind a {start.elapsed_time(end):.3f} ms spin kernel: "
          + "; ".join(f"{k} {v:.3f}" for k, v in host.items()) + f"; environment {env}")


class _Params(list):
    """A model's parameters, with its number of BatchNorm layers (``n_bn``)."""

    def __init__(self, model):
        from mingraph_unet_tpu_torch.models.layers import FoldableBatchNorm

        super().__init__(model.parameters())
        self.n_bn = sum(isinstance(mod, FoldableBatchNorm) for mod in model.modules())


def _sharded_serving(dev, mesh, dtype):
    """Phase 13's sharded serving forward in ``dtype``: the serving U-Net
    at 512² b8 through ``spatial_sharded_apply`` on the one-rank ``mesh``,
    launching K9 4 and sharded K2 2 and K1, K2 never, every K9 and
    sharded-K2 site bit-equal to K1 and K2 on the inputs it got, the
    logits within CONV_TOL of the unsharded forward's in bf16 (the cuDNN
    sites may pick another algorithm for a VALID-in-H conv) and F32_TOL in
    f32 (TF32 off). The bf16 forward is timed beside the unsharded one.
    Returns the launch counts and, by s2d level, the (x, kernel, bias) of
    the first K9 site there: the encoder's conv2 input and weights."""
    import torch

    from mingraph_unet_tpu_torch.ops.kernels import psconv
    from mingraph_unet_tpu_torch.parallel import halo as phalo
    from mingraph_unet_tpu_torch.parallel import spatial as pspatial

    f32 = dtype == torch.float32
    tag = "f32" if f32 else "bf16"
    model, x = _serving_model(dev, dtype=dtype)
    unet = model.unet
    sites = []
    real = {"k9": phalo.conv2_s2d_halo, "dec1_halo": pspatial.dec_conv1_shard}

    def spy(kind):
        def call(*args):
            y = real[kind](*args)
            sites.append((kind, args, y))
            return y
        return call

    def sharded():
        return pspatial.gather_rows(pspatial.spatial_sharded_apply(
            lambda xl, spatial: unet(xl, spatial=spatial)["logits"], x, mesh), mesh)

    torch.backends.cudnn.allow_tf32 = not f32
    with torch.no_grad():
        whole = unet(x)["logits"]
        phalo.conv2_s2d_halo, pspatial.dec_conv1_shard = spy("k9"), spy("dec1_halo")
        try:
            _reset_counts()
            got = sharded()
            torch.cuda.synchronize()
            launches = _counts()
        finally:
            phalo.conv2_s2d_halo, pspatial.dec_conv1_shard = real["k9"], real["dec1_halo"]
        print(f"[chip_smoke] spatial_sharded_apply {tag} launches: {launches}")
        if launches != {"psel": 0, "dec1": 0, "pool": 2, "d2s": 1, "k4_fwd": 0, "k4_dgrad": 0, "histeq": 0,
                        "wconv": 0, "conv_block": 0, "k9": 4, "dec1_halo": 2,
                        "k4_fwd_halo": 0, "k4_dgrad_halo": 0, "k10_fwd": 0, "k10_dgrad": 0}:
            _fail(f"expected K9 4, sharded K2 2, pool 2, d2s 1 and no K1 or K2 launches in the sharded {tag} U-Net, "
                  f"got {launches}")
        _check_close(f"spatial_sharded_apply U-Net {tag} logits (NCCL, 1 rank)", got, whole,
                     F32_TOL if f32 else CONV_TOL, what="the unsharded forward")
        enc_sites = {}
        for kind, args, y in sites:
            if kind == "k9":
                xs, top, bot, k, b = args[:5]
                ref = psconv.psel_conv3x3(xs, k, b)
                enc_sites.setdefault({128: 0, 256: 1}[xs.shape[-1]], (xs, k, b))
            else:
                s, st, sb, p, pt, pb, k_skip, k_prev, t9 = args[:9]
                ref = psconv.dec_conv1_fused(s, p, k_skip, k_prev, t9)
            if not torch.equal(y, ref):
                _fail(f"{kind} {tag} site {tuple(args[0].shape)} in the sharded forward is not bit-equal to the "
                      f"unsharded kernel on its inputs")
        print(f"[chip_smoke] spatial_sharded_apply U-Net {tag}: {len(sites)} K9/K2 sites bit-equal to K1/K2")
        if f32:
            names = _kernel_names("f32 sharded U-Net", sharded)
            if names != (launches["k9"], launches["dec1_halo"]):
                _fail(f"f32 sharded U-Net: {names} psel split and K2 split launches, expected K9 "
                      f"{launches['k9']} and sharded K2 {launches['dec1_halo']} on their split kernels")
        if not f32:
            whole_ms = _time_ms(lambda: unet(x)["logits"], 5)
            sharded_ms = _time_ms(sharded, 5)
            whole_dev = _device_ms("the unsharded U-Net", lambda: unet(x)["logits"], 3)
            sharded_dev = _device_ms("the sharded U-Net", sharded, 3)
            print(f"[chip_smoke] spatial_sharded_apply U-Net bf16 {BATCH}x{SIZE}^2 (1 rank): {sharded_ms:.3f} ms "
                  f"({sharded_dev:.3f} ms of kernels) against the unsharded U-Net's {whole_ms:.3f} ms "
                  f"({whole_dev:.3f} ms of kernels)")
    torch.backends.cudnn.allow_tf32 = True
    del model, x, whole, got, sites
    torch.cuda.empty_cache()
    return launches, enc_sites


def _nccl_paths(dev):
    """Phase 13: the port's torch.distributed paths over NCCL at world size
    1 (one rank in a group of one; each collective runs). The serving
    U-Net through ``spatial_sharded_apply`` at 512² b8, in bf16 and in f32
    (``_sharded_serving``); then one data-parallel segmentation
    step and one e2e step at 512² b8 bf16 against the one-card steps from
    the same weights, batch and generator: losses, gradients and BN
    statistics within 1e-3 (an all-reduced sum may round in another order),
    each step launching K4 as before, and each timed and profiled beside
    the one-card step (``_dp_vs_one_card``). A group of one rank exchanges
    no halo rows and gathers nothing: the halo exchange and the all-gather
    need two or more cards. Returns the sharded forwards' launch counts by
    dtype and the f32 forward's K9 sites by level (phase 12's f32 inputs)."""
    import socket

    import torch
    import torch.distributed as dist

    from mingraph_unet_tpu_torch.parallel import mesh as pmesh
    from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer
    from mingraph_unet_tpu_torch.train.end_to_end import build_mingraph_unet, make_e2e_train_step
    from mingraph_unet_tpu_torch.train.segmentation import build_unet, make_train_step

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(1, 1)
        print(f"[chip_smoke] NCCL group of 1 rank: mesh {mesh.shape}, backend {dist.get_backend()}")
        launches, _ = _sharded_serving(dev, mesh, torch.bfloat16)
        launches32, f32_sites = _sharded_serving(dev, mesh, torch.float32)

        _collective_blocking(mesh.batch_group, dev)
        cfg = _train_cfg(SIZE, bf16=True)
        imgs, masks = _train_batch(BATCH, SIZE, seed=3, dev=dev)
        for kind in ("seg", "e2e"):
            weights = (build_unet(cfg) if kind == "seg" else build_mingraph_unet(cfg)).state_dict()
            sides = {}
            for side, step_mesh in (("one card", None), ("data-parallel", mesh)):
                m = build_unet(cfg) if kind == "seg" else build_mingraph_unet(cfg)
                m.load_state_dict(weights)
                opt, sched = make_optimizer(m.parameters(), cfg.training, steps_per_epoch=1000)
                state = TrainState(m, opt, sched)
                step = (make_train_step(cfg, augment=True, mesh=step_mesh) if kind == "seg"
                        else make_e2e_train_step(m, opt, cfg, augment=True, mesh=step_mesh))
                _reset_counts()
                metrics = step(state, imgs, masks, torch.Generator(device=dev).manual_seed(0))
                torch.cuda.synchronize()
                counts = _counts()
                want = {k: 0 for k in counts}
                want.update(k4_fwd=4, k4_dgrad=4, histeq=0 if kind == "seg" else 1)
                if counts != want:
                    _fail(f"{kind} step ({side}): expected launches {want}, got {counts}")
                leaves = {("grad", n): p.grad.float().clone() for n, p in m.named_parameters()}
                leaves.update({("stat", n): b.float().clone() for n, b in m.named_buffers()})
                gen = torch.Generator(device=dev).manual_seed(1)
                sides[side] = ({k: float(v) for k, v in metrics.items()}, leaves,
                               (lambda step=step, state=state, gen=gen: step(state, imgs, masks, gen)), _Params(m))
            (ref_m, ref_l, one, _), (got_m, got_l, dp, dp_params) = sides["one card"], sides["data-parallel"]
            for k, v in ref_m.items():
                if not abs(got_m[k] - v) <= 1e-3 * max(abs(v), 1e-6):
                    _fail(f"{kind} data-parallel step: {k} {got_m[k]} against the one-card step's {v}")
            _leaf_check(f"{kind} data-parallel step (NCCL, 1 rank) vs one card", got_l, ref_l, 1e-3,
                        _feeds_bn if kind == "seg" else _zero_in_exact_arithmetic)
            _dp_vs_one_card(kind, one, dp, dp_params, mesh)
            del sides, one, dp, dp_params
            torch.cuda.empty_cache()
        return {"bf16": launches, "f32": launches32}, f32_sites
    finally:
        dist.destroy_process_group()


def _spatial_train_path(dev):
    """Phase 14, this slice's path: both train steps' spatial-parallel path
    (``make_train_step`` / ``make_e2e_train_step`` on a mesh, the U-Net
    through ``spatial_sharded_unet``) over NCCL in a group of one rank. One
    card can hold no spatial axis of two ranks, so the steps are made with
    their spatial switch (``spatial_step``) set on for the one-rank mesh:
    the U-Net then runs on its single H-shard through every sharded train
    site (K4 on the shard at the four s2d conv2s, no row exchanged), its
    outputs go through the gather and the rest of the step as on a spatial
    group. Each 512² b8 step (seg, e2e; in bf16, and in f32 as
    ``configs/training.yaml`` sets the precision) must launch K4 on a shard
    4 forward and 4 dgrad (hist-eq once in e2e) and K4 itself, K1-K3 and
    K10 never, and agree with the one-card step (in f32 with its standard
    blocks' convs on cuDNN, as the sharded step runs them) from the same
    weights, batch and
    generator within 1e-3 (losses, every gradient and BN statistic); in
    f32 the profiler must name the split kernel for all 8 launches.
    Phase 15 (f): the e2e step with the dense head
    on, the same way. Returns each step's launch counts."""
    import socket

    import torch
    import torch.distributed as dist

    from mingraph_unet_tpu_torch.ops.kernels import conv3x3 as c3
    from mingraph_unet_tpu_torch.parallel import mesh as pmesh
    from mingraph_unet_tpu_torch.train import end_to_end, segmentation
    from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer

    split_conv = c3.split_conv
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(1, 1)
        imgs, masks = _train_batch(BATCH, SIZE, seed=5, dev=dev)
        launches = {}
        for kind, module in (("seg", segmentation), ("e2e", end_to_end), ("e2e dense", end_to_end),
                             ("seg f32", segmentation), ("e2e f32", end_to_end)):
            f32 = kind.endswith("f32")
            cfg = _train_cfg(SIZE, bf16=not f32)
            cfg.model.fusion_detection.use_dense_detection = kind == "e2e dense"
            seg = kind.startswith("seg")
            build = segmentation.build_unet if seg else end_to_end.build_mingraph_unet
            weights = build(cfg).state_dict()
            sides = {}
            for side in ("one card", "spatial"):
                m = build(cfg)
                m.load_state_dict(weights)
                opt, sched = make_optimizer(m.parameters(), cfg.training, steps_per_epoch=1000)
                state = TrainState(m, opt, sched)
                real = module.spatial_step
                if side == "spatial":
                    module.spatial_step = lambda mesh: True
                try:
                    step = (segmentation.make_train_step(cfg, augment=True, mesh=mesh if side == "spatial" else None)
                            if seg else
                            end_to_end.make_e2e_train_step(m, opt, cfg, augment=True,
                                                           mesh=mesh if side == "spatial" else None))
                finally:
                    module.spatial_step = real
                # The one-card f32 step runs its standard blocks' convs on cuDNN,
                # as the sharded step does (``spatial.conv_same``), not on K10:
                # the comparison holds the sharding to 1e-3, and two conv
                # arithmetics part further by flipping ReLU and pool decisions.
                c3.split_conv = (lambda x: False) if f32 else split_conv
                _reset_counts()
                metrics = step(state, imgs, masks, torch.Generator(device=dev).manual_seed(0))
                torch.cuda.synchronize()
                c3.split_conv = split_conv
                counts = _counts()
                want = {k: 0 for k in counts}
                if side == "spatial":
                    want.update(k4_fwd_halo=4, k4_dgrad_halo=4, histeq=0 if seg else 1)
                else:
                    want.update(k4_fwd=4, k4_dgrad=4, histeq=0 if seg else 1)
                print(f"[chip_smoke] {kind} step ({side}) launches: {counts}")
                if counts != want:
                    _fail(f"{kind} step ({side}): expected launches {want}, got {counts}")
                if not _grads_finite(m):
                    _fail(f"{kind} step ({side}): a gradient is missing or not finite")
                leaves = {("grad", n): p.grad.float().clone() for n, p in m.named_parameters()}
                leaves.update({("stat", n): b.float().clone() for n, b in m.named_buffers()})
                gen = torch.Generator(device=dev).manual_seed(1)
                sides[side] = ({k: float(v) for k, v in metrics.items()}, leaves, counts,
                               lambda step=step, state=state, gen=gen: step(state, imgs, masks, gen))
            (ref_m, ref_l, _, one), (got_m, got_l, counts, sp) = sides["one card"], sides["spatial"]
            for k, v in ref_m.items():
                if not abs(got_m[k] - v) <= 1e-3 * max(abs(v), 1e-6):
                    _fail(f"{kind} spatial step: {k} {got_m[k]} against the one-card step's {v}")
            _leaf_check(f"{kind} spatial step (NCCL, 1 rank) vs one card", got_l, ref_l, 1e-3,
                        _feeds_bn if seg else _zero_in_exact_arithmetic)
            if f32:
                names = _kernel_names(f"{kind} spatial step", sp)
                if names != (8, 0):
                    _fail(f"{kind} spatial step: {names} psel split and K2 split launches a step, expected K4 "
                          f"on a shard's 8 on the split kernel")
            elif kind == "e2e dense":
                if not (ref_m["l_dense_obj"] > 0.0 and ref_m["l_dense_box"] > 0.0):
                    _fail(f"{kind} spatial step: the dense terms must be positive, got {ref_m}")
            else:
                one_ms, one_host = _step_ms(one, 3)
                sp_ms, sp_host = _step_ms(sp, 3)
                print(f"[chip_smoke] {kind} spatial step (1 rank) {sp_ms:.3f} ms/step (host {sp_host:.3f}) against "
                      f"the one-card step's {one_ms:.3f} ms (host {one_host:.3f}), bf16 {BATCH}x{SIZE}^2")
            launches[kind] = counts
            del sides, one, sp
            torch.cuda.empty_cache()
        return launches
    finally:
        c3.split_conv = split_conv
        dist.destroy_process_group()


def _k4_shard_timing(x, cot, k, lvl: int, launches, errs):
    """Phase 14's timing of K4 on one inner shard of four of ``x`` (forward)
    and ``cot`` (dgrad), bf16 or f32 (the split kernel), each by events and
    device time beside its bound (the shard and its 2 rows read, its rows
    written, the weights, at 3.35 TB/s, against 2·9·C² operations a
    full-res pixel at 989 TFLOP/s, three times that in f32: the split
    form's products), the plain version, the library's dense-s2d
    ``F.conv2d`` on the extended shard (f32: TF32 off) and the unsharded
    K4's device time over 4; a call must be one device operation. Returns
    the kernels line's two rows."""
    import torch
    import torch.nn.functional as F

    from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
    from mingraph_unet_tpu_torch.ops.kernels import psconv

    def dgrad_plain(t, top, bottom, kk):
        return psconv.psconv_halo_plain(t, top, bottom, kk.flip(0, 1).transpose(2, 3))

    f32 = x.dtype == torch.float32
    own, dname = (SPLIT_KERNEL, " f32") if f32 else ("psel_wgmma_kernel", "")
    hh, c = x.shape[1], k.shape[2]
    rows = []
    for name, fn, plain, inp, line in (
        ("fwd", psconv.psconv_fwd_halo, psconv.psconv_halo_plain, x, 416),
        ("dgrad", psconv.psconv_dgrad_halo, dgrad_plain, cot, 433),
    ):
        xs, top, bot, _ = _shard_views(inp, _shard_cuts(hh)[0])[1]
        kd = k if name == "fwd" else k.flip(0, 1).transpose(2, 3)
        wd = s2d_ops.s2d_conv3x3_kernel(kd).to(xs.dtype).permute(3, 2, 0, 1).contiguous()
        extn = psconv.extend_rows(xs, top, bot).permute(0, 3, 1, 2)
        tag = f"psconv_{name}_halo{dname} L{lvl}"
        torch.backends.cudnn.allow_tf32 = False
        ms = _time_ms(lambda: fn(xs, top, bot, k), KERNEL_ITERS)
        plain_ms = _time_ms(lambda: plain(xs, top, bot, k), KERNEL_ITERS)
        library_ms = _time_ms(lambda: F.conv2d(extn, wd, padding=(0, 1)), KERNEL_ITERS)
        call_ms, dev_ms, dev_ops = _device_ms(f"{tag} shard", lambda: fn(xs, top, bot, k), own=own, count=True)
        if dev_ops != 1:
            _fail(f"{tag}: {dev_ops} device operations a call, expected the kernel alone")
        host_us = _host_us(lambda: fn(xs, top, bot, k))
        whole_fn = psconv.psconv_fwd if name == "fwd" else psconv.psconv_dgrad
        _, whole_dev = _device_ms(f"psconv_{name}{dname} L{lvl} whole", lambda: whole_fn(inp, k), own=own)
        library_dev = _device_ms(f"library{dname} L{lvl} shard", lambda: F.conv2d(extn, wd, padding=(0, 1)))
        torch.backends.cudnn.allow_tf32 = True
        b, h, w, z = xs.shape
        esz = xs.element_size()
        t_bytes = ((xs.numel() + top.numel() + bot.numel()) * esz + xs.numel() * esz + k.numel() * esz) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = (3 if f32 else 1) * 2 * b * (2 * h) * (2 * w) * 9 * c * c / BF16_TENSOR_FLOPS * 1e3
        rows.append({
            "name": tag, "route": "cuda", "source": "mingraph_unet_tpu_torch/csrc/psel_conv.cu",
            "replaces": f"{PSCONV_SRC}:{line}", "launches": launches["seg" + dname][f"k4_{name}_halo"],
            "launches_e2e": launches["e2e" + dname][f"k4_{name}_halo"], "shape": list(xs.shape), "shards": 4,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "device_ms": dev_ms, "call_device_ms": call_ms,
            "library_device_ms": library_dev, "unsharded_device_ms_over_4": whole_dev / 4,
            "host_us": host_us, "device_ops": dev_ops,
        })
        if f32:
            rows[-1]["dtype"] = "float32"
        print(f"[chip_smoke] {tag} one inner shard {tuple(xs.shape)} + 2 rows: {ms * 1e3:.1f} "
              f"us/launch, host {host_us:.1f} us a call, device {dev_ms * 1e3:.1f} us (the call "
              f"{call_ms * 1e3:.1f} us in {dev_ops} operation{'s' if dev_ops > 1 else ''}), plain "
              f"{plain_ms * 1e3:.1f} us, library (dense-s2d F.conv2d, VALID in H) {library_ms * 1e3:.1f} us / "
              f"device {library_dev * 1e3:.1f} us, unsharded K4 device / 4 {whole_dev / 4 * 1e3:.1f} us, bound "
              f"{max(t_bytes, t_ops) * 1e3:.1f} us ({rows[-1]['bound_by']})")
    return rows


def _spatial_k4_table(dev, launches):
    """Phase 14's kernels: K4 on H-shards (``psconv_fwd_halo``,
    ``psconv_dgrad_halo``: K9's entry with no bias and no ReLU) at the
    segmentation step's train shapes, L0 (8, 256, 256, 128) and L1 (8, 128,
    128, 256), in bf16 and f32, on seeded inputs and cotangents cut into 4
    equal and 4 uneven shards with the halo rows by hand: the stitched
    forward must equal ``psconv_fwd`` on the whole tensor bit for bit, the
    stitched dx (from the cotangent's rows) ``psconv_dgrad``, and the
    plain versions within CONV_TOL / F32_TOL; the shards' kernel gradients
    (``psconv_wgrad`` over each shard and its x rows, VALID in H) must sum
    to the whole one within DK_TOL. The autograd Function
    (``psconv_train_halo``), driven with the rows by hand, must give the
    same forward and dx bit for bit and its dK sum within DK_TOL. One
    inner shard's forward and dgrad are timed in both dtypes
    (``_k4_shard_timing``)."""
    import torch

    from mingraph_unet_tpu_torch.ops.kernels import psconv

    g = torch.Generator(device=dev).manual_seed(17)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale  # noqa: E731
    rows = []
    for lvl, c in ((0, 32), (1, 64)):
        hh = SIZE // 2 ** (lvl + 1)
        x32, cot32 = rnd(BATCH, hh, hh, 4 * c), rnd(BATCH, hh, hh, 4 * c)
        k = rnd(3, 3, c, c, scale=(1.0 / (9 * c)) ** 0.5)
        errs = {}
        torch.backends.cudnn.allow_tf32 = False  # the f32 plain versions are cuDNN convs
        for dt, tol in ((torch.bfloat16, CONV_TOL), (torch.float32, F32_TOL)):
            x, cot = x32.to(dt), cot32.to(dt)
            dname = "bf16" if dt == torch.bfloat16 else "f32"
            with torch.no_grad():
                whole = {"fwd": psconv.psconv_fwd(x, k), "dgrad": psconv.psconv_dgrad(cot, k)}
                dk_whole = psconv.psconv_wgrad(x, cot, k)
            for cuts in _shard_cuts(hh):
                xv, gv = _shard_views(x, cuts), _shard_views(cot, cuts)
                with torch.no_grad():
                    got = {"fwd": torch.cat([psconv.psconv_fwd_halo(xs, t, b, k) for xs, t, b, _ in xv], dim=1),
                           "dgrad": torch.cat([psconv.psconv_dgrad_halo(gs, t, b, k) for gs, t, b, _ in gv], dim=1)}
                    dk = sum(psconv.psconv_wgrad(xs, gs, k, rows=(xt, xb))
                             for (xs, xt, xb, _), (gs, _, _, _) in zip(xv, gv))
                torch.cuda.synchronize()
                for name in ("fwd", "dgrad"):
                    if not torch.equal(got[name], whole[name]):
                        _fail(f"psconv_{name}_halo L{lvl} {dname} shards {cuts}: not bit-equal to psconv_{name} on "
                              f"the whole tensor (max diff "
                              f"{(got[name].float() - whole[name].float()).abs().max().item():.3g})")
                _check_close(f"psconv_wgrad on shards L{lvl} {dname} {cuts}, summed", dk[None], dk_whole[None],
                             DK_TOL, border=False, what="the whole tensor's kernel gradient")
                fy, fdx, fdk = [], [], 0
                for (xs, xt, xb, _), (gs, gt, gb, _) in zip(xv, gv):
                    xi, ki = xs.clone().requires_grad_(), k.clone().requires_grad_()
                    y = psconv.psconv_train_halo(xi, xt, xb, ki, lambda t, r=(gt, gb): r)
                    y.backward(gs)
                    fy.append(y.detach())
                    fdx.append(xi.grad)
                    fdk = fdk + ki.grad
                torch.cuda.synchronize()
                if not (torch.equal(torch.cat(fy, 1), whole["fwd"]) and torch.equal(torch.cat(fdx, 1), whole["dgrad"])):
                    _fail(f"psconv_train_halo L{lvl} {dname} shards {cuts}: forward or dx not bit-equal to K4's")
                _check_close(f"psconv_train_halo dK L{lvl} {dname} {cuts}, summed", fdk[None], dk_whole[None],
                             DK_TOL, border=False, what="the whole tensor's kernel gradient")
            errs[dt] = {
                "fwd": _check_close(f"psconv_fwd_halo L{lvl} {dname} stitched", got["fwd"],
                                    psconv.psconv_train_plain(x.float(), k), tol),
                "dgrad": _check_close(f"psconv_dgrad_halo L{lvl} {dname} stitched", got["dgrad"],
                                      psconv.psconv_dgrad_plain(cot.float(), k), tol)}
            print(f"[chip_smoke] K4 on shards L{lvl} {dname}: 4 equal and 4 uneven shards bit-equal to K4 (forward, "
                  f"dgrad, the autograd Function), dK within {DK_TOL}")
        torch.backends.cudnn.allow_tf32 = True

        for dt in (torch.bfloat16, torch.float32):
            rows += _k4_shard_timing(x32.to(dt), cot32.to(dt), k, lvl, launches, errs[dt])
    return rows


# The stage switches of each ablation variant of the JAX package's
# experiments/ablation_study.py (VARIANT_TOGGLES) but "combined", the
# default model of phase 8; copied, as this script imports nothing of it.
ABLATION_VARIANTS = {
    "mincut_only": {"use_patch_gat": False, "use_partition": True, "use_region_gat": False},
    "graph_unet_only": {"use_patch_gat": True, "use_partition": False, "use_region_gat": False},
    "graph_construction": {"use_patch_gat": False, "use_partition": False, "use_region_gat": False},
    "graph_traversal": {"use_patch_gat": True, "use_partition": True, "use_region_gat": False},
}
# Row name of the kernels line → the launch counter it reads.
ROW_COUNTER = {"psel_conv3x3": "psel", "dec_conv1_fused": "dec1", "phase_max_pool": "pool", "depth_to_space": "d2s",
               "psconv_fwd": "k4_fwd", "psconv_dgrad": "k4_dgrad", "equalize_channel": "histeq",
               "wconv3x3_s2d": "wconv", "fused_conv_block": "conv_block", "sharded_psconv": "k9",
               "dec_conv1_halo": "dec1_halo", "psconv_fwd_halo": "k4_fwd_halo", "psconv_dgrad_halo": "k4_dgrad_halo",
               "conv3x3_fwd": "k10_fwd", "conv3x3_dgrad": "k10_dgrad"}


def _dense(cfg) -> None:
    cfg.model.fusion_detection.use_dense_detection = True


def _no_bn(cfg) -> None:
    cfg.model.unet.use_batchnorm = False


def _remat_vs_plain(dev, kind: str):
    """Phase 15 (d): one bf16 512² b8 train step (``kind`` "seg" or "e2e")
    of the plain and the rematerialized model from the same weights, batch
    and generator. Losses, every gradient and BN statistic within 1e-3 of
    their scale, the BN running statistics equal; K4's launches of each
    step and both steps' peak memory and time printed; the segmentation
    step's peak must be lower with remat. Returns the remat step's
    launches."""
    import torch

    from mingraph_unet_tpu_torch.train import end_to_end, segmentation
    from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer

    build = segmentation.build_unet if kind == "seg" else end_to_end.build_mingraph_unet
    weights = {k: v.clone() for k, v in build(_train_cfg(SIZE, bf16=True)).state_dict().items()}
    imgs, masks = _train_batch(BATCH, SIZE, seed=3 if kind == "seg" else 9, dev=dev)
    sides = {}
    for remat in (False, True):
        cfg = _train_cfg(SIZE, bf16=True)
        cfg.model.unet.remat = remat
        m = build(cfg)
        m.load_state_dict(weights)
        opt, sched = make_optimizer(m.parameters(), cfg.training, steps_per_epoch=1000)
        state = TrainState(m, opt, sched)
        step = (segmentation.make_train_step(cfg, augment=True) if kind == "seg"
                else end_to_end.make_e2e_train_step(m, opt, cfg, augment=True))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        metrics = step(state, imgs, masks, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        counts = _counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        leaves = {("grad", n): p.grad.float().clone() for n, p in m.named_parameters()}
        leaves.update({("stat", n): b.float().clone() for n, b in m.named_buffers()})
        stats = {n: b.clone() for n, b in m.named_buffers()}
        gen = torch.Generator(device=dev).manual_seed(1)
        ms, host_ms = _step_ms(lambda: step(state, imgs, masks, gen), 3)
        sides[remat] = ({k: float(v) for k, v in metrics.items()}, leaves, stats, counts, peak, ms, host_ms)
        del m, state, step, opt, sched
        torch.cuda.empty_cache()
    (ref_m, ref_l, ref_s, ref_c, ref_peak, ref_ms, ref_host) = sides[False]
    (got_m, got_l, got_s, got_c, got_peak, got_ms, got_host) = sides[True]
    label = f"{kind} remat step"
    print(f"[chip_smoke] {label} launches {got_c} (plain {ref_c})")
    hist = 0 if kind == "seg" else 1
    # Remat runs every block's forward again in the backward: K4's forward
    # twice, its dgrad once.
    if (ref_c != dict({k: 0 for k in ref_c}, k4_fwd=4, k4_dgrad=4, histeq=hist)
            or got_c != dict(ref_c, k4_fwd=2 * ref_c["k4_fwd"])):
        _fail(f"{label}: unexpected launches {got_c} (plain step {ref_c})")
    for k, v in ref_m.items():
        if not abs(got_m[k] - v) <= 1e-3 * max(abs(v), 1e-6):
            _fail(f"{label}: {k} {got_m[k]} against the plain step's {v}")
    _leaf_check(f"{label} vs the plain step", got_l, ref_l, 1e-3, _feeds_bn if kind == "seg" else
                _zero_in_exact_arithmetic)
    unequal = [n for n, b in ref_s.items() if not torch.equal(b, got_s[n])]
    if unequal:
        _fail(f"{label}: BN running statistics differ from the plain step's: {unequal[:5]}")
    print(f"[chip_smoke] {label}: BN running statistics equal to the plain step's ({len(ref_s)}); K4 forward "
          f"{got_c['k4_fwd']} and dgrad {got_c['k4_dgrad']} launches a step (plain {ref_c['k4_fwd']} + "
          f"{ref_c['k4_dgrad']}); peak memory {got_peak:.3f} GiB with remat, {ref_peak:.3f} GiB without; "
          f"{got_ms:.3f} ms/step (host {got_host:.3f}) with remat, {ref_ms:.3f} ms/step (host {ref_host:.3f}) "
          f"without, bf16 {BATCH}x{SIZE}^2")
    if kind == "seg" and not got_peak < ref_peak:
        _fail(f"{label}: peak memory {got_peak:.3f} GiB with remat is not below {ref_peak:.3f} GiB without")
    return {k: v for k, v in got_c.items()}


def _options_path(dev):
    """Phase 15: the model options the trainers take, at ``PipelineConfig()``
    widths in bf16 at 512² b8 (see the module docstring). Returns the
    launches a step (a forward) of each path and the dense-head step's
    timings."""
    import torch

    from mingraph_unet_tpu_torch.ops import cc

    launches = {}
    # (a) The dense head, trained on the CC fallback's ground truth.
    cfg = _train_cfg(SIZE, bf16=True)
    _dense(cfg)
    stencil = cc.label_components_stencil
    calls = []
    cc.label_components_stencil = lambda *a, **k: calls.append(1) or stencil(*a, **k)
    try:
        r = _e2e_run(dev, cfg, "e2e dense", E2E_WARMUP, E2E_ITERS)
    finally:
        cc.label_components_stencil = stencil
    n = E2E_WARMUP + E2E_ITERS
    head = {name: float(p.grad.float().norm()) for name, p in r["model"].dense_detection_head.named_parameters()}
    if not all(v > 0.0 for v in head.values()):
        _fail(f"e2e dense: the dense head has a zero gradient: {head}")
    fg = (r["masks"] == 1).to(torch.int32)
    ops = _device_ops(lambda: stencil(fg), 3)
    per_call = sum(c for _, _, c in ops)
    print(f"[chip_smoke] e2e dense: dense head gradient norms { {k: f'{v:.3g}' for k, v in head.items()} }; "
          f"stencil CC {len(calls) / n:.0f} calls a step (L_shape's and the dense loss's ground truth), "
          f"{per_call} device operations a call ({', '.join(f'{key[:40]} x{c}' for key, _, c in ops[:3])})")
    launches["e2e dense"] = r["launches"]
    dense = dict(ms=r["ms"], host_ms=r["host_ms"], peak=r["peak"], cc_calls=len(calls) / n, cc_ops=per_call)
    _profile("e2e dense train step", lambda: r["step"](r["state"], r["imgs"], r["masks"], r["gen"]), r["ms"], steps=2)
    imgs, masks, gen = r["imgs"], r["masks"], r["gen"]
    del r
    torch.cuda.empty_cache()
    _e2e_fixed(cfg, imgs, masks, gen, "e2e dense")
    _e2e_vs_cpu(dev, _dense, "e2e dense step (fast instancing)")

    def dense_exact(c):
        _dense(c)
        c.training.instancing = "exact"

    _e2e_vs_cpu(dev, dense_exact, "e2e dense step (exact instancing)")

    # (b) Each ablation variant, the single-box head without fusion, class scores.
    variants = {f"e2e {v}": ("ablation", t) for v, t in ABLATION_VARIANTS.items()}
    variants.update({"e2e no fusion": ("ablation", {"use_fusion": False}),
                     "e2e class scores": ("dataset", {"num_detection_classes": 2})})
    for label, (section, toggles) in variants.items():
        cfg = _train_cfg(SIZE, bf16=True)
        target = cfg.dataset if section == "dataset" else cfg.model.ablation
        for k, v in toggles.items():
            setattr(target, k, v)
        r = _e2e_run(dev, cfg, label, 1, OPTION_STEPS - 1)
        launches[label] = r["launches"]
        del r
        torch.cuda.empty_cache()

    # (c) The U-Net without BN: the serving forward, the segmentation step.
    model, _, launches["serving no-BN"] = _main_path(dev, "serving no-BN", use_batchnorm=False)
    del model
    torch.cuda.empty_cache()
    cfg = _train_cfg(SIZE, bf16=True)
    _no_bn(cfg)
    launches["seg no-BN"] = _train_path(dev, cfg, "seg no-BN", 1, OPTION_STEPS - 1, fixed=False)[0]
    _train_vs_cpu(dev, _no_bn, exact_zero=lambda name: False, label="seg no-BN step")

    # (d) Remat against the plain steps.
    for kind in ("seg", "e2e"):
        launches[f"{kind} remat"] = _remat_vs_plain(dev, kind)

    # (e) Other Sobel sizes in the serving forward.
    for k in (5, 7):
        model, _, launches[f"serving sobel {k}"] = _main_path(dev, f"serving sobel {k}", sobel_kernel_size=k)
        del model
        torch.cuda.empty_cache()
    return launches, dense


MAX_INSTANCES = 16   # phase 16: instance slots (the config's max_instances)
EVAL_IMAGES = 8      # phase 16 (b): images each detector counts at batch 1
EVAL_FORMS = ("unet", "mingraph-unet", "mingraph-unet-refined")


def _annotated_batch(b: int, size: int, o: int, seed: int, dev):
    """Seeded uint8 orchard-like images with ``o`` instance slots each: rotated
    ellipses of mango-like axis ratios (between o/2 and o of them per image,
    the rest of the slots empty; later ones may overlap earlier ones),
    drawn with torch. Returns images, the union mask and the instance
    masks (B, O, H, W), uint8, on ``dev``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    ar = torch.arange(size, dtype=torch.float32)
    yy, xx = ar[:, None], ar[None, :]
    cy, cx = (0.1 + 0.8 * torch.rand((2, b, o, 1, 1), generator=g)) * size
    a = (0.03 + 0.04 * torch.rand((b, o, 1, 1), generator=g)) * size
    r = a * (0.68 + 0.2 * torch.rand((b, o, 1, 1), generator=g))
    t = torch.rand((b, o, 1, 1), generator=g) * math.pi
    dy, dx = yy - cy, xx - cx
    u, v = dx * torch.cos(t) + dy * torch.sin(t), dy * torch.cos(t) - dx * torch.sin(t)
    inst = (u / a) ** 2 + (v / r) ** 2 < 1.0
    inst &= (torch.arange(o) < torch.randint(o // 2, o + 1, (b, 1), generator=g))[..., None, None]
    mask = inst.any(1)
    ground, fruit = torch.tensor([40.0, 110.0, 35.0]), torch.tensor([230.0, 140.0, 30.0])
    img = torch.where(mask[..., None], fruit, ground) + 20.0 * torch.randn((b, size, size, 3), generator=g)
    return (img.clamp(0, 255).to(torch.uint8).to(dev), mask.to(torch.uint8).to(dev), inst.to(torch.uint8).to(dev))


def _annotated_step(dev, ckpt_dir: str, dense: dict):
    """Phase 16 (a): the e2e step with the dense head on annotated instances
    (see the module docstring). Saves the trained model with the port's
    checkpoint manager under ``ckpt_dir``. Returns its launches a step, its
    timings and the saved state dict."""
    import torch

    from mingraph_unet_tpu_torch.data.dataset import device_preprocess_batch
    from mingraph_unet_tpu_torch.ops import cc
    from mingraph_unet_tpu_torch.train.checkpoint import CheckpointManager
    from mingraph_unet_tpu_torch.train.common import draw_step_augment

    cfg = _train_cfg(SIZE, bf16=True)
    _dense(cfg)
    cfg.model.fusion_detection.max_instances = MAX_INSTANCES
    batch = _annotated_batch(BATCH, SIZE, MAX_INSTANCES, seed=11, dev=dev)
    imgs, masks, inst = batch
    saved = cc.label_components_stencil, cc.label_components
    calls = []
    cc.label_components_stencil = lambda *a, **k: calls.append(1) or saved[0](*a, **k)
    cc.label_components = lambda *a, **k: calls.append(1) or saved[1](*a, **k)
    try:
        r = _e2e_run(dev, cfg, "e2e annotated", E2E_WARMUP, E2E_ITERS, batch=batch)
    finally:
        cc.label_components_stencil, cc.label_components = saved
    if calls:
        _fail(f"e2e annotated: {len(calls)} connected-component calls over {E2E_WARMUP + E2E_ITERS} steps (expected 0)")
    head = {name: float(p.grad.float().norm()) for name, p in r["model"].dense_detection_head.named_parameters()}
    if not all(v > 0.0 for v in head.values()):
        _fail(f"e2e annotated: the dense head has a zero gradient: {head}")
    # The instances after augmentation stay inside their warped mask.
    pre = cfg.preprocessing
    draw = draw_step_augment(torch.Generator(device=dev).manual_seed(5), BATCH, SIZE, SIZE, pre)
    _, aug_masks, aug_inst = device_preprocess_batch(imgs, masks.long(), pre.normalization_mean,
                                                     pre.normalization_std, draw, num_classes=cfg.dataset.num_classes,
                                                     instances=inst)
    outside = int(((aug_inst > 0) & (aug_masks != 1)[:, None]).sum())
    inside = int((aug_inst > 0).sum())
    if outside or not inside or torch.equal(aug_inst.to(torch.uint8), inst):
        _fail(f"e2e annotated: {outside} augmented instance pixels outside their warped mask ({inside} inside)")
    print(f"[chip_smoke] e2e annotated: 0 connected-component calls a step; dense head gradient norms "
          f"{ {k: f'{v:.3g}' for k, v in head.items()} }; augmented instances: {inside} pixels, all inside their "
          f"warped mask")
    _profile("e2e annotated train step", lambda: r["step"](r["state"], r["imgs"], r["masks"], r["gen"], **r["extra"]),
             r["ms"], steps=2)
    CheckpointManager(ckpt_dir).save(r["state"].step, {"state": r["state"].state_dict(), "epoch": 0})
    weights = {k: v.detach().cpu().clone() for k, v in r["model"].state_dict().items()}
    out = dict(launches=r["launches"], ms=r["ms"], host_ms=r["host_ms"], peak=r["peak"])
    gen = r["gen"]
    del r
    torch.cuda.empty_cache()
    _e2e_fixed(cfg, imgs, masks, gen, "e2e annotated", extra={"instances": inst})

    def balanced(c):
        _dense(c)
        c.training.loss_balance = "uncertainty"

    _e2e_vs_cpu(dev, balanced, "e2e annotated step (balancer)", annotated=True)
    print(f"[chip_smoke] e2e annotated bf16 {BATCH}x{SIZE}^2: {out['ms']:.3f} ms/step (host {out['host_ms']:.3f}), "
          f"peak {out['peak']:.3f} GiB, 0 stencil-CC calls a step; the CC-ground-truth dense step of phase 15 (a): "
          f"{dense['ms']:.3f} ms/step (host {dense['host_ms']:.3f}), peak {dense['peak']:.3f} GiB, "
          f"{dense['cc_calls']:.0f} stencil-CC calls a step")
    return out, weights


def _objects(inst_masks):
    """Ground-truth objects of one image's instance masks (O, H, W): the
    yield metrics' schema, xyxy boxes of the non-empty slots."""
    from mingraph_unet_tpu_torch.ops import cc

    boxes = cc.instance_boxes(inst_masks).cpu().tolist()
    keep = inst_masks.flatten(1).any(1).cpu().tolist()
    return [{"bbox": bx, "class_id": 0, "occluded": False} for bx, k in zip(boxes, keep) if k]


def _eval_path(dev, ckpt_dir: str, weights):
    """Phase 16 (b): the evaluation path on the card (see the module
    docstring). Returns the launches a forward of each form."""
    import torch

    from mingraph_unet_tpu_torch.experiments import segmentation_performance as sp
    from mingraph_unet_tpu_torch.experiments import yield_estimation_performance as yp
    from mingraph_unet_tpu_torch.experiments.metrics import (average_precision, segmentation_metrics,
                                                             yield_estimation_metrics)
    from mingraph_unet_tpu_torch.models.detection import decode_dense_detections
    from mingraph_unet_tpu_torch.train.infer import load_variables

    loaded = load_variables(ckpt_dir)
    if sorted(loaded) != sorted(weights) or not all(torch.equal(loaded[k], weights[k]) for k in weights):
        _fail("phase 16 (b): the checkpoint's weights differ from the trained model's")
    cfg = _train_cfg(SIZE, bf16=True)
    _dense(cfg)
    models = {"unet": sp.build_eval_model(cfg, "unet", {k[5:]: v for k, v in loaded.items() if k.startswith("unet.")},
                                          dev),
              "mingraph-unet": sp.build_eval_model(cfg, "mingraph-unet", loaded, dev)}
    imgs, masks, inst = _annotated_batch(EVAL_IMAGES, SIZE, MAX_INSTANCES, seed=21, dev=dev)
    gt = [_objects(inst[i]) for i in range(EVAL_IMAGES)]
    expect = {"unet": dict(psel=4, dec1=2, pool=2, d2s=1, histeq=0)}
    expect.update({f: dict(psel=4, dec1=2, pool=2, d2s=2, histeq=1) for f in EVAL_FORMS[1:] + ("dense",)})
    launches = {}

    def counted(label, fn, x):
        _reset_counts()
        out = fn(x)
        torch.cuda.synchronize()
        got = _counts()
        if got != dict({k: 0 for k in got}, **expect[label]):
            _fail(f"eval {label}: launches a forward {got}, expected {expect[label]}")
        launches[f"eval {label}"] = got
        return out

    detectors = {f: (lambda x, f=f: yp.segmentation_count_detect(models["unet" if f == "unet" else "mingraph-unet"],
                                                                 cfg, x, f)) for f in EVAL_FORMS}
    detectors["dense"] = lambda x: yp.dense_head_detect(models["mingraph-unet"], cfg, x)
    for label, fn in detectors.items():
        dets = []
        for i in range(EVAL_IMAGES):
            x = imgs[i : i + 1]
            out = counted(label, fn, x) if i == 0 else fn(x)
            if label == "dense":
                # The card's decode against the plain decode on the CPU over the card's own dense outputs, at
                # the detector's score threshold and at 0 (every NMS survivor valid: the check is not empty).
                raw = sp.eval_forward(models["mingraph-unet"], cfg, x)
                dense_out = raw["dense_objectness_logits"], raw["dense_boxes"]
                for thr in (0.5, 0.0):
                    args = dict(image_hw=(SIZE, SIZE), cell_size=cfg.model.graph_construction.patch_size, top_k=32,
                                score_threshold=thr)
                    card = decode_dense_detections(*dense_out, **args)
                    cpu = decode_dense_detections(*(t.cpu() for t in dense_out), **args)
                    if not all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)) or not bool(cpu[2].any() or thr):
                        _fail(f"eval dense image {i}: the card's decode differs from the CPU's (threshold {thr})")
                    if thr and not all(torch.equal(a, b) for a, b in zip(out, card)):
                        _fail(f"eval dense image {i}: the detector's device function is not deterministic")
                boxes, scores, valid = (t[0].cpu() for t in out)
                dets.append([{"bbox": bx.tolist(), "class_id": 0, "confidence": float(sc)}
                             for bx, sc, v in zip(boxes, scores, valid) if v])
            else:
                # The CC instancing over the card's logits against the CPU's over the same logits.
                logits = sp.segmentation_logits(models["unet" if label == "unet" else "mingraph-unet"], cfg, x, label)
                card, cpu = yp.instances_from_logits(logits), yp.instances_from_logits(logits.cpu())
                same = torch.equal(card[0].cpu(), cpu[0]) and torch.equal(card[1].cpu(), cpu[1])
                if not same or not torch.allclose(card[2].cpu(), cpu[2], rtol=1e-5, atol=1e-6):
                    _fail(f"eval {label} image {i}: the card's CC instances differ from the CPU's")
                if not all(torch.equal(a, b) for a, b in zip(out, card)):
                    _fail(f"eval {label} image {i}: the detector's device function is not deterministic")
                boxes, areas, conf = (t.cpu() for t in out)
                dets.append([{"bbox": bx.tolist(), "class_id": 0, "confidence": float(c)}
                             for bx, a, c in zip(boxes[0], areas[0], conf[0]) if a > 0])
        # images/s at batch 1, the host's resize left out (the images are at the config's size).
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(EVAL_IMAGES):
            fn(imgs[i : i + 1])
        torch.cuda.synchronize()
        per_s = EVAL_IMAGES / (time.perf_counter() - t0)
        metrics = yield_estimation_metrics([len(g) for g in gt], [len(d) for d in dets], gt, dets)
        metrics["ap50_perc"] = 100.0 * average_precision(gt, dets, 0.5)
        if not all(math.isfinite(v) for v in metrics.values()):
            _fail(f"eval {label}: non-finite yield metrics {metrics}")
        print(f"[chip_smoke] eval {label} detector, batch 1 bf16 {SIZE}^2: {per_s:.2f} images/s; "
              f"{sum(len(d) for d in dets)} detections on {EVAL_IMAGES} images; yield metrics "
              f"{ {k: round(v, 3) for k, v in metrics.items()} }; launches a forward {launches[f'eval {label}']}; "
              f"decode / CC instancing equal to the CPU's: ok")
    # Table 1's forward at batch 8.
    trues = masks.cpu().numpy().reshape(-1)
    for form in EVAL_FORMS:
        model = models["unet" if form == "unet" else "mingraph-unet"]
        fwd = lambda x, form=form, model=model: sp.segmentation_logits(model, cfg, x, form)  # noqa: E731
        _reset_counts()
        logits = fwd(imgs)
        torch.cuda.synchronize()
        got = _counts()
        if got != dict({k: 0 for k in got}, **expect[form]):
            _fail(f"eval {form} Table-1 forward at batch {EVAL_IMAGES}: launches {got}, expected {expect[form]}")
        ms = _time_ms(lambda: fwd(imgs), 5)
        res = segmentation_metrics(trues, logits.argmax(-1).cpu().numpy().reshape(-1), 2)
        if not all(math.isfinite(v) for v in (res["mean_iou"], res["mean_f1"])) or not torch.isfinite(logits).all():
            _fail(f"eval {form}: non-finite Table-1 metrics or logits")
        print(f"[chip_smoke] eval {form} Table-1 forward bf16 {EVAL_IMAGES}x{SIZE}^2: {ms:.3f} ms, "
              f"{EVAL_IMAGES / ms * 1e3:.1f} images/s; mean IoU {res['mean_iou']:.4f}, mean F1 {res['mean_f1']:.4f}")
    out = sp.eval_forward(models["mingraph-unet"], cfg, imgs)
    blend = lambda: sp.region_blend_logits(out["logits"].float(), out["hard_patch_labels"],  # noqa: E731
                                           cfg.model.graph_construction.patch_size, cfg.dataset.num_semantic_regions)
    got, ref = blend(), sp.region_blend_logits(out["logits"].float().cpu(), out["hard_patch_labels"].cpu(),
                                              cfg.model.graph_construction.patch_size, cfg.dataset.num_semantic_regions)
    _check_close("region_blend_logits (card vs CPU)", got.cpu(), ref, F32_TOL, border=False, what="the CPU")
    print(f"[chip_smoke] region_blend_logits bf16 logits {EVAL_IMAGES}x{SIZE}^2: {_time_ms(blend, 10):.3f} ms")
    return launches


def _native_loader() -> None:
    """Phase 16 (c): the C++ PNG loader built with g++ on the card's machine
    and held bit for bit against the arrays a stdlib writer wrote."""
    import tempfile

    import numpy as np

    from mingraph_unet_tpu_torch.data import native_loader
    from mingraph_unet_tpu_torch.data.png import png_bytes
    from mingraph_unet_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.host_library("decode")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), np.uint8)
    imgs[:, ::7] //= 3   # runs of equal and smooth values beside the noise
    masks = (rng.random((BATCH, SIZE, SIZE)) < 0.3).astype(np.uint8)
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i in range(BATCH):
            for kind, arr in (("img", imgs[i]), ("mask", masks[i])):
                path = os.path.join(d, f"{kind}{i}.png")
                with open(path, "wb") as f:
                    f.write(png_bytes(arr))
                paths.append(path)
        t0 = time.perf_counter()
        out = native_loader.load_batch(paths[0::2], paths[1::2], (SIZE, SIZE), threads=8)
        load_s = time.perf_counter() - t0
    if out is None or not (np.array_equal(out[0], imgs) and np.array_equal(out[1], masks)):
        _fail("the native loader's decode differs from the PNGs' arrays")
    print(f"[chip_smoke] native loader: built in {build_s:.1f}s; {BATCH} RGB + {BATCH} gray {SIZE}^2 PNGs (five "
          f"filter types) decoded bit-equal in {load_s * 1e3:.1f} ms ({BATCH / load_s:.1f} images/s, 8 threads)")


def _annotated_path(dev, dense: dict):
    """Phase 16: (a) the annotated e2e step, (b) the evaluation path on its
    saved weights, (c) the native loader. Returns the launches a step (a
    forward) of each path and the annotated step's timings."""
    import tempfile

    with tempfile.TemporaryDirectory() as ckpt_dir:
        step, weights = _annotated_step(dev, ckpt_dir, dense)
        launches = {"e2e annotated": step["launches"]}
        launches.update(_eval_path(dev, ckpt_dir, weights))
    _native_loader()
    return launches, step


def _attach_launches(rows, paths, key: str = "launches_options") -> None:
    """Each kernel row gets ``key``: its launches a step (a forward) on each
    of the phase's ``paths`` (phase 15: ``launches_options``, phase 16:
    ``launches_annotated``)."""
    for row in rows:
        counter = ROW_COUNTER[row["name"].split(" ")[0]]
        row[key] = {path: counts[counter] for path, counts in paths.items()}


CLI_IMAGES = 16       # phase 17: the mask dataset the training CLIs read (2 steps of batch 8)
TRACE_FORWARDS = 5    # phase 17: serving forwards under trace_if
# Phase 17: each hand-written kernel of the serving forward → (its device
# function's name, the wrapper module whose frame launches it).
TRACED_KERNELS = {"psel": ("psel_wgmma_kernel", "ops/kernels/psconv.py"),
                  "dec1": ("dec1_wgmma_kernel", "ops/kernels/psconv.py"),
                  "pool": ("phase_max_pool_kernel", "ops/kernels/pool.py"),
                  "d2s": ("depth_to_space_kernel", "ops/kernels/pool.py"),
                  "histeq": ("histeq_kernel", "ops/kernels/histeq.py")}
# The stages of the port's serving forward, by source (first match wins),
# as the JAX package's bench.py folds its trace.
STAGE_RULES = [
    ("unet", ("models/unet.py", "ops/kernels/psconv.py", "ops/kernels/pool.py", "ops/s2d.py", "ops/conv.py")),
    ("detection", ("models/detection.py",)),
    ("aux_filters", ("ops/filters.py", "ops/kernels/histeq.py")),
    ("graph_fusion", ("models/gat.py", "models/mincut.py", "models/fusion.py", "ops/segment.py",
                      "ops/patches.py", "ops/lattice.py", "models/pipeline.py")),
]


def _cli_dataset(root: str) -> tuple:
    """Phase 17's files, all PNGs by the package's stdlib writer: a mask
    dataset of ``CLI_IMAGES`` orchard-like RGB images (orange discs on
    green with noise) under ``root/data/train``, one more image and a
    1024² scene. Returns (test image path, scene path)."""
    import numpy as np

    from mingraph_unet_tpu_torch.data.png import write_png

    rng = np.random.default_rng(17)

    def scene(size: int):
        img = np.empty((size, size, 3), np.float32)
        img[:] = (40, 110, 35)
        img += rng.normal(0, 12, img.shape)
        mask = np.zeros((size, size), np.uint8)
        yy, xx = np.mgrid[:size, :size]
        for _ in range(int(rng.integers(3, 9)) * (size // 512) ** 2):
            cy, cx = rng.uniform(0.1, 0.9, 2) * size
            ry, rx = rng.uniform(0.03, 0.08, 2) * size
            disc = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
            img[disc] = (230, 140, 30) + rng.normal(0, 10, (int(disc.sum()), 3))
            mask[disc] = 1
        return np.clip(img, 0, 255).astype(np.uint8), mask

    train = os.path.join(root, "data", "train")
    os.makedirs(os.path.join(train, "images"))
    os.makedirs(os.path.join(train, "masks"))
    for i in range(CLI_IMAGES):
        img, mask = scene(SIZE)
        write_png(os.path.join(train, "images", f"img_{i:03d}.png"), img)
        write_png(os.path.join(train, "masks", f"img_{i:03d}.png"), mask)
    image = write_png(os.path.join(root, "test_image.png"), scene(SIZE)[0])
    return image, write_png(os.path.join(root, "scene.png"), scene(SCENE)[0])


def _cli_configs(root: str, name: str) -> str:
    """A config directory from the repo's ``configs/*.yaml`` (read and
    written by the port's YAML code) at 512², batch 8, one epoch, its own
    checkpoint and log directories."""
    from mingraph_unet_tpu_torch.config import load_yaml, write_yaml

    here = os.path.dirname(os.path.abspath(__file__))
    cfg_dir = os.path.join(root, name, "configs")
    os.makedirs(cfg_dir)
    changes = {"dataset.yaml": {"data_root": os.path.join(root, "data"), "image_height": SIZE, "image_width": SIZE},
               "model.yaml": {},
               "preprocessing.yaml": {"resize_dim": [SIZE, SIZE]},
               "training.yaml": {"batch_size": BATCH, "num_epochs": 1,
                                 "checkpoint_dir": os.path.join(root, name, "checkpoints"),
                                 "log_dir": os.path.join(root, name, "logs")}}
    for file, update in changes.items():
        data = load_yaml(os.path.join(here, "configs", file))
        missing = set(update) - set(data)
        if missing:
            _fail(f"phase 17: configs/{file} has no {sorted(missing)}")
        write_yaml(os.path.join(cfg_dir, file), {**data, **update})
    return cfg_dir


def _timed_cli(label: str, main, argv):
    """One CLI ``main(argv)`` in process with the launch counters from 0:
    (its result, launches, wall seconds, peak GiB)."""
    import torch

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if sys.modules.get("cv2") is not None:
        _fail(f"{label} imported OpenCV")
    print(f"[chip_smoke] {label}: {wall:.3f} s wall, peak {peak:.3f} GiB, launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return out, launches, wall, peak


def _expect_launches(label: str, launches, want) -> None:
    full = {k: 0 for k in _wrappers()}
    full.update(want)
    if launches != full:
        _fail(f"phase 17: {label} launched {launches}, expected {full}")


def _train_cli(label: str, main, cfg_dir: str, per_step):
    """A training CLI for one epoch: every batch decoded by the C++
    loader, the launches a step, finite losses, the checkpoint read back
    bit-equal to the trained weights."""
    import math

    import torch

    from mingraph_unet_tpu_torch.data import native_loader
    from mingraph_unet_tpu_torch.train.infer import load_variables

    decoded = []
    real = native_loader.load_batch
    native_loader.load_batch = lambda *a, **k: decoded.append(len(a[0])) or real(*a, **k)
    try:
        (state, history), launches, wall, peak = _timed_cli(label, main, ["--config_path", cfg_dir, "--epochs", "1"])
    finally:
        native_loader.load_batch = real
    steps = CLI_IMAGES // BATCH
    if decoded != [BATCH] * steps:
        _fail(f"phase 17: {label}: the native loader decoded batches {decoded}, expected {steps} of {BATCH}")
    _expect_launches(label, launches, {k: n * steps for k, n in per_step.items()})
    if len(history["epoch_loss"]) != 1 or not math.isfinite(history["epoch_loss"][0]):
        _fail(f"phase 17: {label}: epoch losses {history['epoch_loss']}")
    saved = load_variables(os.path.join(os.path.dirname(cfg_dir), "checkpoints"))
    own = state.model.state_dict()
    if sorted(saved) != sorted(own) or not all(torch.equal(saved[k], v.cpu()) for k, v in own.items()):
        _fail(f"phase 17: {label}: the checkpoint read back differs from the trained weights")
    print(f"[chip_smoke] {label}: {steps} steps, epoch loss {history['epoch_loss'][0]:.4f}, "
          f"{CLI_IMAGES / wall:.2f} images/s over the whole call (set-up included), checkpoint read back "
          f"bit-equal ({len(own)} tensors)")
    return dict(per_step), wall, peak


def _infer_cli(label: str, argv, size, main):
    """An inference CLI on the card: the launches of one f32 U-Net eval
    forward (K8 at its five standard-layout blocks) and the label PNG,
    decoded by the C++ loader, equal to the labels the call returned
    (``size``: the labels' side, or their (H, W))."""
    import numpy as np

    from mingraph_unet_tpu_torch.data import native_loader

    hw = (size, size) if isinstance(size, int) else tuple(size)
    out, launches, wall, _ = _timed_cli(label, main, argv)
    _expect_launches(label, launches, {"psel": 4, "dec1": 2, "pool": 2, "d2s": 1, "conv_block": 5})
    labels = out["labels"]
    decoded = native_loader.load_mask(out["label_path"], hw)
    if labels.shape != hw or decoded is None or not np.array_equal(decoded, labels.astype(np.uint8)):
        _fail(f"phase 17: {label}: the label PNG differs from the labels returned")
    print(f"[chip_smoke] {label}: labels {labels.shape}, foreground share {float((labels == 1).mean()):.4f}, "
          f"label PNG decoded equal")
    return launches, wall


def _traced_forwards(dev):
    """``setup_host()``, then ``trace_if`` around ``TRACE_FORWARDS`` serving
    forwards, ``parse_device_trace`` and ``attribute_stages``: every
    hand-written kernel in the rows, launched as often as the counters
    say, from its wrapper, in a stage; the stage sums equal the rows'
    total; ``StepTimer`` within 5% of CUDA events."""
    import tempfile

    import torch

    from mingraph_unet_tpu_torch.utils.env import setup_host
    from mingraph_unet_tpu_torch.utils.profiling import StepTimer, attribute_stages, parse_device_trace, trace_if

    if setup_host() != dev:
        _fail(f"phase 17: setup_host() gave another device than {dev}")
    model, x = _serving_model(dev)
    with torch.no_grad():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as trace_dir:
            _reset_counts()
            t0 = time.perf_counter()
            with trace_if(trace_dir):
                for _ in range(TRACE_FORWARDS):
                    out = model(x)
                torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
            launches = _counts()
            t0 = time.perf_counter()
            rows = parse_device_trace(trace_dir, TRACE_FORWARDS)
            parse_s = time.perf_counter() - t0
            size = sum(os.path.getsize(os.path.join(trace_dir, f)) for f in os.listdir(trace_dir))
        timer = StepTimer()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        timer.start()
        for _ in range(TRACE_FORWARDS):
            out = model(x)
        end.record()
        timer_ms = timer.stop(out["logits"])
        event_ms = start.elapsed_time(end)
    _expect_launches("traced serving forwards", launches,
                     {k: n * TRACE_FORWARDS for k, n in {"psel": 4, "dec1": 2, "pool": 2, "d2s": 1, "histeq": 1}.items()})
    stages = attribute_stages(rows, STAGE_RULES)
    total_ms = sum(r["us_per_step"] for r in rows) / 1e3
    print(f"[chip_smoke] traced {TRACE_FORWARDS} serving forwards in {traced_s:.1f} s (trace {size / 2**20:.1f} MiB "
          f"gzipped, parsed in {parse_s:.1f} s): {len(rows)} rows, {total_ms:.3f} ms of device time a forward, "
          f"{sum(r['launches_per_step'] for r in rows):.0f} device operations a forward; stages (ms/forward) {stages}")
    if not rows or abs(sum(stages.values()) - total_ms) > 5e-4 * len(stages):
        _fail(f"phase 17: the stage sums {stages} differ from the rows' total {total_ms:.3f} ms")
    for r in rows[:8]:
        print(f"[chip_smoke]   {r['us_per_step']:9.1f} us/forward {r['launches_per_step']:5.1f}x  "
              f"{r['op'][:60]}  <- {r['source'][:70]}")
    for counter, (kernel, module) in TRACED_KERNELS.items():
        mine = [r for r in rows if kernel in r["op"]]
        per_step = sum(r["launches_per_step"] for r in mine)
        sources = sorted({r["source"] for r in mine})
        if per_step != launches[counter] / TRACE_FORWARDS:
            _fail(f"phase 17: the trace holds {per_step} {kernel} a forward, the counter {launches[counter]} "
                  f"in {TRACE_FORWARDS}")
        if not all(module in src for src in sources) or "other" in attribute_stages(mine, STAGE_RULES):
            _fail(f"phase 17: {kernel} attributed to {sources}, not to its wrapper in {module}")
        print(f"[chip_smoke]   {kernel}: {per_step:.0f} a forward, {sum(r['us_per_step'] for r in mine):.1f} us, "
              f"from {sources}")
    if abs(timer_ms - event_ms) > 0.05 * event_ms:
        _fail(f"phase 17: StepTimer {timer_ms:.3f} ms against CUDA events {event_ms:.3f} ms")
    print(f"[chip_smoke] StepTimer {timer_ms:.3f} ms against CUDA events {event_ms:.3f} ms over {TRACE_FORWARDS} "
          f"forwards ({timer_ms / event_ms:.4f})")
    del model, x, out
    return {k: v // TRACE_FORWARDS for k, v in launches.items()}


def _cli_path(dev):
    """Phase 17: the CLIs on the card at ``configs/*.yaml``'s widths from a
    config directory written by the port's YAML code, then the profiling
    hooks. Returns the launches a step (a call) of each."""
    import math
    import tempfile

    import torch

    from mingraph_unet_tpu_torch.scripts import graph_refinement, infer_segmentation, train_end_to_end
    from mingraph_unet_tpu_torch.scripts import train_segmentation

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        image, scene = _cli_dataset(root)
        seg_cfg, e2e_cfg = _cli_configs(root, "seg"), _cli_configs(root, "e2e")
        print(f"[chip_smoke] phase 17: {CLI_IMAGES} + 2 PNGs and two config directories written in "
              f"{time.perf_counter() - t0:.1f} s")
        paths = {}
        paths["train_segmentation step"], seg_s, seg_peak = _train_cli(
            "train_segmentation", train_segmentation.main, seg_cfg, {"k4_fwd": 4, "k4_dgrad": 4, **K10_STEP})
        paths["train_end_to_end step"], e2e_s, e2e_peak = _train_cli(
            "train_end_to_end", train_end_to_end.main, e2e_cfg, {"k4_fwd": 4, "k4_dgrad": 4, "histeq": 1,
                                                                 **K10_E2E_STEP})
        weights = os.path.join(root, "seg", "checkpoints")
        common = ["--config_path", seg_cfg, "--weights_path", weights]
        paths["infer_segmentation"], infer_s = _infer_cli(
            "infer_segmentation", common + ["--image_path", image, "--output_dir", os.path.join(root, "out")],
            SIZE, infer_segmentation.main)
        paths["infer_segmentation --large_scene"], scene_s = _infer_cli(
            "infer_segmentation --large_scene", common + ["--image_path", scene, "--output_dir",
                                                          os.path.join(root, "out"), "--large_scene", "--tile",
                                                          str(TILE), "--halo", str(HALO)],
            SCENE, infer_segmentation.main)
        (l_part, hard), launches, graph_s, _ = _timed_cli(
            "graph_refinement", graph_refinement.main, ["--config_path", seg_cfg, "--image_path", image])
        _expect_launches("graph_refinement", launches, {"histeq": 1})
        if not math.isfinite(l_part) or hard.shape != (SIZE // 16, SIZE // 16):
            _fail(f"phase 17: graph_refinement gave L_partition {l_part}, labels {hard.shape}")
        paths["graph_refinement"] = launches
    torch.cuda.empty_cache()
    paths["traced serving forward"] = _traced_forwards(dev)
    phase_s = time.perf_counter() - t_phase
    print(f"[chip_smoke] cli_seconds train_segmentation {seg_s:.3f} train_end_to_end {e2e_s:.3f} "
          f"infer_segmentation {infer_s:.3f} infer_large_scene {scene_s:.3f} graph_refinement {graph_s:.3f} "
          f"phase_17 {phase_s:.1f}")
    print(f"[chip_smoke] cli_train_images_per_s segmentation {CLI_IMAGES / seg_s:.2f} end_to_end "
          f"{CLI_IMAGES / e2e_s:.2f} (f32, configs/training.yaml's bf16: false; whole calls) peak_gib segmentation "
          f"{seg_peak:.3f} end_to_end {e2e_peak:.3f}; graph_refinement L_partition {l_part:.6f}")
    return {k: {c: v.get(c, 0) for c in _wrappers()} for k, v in paths.items()}


JPEG_FIXTURES = os.path.join("tests", "fixtures", "jpeg")   # phase 18: the decoders' fixtures and manifest
DATA_DECODES = 20     # phase 18 (a): one-thread decodes of the scene JPEG timed
DATA_BATCHES = 5      # phase 18 (a): load_batch calls (8 x 512², 4 threads) timed
DATA_SPLIT = 16       # phase 18 (b): 512² scenes of the generated split
JPEG_EPOCHS = 2       # phase 18 (c): epochs of one batch-8 step over the scene's 8 copies


def _sha256(arr) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _instances_digest(instances) -> str:
    """SHA-256 of an instance list as canonical JSON, as
    ``tests/fixtures/jpeg/make_fixtures.py`` records it."""
    import hashlib

    import numpy as np

    rows = [{"poly": np.asarray(i["poly"]).tolist(), "bbox": [float(v) for v in i["bbox"]],
             "occluded": bool(i["occluded"])} for i in instances]
    return hashlib.sha256(json.dumps(rows, sort_keys=True).encode()).hexdigest()


def _all_finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_all_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_all_finite(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


def _decode_fixtures(fixtures: str, manifest: dict):
    """Phase 18 (a): every fixture decoded equal to OpenCV's recorded
    arrays, and the host's decode rates. Returns (one-thread images/s,
    load_batch images/s)."""
    from mingraph_unet_tpu_torch.data import native_loader

    for name, rec in sorted(manifest["files"].items()):
        path = os.path.join(fixtures, name)
        colour = native_loader.decode(path)[..., ::-1]  # OpenCV's BGR
        grey = native_loader.decode(path, gray=True)
        for what, arr in (("color_bgr", colour), ("gray", grey)):
            if list(arr.shape) != rec[what]["shape"] or _sha256(arr) != rec[what]["sha256"]:
                _fail(f"phase 18 (a): {name} ({what}) decodes to another array than OpenCV's")
    print(f"[chip_smoke] phase 18 (a): {len(manifest['files'])} fixtures decoded, colour and grey, each equal to "
          f"cv2.imread's array (SHA-256 of the manifest)")
    scene = os.path.join(fixtures, "scene.jpg")
    native_loader.decode(scene)
    t0 = time.perf_counter()
    for _ in range(DATA_DECODES):
        native_loader.decode(scene)
    one = DATA_DECODES / (time.perf_counter() - t0)
    native_loader.load_batch([scene] * BATCH, None, (SIZE, SIZE), threads=4, exact=True)
    t0 = time.perf_counter()
    for _ in range(DATA_BATCHES):
        out = native_loader.load_batch([scene] * BATCH, None, (SIZE, SIZE), threads=4, exact=True)
    pool = DATA_BATCHES * BATCH / (time.perf_counter() - t0)
    if out is None or not out[0].any():
        _fail("phase 18 (a): load_batch failed on the scene JPEG")
    return one, pool


def _jpeg_train_dir(root: str, fixtures: str) -> str:
    """Phase 18 (c)'s data: the scene JPEG 8 times and a COCO file of its
    fruit polygons (from the committed ``scene.json``) naming each copy.
    Returns the config directory (``configs/*.yaml``, 512², batch 8, bf16,
    the dense head, the annotation file)."""
    import shutil

    from mingraph_unet_tpu_torch.config import load_yaml, write_yaml

    img_dir = os.path.join(root, "data", "train", "images")
    os.makedirs(img_dir)
    with open(os.path.join(fixtures, "scene.json")) as f:
        coco = json.load(f)
    base = coco["images"][0]
    images, anns = [], []
    for k in range(BATCH):
        shutil.copy(os.path.join(fixtures, "scene.jpg"), os.path.join(img_dir, f"scene_{k}.jpg"))
        images.append(dict(base, id=k, file_name=f"scene_{k}.jpg"))
        anns += [dict(a, id=len(anns) + 1, image_id=k) for a in coco["annotations"]]
    ann_file = os.path.join(root, "data", "train", "annotations.json")
    with open(ann_file, "w") as f:
        json.dump(dict(coco, images=images, annotations=anns), f)
    cfg_dir = _cli_configs(root, "jpeg")
    for file, change in (("dataset.yaml", lambda d: d.update(annotations_file=ann_file)),
                         ("model.yaml", lambda d: d["fusion_detection"].update(use_dense_detection=True)),
                         ("training.yaml", lambda d: d.update(bf16=True))):
        data = load_yaml(os.path.join(cfg_dir, file))
        change(data)
        write_yaml(os.path.join(cfg_dir, file), data)
    return cfg_dir


def _data_path(dev):
    """Phase 18: the data layer on files, with ``import cv2`` failing.
    Returns the launches a step (a call) of (c) and (d)."""
    import importlib.util

    if sys.modules.get("cv2") is not None:
        _fail("phase 18: an earlier phase imported OpenCV")
    installed = importlib.util.find_spec("cv2") is not None
    sys.modules["cv2"] = None  # from here on `import cv2` raises ImportError, whether or not OpenCV is installed
    try:
        import cv2  # noqa: F401
        _fail("phase 18: OpenCV could still be imported")
    except ImportError:
        pass
    print(f"[chip_smoke] phase 18: OpenCV {'is' if installed else 'is not'} installed here; the phase runs with "
          "`import cv2` failing")
    try:
        return _data_phase(dev)
    finally:
        if sys.modules.get("cv2", None) is not None:
            _fail("phase 18: the data layer imported OpenCV")
        sys.modules.pop("cv2", None)


def _data_phase(dev):
    import tempfile

    import numpy as np
    import torch

    from mingraph_unet_tpu_torch.config import PipelineConfig
    from mingraph_unet_tpu_torch.data import native_loader, synthetic
    from mingraph_unet_tpu_torch.scripts import graph_refinement, infer_segmentation, run_results, train_end_to_end
    from mingraph_unet_tpu_torch.scripts import train_segmentation
    from mingraph_unet_tpu_torch.train.checkpoint import CheckpointManager
    from mingraph_unet_tpu_torch.train.segmentation import build_unet

    t_phase = time.perf_counter()
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), JPEG_FIXTURES)
    with open(os.path.join(fixtures, "manifest.json")) as f:
        manifest = json.load(f)
    decode_one, decode_pool = _decode_fixtures(fixtures, manifest)
    paths, seconds, peaks = {}, {}, {}
    with tempfile.TemporaryDirectory() as root:
        # (b) the synthetic orchard, and the seeded scene against the JAX generator's digests
        t0 = time.perf_counter()
        synthetic.generate_orchard_dataset(os.path.join(root, "orchard"), DATA_SPLIT, 0, 0, (SIZE, SIZE), seed=18)
        generate = DATA_SPLIT / (time.perf_counter() - t0)
        syn = manifest["synthetic"]
        _, mask, instances = synthetic.render_orchard_scene(np.random.default_rng(syn["seed"]), *syn["size"])
        if _sha256(mask) != syn["mask_sha256"] or _instances_digest(instances) != syn["instances_sha256"]:
            _fail("phase 18 (b): the seeded 512² scene's mask or instances differ from the JAX generator's")
        print(f"[chip_smoke] phase 18 (b): {DATA_SPLIT} scenes of 512² written, {generate:.2f} images/s; the seeded "
              f"scene's mask and {len(instances)} instances equal to the JAX generator's")
        # (c) annotated training from JPEG files
        cfg_dir = _jpeg_train_dir(root, fixtures)
        decoded = []
        real = native_loader.load_batch
        native_loader.load_batch = lambda *a, **k: decoded.append((len(a[0]), k.get("exact"))) or real(*a, **k)
        try:
            (state, history), launches, seconds["train_jpeg"], peaks["train_jpeg"] = _timed_cli(
                "train_end_to_end on JPEG + COCO", train_end_to_end.main,
                ["--config_path", cfg_dir, "--epochs", str(JPEG_EPOCHS)])
        finally:
            native_loader.load_batch = real
        if decoded != [(BATCH, True)] * JPEG_EPOCHS:
            _fail(f"phase 18 (c): the loader decoded {decoded}, expected {JPEG_EPOCHS} batches of {BATCH} JPEGs")
        per_step = {"k4_fwd": 4, "k4_dgrad": 4, "histeq": 1}
        _expect_launches("train_end_to_end on JPEG + COCO", launches, {k: n * JPEG_EPOCHS for k, n in per_step.items()})
        if not all(math.isfinite(v) for v in history["epoch_loss"]) or len(history["epoch_loss"]) != JPEG_EPOCHS:
            _fail(f"phase 18 (c): epoch losses {history['epoch_loss']}")
        paths["train_end_to_end JPEG step"] = per_step
        print(f"[chip_smoke] phase 18 (c): {JPEG_EPOCHS} annotated bf16 steps on {BATCH} JPEGs, epoch losses "
              f"{[round(v, 4) for v in history['epoch_loss']]}, {JPEG_EPOCHS * BATCH / seconds['train_jpeg']:.2f} "
              f"images/s over the whole call")
        # (d) inference on the JPEG, at resize_dim and as a large scene
        seg_cfg = _cli_configs(root, "seg")
        torch.manual_seed(18)
        weights = os.path.join(root, "seg", "checkpoints")
        CheckpointManager(weights).save(0, build_unet(PipelineConfig.from_config_dir(seg_cfg), dev).state_dict())
        scene = os.path.join(fixtures, "scene.jpg")
        common = ["--config_path", seg_cfg, "--weights_path", weights, "--image_path", scene, "--output_dir",
                  os.path.join(root, "out")]
        paths["infer_segmentation JPEG"], seconds["infer_jpeg"] = _infer_cli(
            "infer_segmentation on the JPEG", common, SIZE, infer_segmentation.main)
        paths["infer_segmentation --large_scene JPEG"], seconds["infer_jpeg_large"] = _infer_cli(
            "infer_segmentation --large_scene on the JPEG",
            common + ["--large_scene", "--tile", str(TILE), "--halo", str(HALO)], manifest["scene"]["size"],
            infer_segmentation.main)
        # (e) the four CLIs' smoke runs and run_results --quick
        for name, main, argv in (("train_segmentation", train_segmentation.main, []),
                                 ("train_end_to_end", train_end_to_end.main, []),
                                 ("infer_segmentation", infer_segmentation.main,
                                  ["--output_dir", os.path.join(root, "smoke")]),
                                 ("graph_refinement", graph_refinement.main, [])):
            _, _, seconds[f"smoke_{name}"], _ = _timed_cli(f"{name} smoke run", main, argv)
        results, _, seconds["run_results_quick"], peaks["run_results_quick"] = _timed_cli(
            "run_results --quick", run_results.main,
            ["--quick", "--out", os.path.join(root, "results"), "--results_dir", os.path.join(root, "outputs")])
        tables = {k: results[k] for k in ("table1_segmentation", "table2_yield", "table3_ablation")}
        if not tables["table1_segmentation"] or not tables["table3_ablation"] or not _all_finite(tables):
            _fail(f"phase 18 (e): run_results --quick gave tables {tables}")
        print(f"[chip_smoke] phase 18 (e): run_results --quick: Tables 1-3 finite ({len(tables['table1_segmentation'])}"
              f" / {len(tables['table2_yield'])} / {len(tables['table3_ablation'])} rows)")
    torch.cuda.empty_cache()
    print(f"[chip_smoke] data_decode_images_per_s scene_jpeg_one_thread {decode_one:.2f} "
          f"load_batch_4_threads_512 {decode_pool:.2f} generate_512_images_per_s {generate:.2f}")
    print("[chip_smoke] data_seconds " + " ".join(f"{k} {v:.3f}" for k, v in seconds.items())
          + f" phase_18 {time.perf_counter() - t_phase:.1f}")
    print("[chip_smoke] data_peak_gib " + " ".join(f"{k} {v:.3f}" for k, v in peaks.items()))
    return {k: {c: v.get(c, 0) for c in _wrappers()} for k, v in paths.items()}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("[chip_smoke] PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this script runs on the card", file=sys.stderr)
        return 2
    try:
        from mingraph_unet_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f"[chip_smoke] the port is not importable from here: {e}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"[chip_smoke] build: {time.perf_counter() - t0:.1f}s ({', '.join(built) or 'cached'})")
    for name in build.SOURCES:
        log = build.compiler_log(name).splitlines()
        regs = [ln.split(":", 1)[-1].strip() for ln in log if "Used" in ln and "registers" in ln]
        spills = [ln.strip() for ln in log if "spill stores" in ln and " 0 bytes spill stores" not in ln]
        serial = [ln.strip() for ln in log if "wgmma.mma_async instructions are serialized" in ln]
        print(f"[chip_smoke]   {name}: {'; '.join(regs)}; spills: {'; '.join(spills) or 'none'}; "
              f"wgmma serialized: {'; '.join(serial) or 'none'}")
        if serial and (name in ("conv_block", "psel_conv") or any(DEC1_SPLIT in ln for ln in serial)):
            _fail(f"ptxas serializes {name}'s wgmma instructions")

    model, x, launches = _main_path(dev)
    fwd_ms = _forward_time(model, x)
    _profile("forward", lambda: model(x), fwd_ms)
    del model, x
    torch.cuda.empty_cache()
    scene_launches, scene_ms, scene_host_ms, scene_peak = _large_scene(dev)
    train_launches, train_ms, train_host_ms, train_peak = _train_path(dev, _train_cfg(SIZE, bf16=True), "train",
                                                                       TRAIN_WARMUP, TRAIN_ITERS)
    _train_vs_cpu(dev)
    f32_launches = _f32_path(dev)
    k10_rows = _conv3x3_path(dev)
    e2e_launches, e2e_ms, e2e_host_ms, e2e_peak = _e2e_path(dev)
    _e2e_vs_cpu(dev)
    rows = (_kernel_table(dev, launches, scene_launches) + _d2s_table(dev, launches, scene_launches)
            + _k4_table(dev, train_launches, e2e_launches) + _f32_table(dev, *f32_launches)
            + _histeq_table(dev, launches, e2e_launches, scene_launches) + k10_rows)
    # K7 and K8 on the serving forward's own conv-site inputs, captured last
    # so that no other phase's peak memory holds them.
    s2d_sites, std_sites = _capture_sites(*_serving_model(dev))
    f32_std_sites = _capture_sites(*_serving_model(dev, dtype=torch.float32))[1]
    rows += (_wconv_table(dev, s2d_sites, launches, scene_launches)
             + _conv_block_table(dev, std_sites, f32_std_sites, launches, scene_launches, f32_launches[0]))
    del std_sites, f32_std_sites
    torch.cuda.empty_cache()
    # The torch.distributed paths over NCCL (phase 13), then K9 and sharded
    # K2 on the captured sites (phase 12) with the sharded forward's counts.
    sharded_launches, f32_sites = _nccl_paths(dev)
    for row in rows:
        if row["name"].startswith("dec_conv1_halo f32"):
            row["launches"] = sharded_launches["f32"]["dec1_halo"]
    rows += _k9_table(dev, s2d_sites, sharded_launches, f32_sites)
    del f32_sites
    del s2d_sites
    torch.cuda.empty_cache()
    # Spatial-parallel training (phase 14): the steps' spatial path, then K4
    # on shards with that path's counts.
    spatial_launches = _spatial_train_path(dev)
    rows += _spatial_k4_table(dev, spatial_launches)
    # The model options the trainers take (phase 15), (f) in phase 14's group.
    option_launches, dense = _options_path(dev)
    option_launches["e2e dense spatial"] = spatial_launches["e2e dense"]
    _attach_launches(rows, option_launches)
    # Annotated training and the evaluations on its weights (phase 16).
    annotated_launches, annotated = _annotated_path(dev, dense)
    _attach_launches(rows, annotated_launches, "launches_annotated")
    # The CLIs and the profiling hooks (phase 17).
    _attach_launches(rows, _cli_path(dev), "launches_cli")
    # The data layer on files, without OpenCV (phase 18).
    _attach_launches(rows, _data_path(dev), "launches_data")

    print(f"[chip_smoke] forward_ms {fwd_ms:.4f} images_per_s {BATCH / fwd_ms * 1e3:.2f}")
    print(f"[chip_smoke] train_ms {train_ms:.4f} train_images_per_s {BATCH / train_ms * 1e3:.2f} "
          f"train_host_ms {train_host_ms:.4f} train_peak_gib {train_peak:.3f}")
    print(f"[chip_smoke] e2e_ms {e2e_ms:.4f} e2e_images_per_s {BATCH / e2e_ms * 1e3:.2f} "
          f"e2e_host_ms {e2e_host_ms:.4f} e2e_peak_gib {e2e_peak:.3f}")
    print(f"[chip_smoke] e2e_dense_ms {dense['ms']:.4f} e2e_dense_host_ms {dense['host_ms']:.4f} "
          f"e2e_dense_peak_gib {dense['peak']:.3f} stencil_cc_calls_per_step {dense['cc_calls']:.0f} "
          f"stencil_cc_ops_per_call {dense['cc_ops']}")
    print(f"[chip_smoke] e2e_annotated_ms {annotated['ms']:.4f} e2e_annotated_host_ms {annotated['host_ms']:.4f} "
          f"e2e_annotated_peak_gib {annotated['peak']:.3f}")
    print(f"[chip_smoke] scene_ms {scene_ms:.4f} scene_mpix_per_s {SCENE * SCENE / 1e6 / scene_ms * 1e3:.3f} "
          f"scene_host_ms {scene_host_ms:.4f} scene_peak_gib {scene_peak:.3f}")
    print(card_line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
