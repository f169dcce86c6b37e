#!/usr/bin/env python3
"""Time the port's kernels, and the paths that run them, of several
checkouts of this repository on one CUDA card, in turns, on the same seeded
inputs.

    python3 tools/kernel_ab.py [--cases K2,K6,K8,f32,f32fwd,paths] PARENT . . PARENT

Each checkout argument is the root of a checkout (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory, and
``.``). For each, in the order given, a fresh process imports that
checkout's port and builds its kernels, then runs the cases named by
``--cases`` (all of them by default), with this checkout's
``chip_smoke.py`` as the source of shapes, tolerances and timers:

- ``K2``: ``dec_conv1_fused`` at ``chip_smoke.py``'s K2 cases (the serving
  U-Net's two s2d levels, 512² b8 bf16), held against its plain version
  within ``CONV_TOL``, beside the same function by cuDNN
  (``conv_transpose2d``, ``cat``, ``conv2d``);
- ``K8``: ``fused_conv_block`` at the shapes of the serving U-Net's five
  standard-layout ConvBlocks (init 32, depth 4, 512² b8: enc block2, enc
  block3, bottleneck, dec block0, dec block1) on seeded bf16 x, He-scaled
  weights and BN-like scales, held against its plain version (f32 cuDNN,
  TF32 off) within ``CONV_TOL``;
- ``K6``: ``equalize_channel`` on the orchard luma at 512² b8 and a 1024²
  scene luma (``chip_smoke.py`` phase 7's inputs), held bit for bit
  against its plain version;
- ``K4shard``: K4 on one inner H-shard of four (``psconv_fwd_halo``,
  ``psconv_dgrad_halo``; ``chip_smoke.py`` phase 14's shards: L0 (8, 64,
  256, 128) and L1 (8, 32, 128, 256), bf16, with the neighbours' two rows),
  held bit for bit against K4 on the whole tensor; beside each, the same
  shard launched with no rows (every tile staged like an inner one, the
  padding zero: what the border tiles cost), the whole tensor's device time
  over 4 (what a quarter of the tiles costs in fixed work), the device µs
  with the kernel passed in bf16 (half the weight bytes), and the host µs
  a call (``chip_smoke._host_us``: ``time.perf_counter`` over
  ``HOST_CALLS`` calls without a sync), whole and split by stage (checks,
  weights, output, stream, the C call that encodes the maps and launches;
  where the kernel takes the raw kernel, also that call on an empty batch,
  which returns before any map or launch);
- ``psel``: K1 (``psel_conv3x3``), K4 on the whole tensor (forward and
  dgrad) and K9 on the inner shard at the same shapes, events, device µs,
  device operations and host µs a call;
- ``f32``: the f32 instantiations of K1, K4 (forward, dgrad) at the
  512² b8 and the configured 128² b16 shapes of both s2d levels, K9 and K4
  on the inner shard of 4 at 512² b8 (stitched shards held bit for bit
  against the whole launch), K2 at its bf16 shapes and its sharded entry
  on the inner shard of 4 (stitched shards bit-equal to the whole launch),
  each held against its plain version within ``F32_TOL`` (TF32 off),
  beside the full-resolution ``F.conv2d`` in f32 with TF32 off (and on, as
  context); ``f32fwd``; then the segmentation step as
  ``configs/*.yaml`` configure it (f32, 128², batch 16, Adam): ms/step,
  host issue ms, peak memory;
- ``f32fwd``: the f32 serving forward at 512² b8 (its device time and
  the part of it in the hand-written f32 conv kernels), with cuDNN's TF32
  on (PyTorch's default) and off;
- ``paths``: the three paths that launch K6 (the bf16 serving forward at
  512² b8, the 1024² large scene with its dense head and decode, and the
  bf16 end-to-end train step at 512² b8), built as ``chip_smoke.py``
  builds them.

It prints one JSON line a case: CUDA-event µs a call (wrapper included),
the device µs of the case's own kernels and of the whole call, and the
device operations a call (torch.profiler, through
``chip_smoke._device_ops``); for a path, its device time and the part of it
spent in K6 and K8. Naming the checkouts as parent, change, change, parent
compares two versions on one card. It prints the card's name and power
limit first and exits non-zero if any check or process fails.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K8_SITES = [("enc block2", (8, 128, 128, 64, 128)), ("enc block3", (8, 64, 64, 128, 256)),
            ("bottleneck", (8, 32, 32, 256, 512)), ("dec block0", (8, 64, 64, 512, 256)),
            ("dec block1", (8, 128, 128, 256, 128))]
PATH_ITERS = 5


def _device(cs, fn, own: tuple, iters: int):
    """(µs of the whole call, µs of the kernels whose name holds one of
    ``own``, device operations a call) on the card."""
    ops = cs._device_ops(fn, iters)
    return (sum(t * n for _, t, n in ops), sum(t * n for k, t, n in ops if any(o in k for o in own)),
            sum(n for _, _, n in ops))


def _row(cs, tree: str, kernel: str, fn, own: tuple, iters: int, device_iters: int, **fields) -> dict:
    call_us, own_us, ops = _device(cs, fn, own, device_iters)
    return {"tree": tree, "kernel": kernel, **fields, "us": cs._time_ms(fn, iters) * 1e3, "device_us": own_us,
            "call_device_us": call_us, "device_ops": ops}


def _k2(cs, tree, dev):
    from mingraph_unet_tpu_torch.ops.kernels import psconv

    for case in cs._kernel_cases(dev):
        if case["kind"] != "dec1":
            continue
        args = case["args"]
        tag = f"{tree} K2 L{case['level']}"
        ref = psconv.dec_conv1_fused_plain(args[0].float(), args[1].float(), *args[2:])
        err = cs._check_close(tag, psconv.dec_conv1_fused(*args), ref, cs.CONV_TOL)
        cudnn = cs._dec1_cudnn(args[0], args[1], *case["unfolded"])
        cs._check_close(f"{tag} cuDNN route", cs._s2d_of(cudnn().relu()), ref, cs.CONV_TOL)
        row = _row(cs, tree, "K2", lambda: psconv.dec_conv1_fused(*args), ("dec1_wgmma_kernel", "conv_bf16_kernel"),
                   cs.KERNEL_ITERS, 10, level=case["level"], shape=list(args[0].shape), max_abs_err=err)
        row["cudnn_us"] = cs._time_ms(cudnn, cs.KERNEL_ITERS) * 1e3
        row["cudnn_device_us"] = _device(cs, cudnn, (), 10)[0]
        yield row


def _k8(cs, tree, dev):
    import torch

    from mingraph_unet_tpu_torch.ops.kernels import conv_block

    torch.backends.cudnn.allow_tf32 = False
    for name, (b, h, w, cin, c) in K8_SITES:
        g = torch.Generator(device=dev).manual_seed(cin + c)
        x = torch.randn((b, h, w, cin), generator=g, device=dev).to(torch.bfloat16)
        w1 = torch.randn((3, 3, cin, c), generator=g, device=dev) * (2.0 / (9 * cin)) ** 0.5
        w2 = torch.randn((3, 3, c, c), generator=g, device=dev) * (2.0 / (9 * c)) ** 0.5
        s1, s2 = (torch.rand(c, generator=g, device=dev) + 0.5 for _ in range(2))
        b1, b2 = (torch.randn(c, generator=g, device=dev) * 0.1 for _ in range(2))
        args = (x, w1, s1, b1, w2, s2, b2)
        ref = conv_block.fused_conv_block_plain(x.float(), *args[1:])
        err = cs._check_close(f"{tree} K8 {name}", conv_block.fused_conv_block(*args), ref, cs.CONV_TOL)
        yield _row(cs, tree, "K8", lambda: conv_block.fused_conv_block(*args), ("conv_block_kernel",), 5, 5,
                   site=name, shape=[b, h, w, cin], cout=c, max_abs_err=err)
    torch.backends.cudnn.allow_tf32 = True


def _k6(cs, tree, dev):
    import torch

    from mingraph_unet_tpu_torch.ops.kernels import histeq

    g = torch.Generator(device=dev).manual_seed(11)
    lumas = {"orchard luma 512^2 b8": cs._luma_u8(cs._train_batch(cs.BATCH, cs.SIZE, seed=8, dev=dev)[0]),
             "scene luma 1024^2": cs._luma_u8(torch.randint(0, 256, (1, cs.SCENE, cs.SCENE, 3), generator=g,
                                                            device=dev).to(torch.uint8))}
    for name, y in lumas.items():
        if not torch.equal(histeq.equalize_channel(y), histeq.equalize_channel_plain(y)):
            cs._fail(f"{tree}: K6 differs from its plain version on the {name}")
        yield _row(cs, tree, "K6", lambda: histeq.equalize_channel(y), ("histeq",), cs.KERNEL_ITERS,
                   cs.KERNEL_ITERS, input=name, shape=list(y.shape))


def _paths(cs, tree, dev):
    import torch

    from mingraph_unet_tpu_torch.models.detection import decode_dense_detections
    from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
    from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer
    from mingraph_unet_tpu_torch.train.end_to_end import build_mingraph_unet, make_e2e_train_step
    from mingraph_unet_tpu_torch.train.infer import pipeline_forward_large

    def row(path, step):
        for _ in range(2):
            step()
        ops = cs._device_ops(step, PATH_ITERS)

        def part(name):
            return sum(t * n for k, t, n in ops if name in k)

        return {"tree": tree, "path": path, "ms": cs._time_ms(step, PATH_ITERS),
                "device_ms": sum(t * n for _, t, n in ops) / 1e3, "device_ops": sum(n for _, _, n in ops),
                "k6_device_us": part("histeq"), "k8_device_us": part("conv_block_kernel")}

    with torch.no_grad():
        model, x = cs._serving_model(dev)
        sink = torch.zeros((), device=dev)
        yield row("serving forward bf16 512^2 b8", lambda: sink.add_(model(x)["logits"].sum()))
        del model, x
        model = MinGraphUNet(dtype=torch.bfloat16, detection_pre_pool=32, use_dense_detection=True, device=dev,
                             seed=0)
        cs._perturb_bn(model, seed=1)
        scene = cs._images(1, cs.SCENE, seed=12).to(dev)

        def serve():
            out = pipeline_forward_large(model, scene, tile=cs.TILE, halo=cs.HALO)
            _, scores, valid = decode_dense_detections(out["dense_objectness_logits"], out["dense_boxes"],
                                                       (cs.SCENE, cs.SCENE), cell_size=model.patch_size, top_k=32,
                                                       score_threshold=0.5, iou_threshold=0.5)
            sink.add_(out["logits"].sum() + scores.sum() + valid.sum())

        yield row("large scene bf16 1024^2", serve)
        del model, scene
    torch.cuda.empty_cache()
    cfg = cs._train_cfg(cs.SIZE, bf16=True)
    model = build_mingraph_unet(cfg)
    opt, sched = make_optimizer(model.parameters(), cfg.training, steps_per_epoch=1000)
    state = TrainState(model, opt, sched)
    step = make_e2e_train_step(model, opt, cfg, augment=True, train_detection=True)
    imgs, masks = cs._train_batch(cs.BATCH, cs.SIZE, seed=9, dev=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    yield row("e2e train step bf16 512^2 b8", lambda: step(state, imgs, masks, gen))


def _psel_stages(x, top, bot, k, adjoint: bool):
    """The host stages of one launch of the psel entry, each a callable
    (the last launches the kernel), as the wrapper of this checkout runs
    them: checks, weights (the kernel takes the raw parameter, or the
    wrapper packs it), the output's allocation, the stream lookup, the C
    call."""
    import torch

    from mingraph_unet_tpu_torch.ops.kernels import build, psconv

    lib = build.library("psel_conv")
    b, hh, ww, z = x.shape
    c = z // 4
    y = torch.empty_like(x)
    stream = build.stream_ptr(x)
    if hasattr(psconv, "_psel_weights"):  # the kernel lays out the raw kernel itself
        # (before the f32 kernel took the adjoint flag, the weights took it too)
        wargs = (k, x, adjoint)[:len(inspect.signature(psconv._psel_weights).parameters)]
        w, w_f32 = psconv._psel_weights(*wargs)

        def c_call(batch=b):
            return lib.mgu_psel_conv3x3_halo(x.data_ptr(), top.data_ptr(), bot.data_ptr(), w.data_ptr(), None,
                                             y.data_ptr(), batch, hh, ww, c, c, 1, 0, int(w_f32), int(adjoint), stream)

        return {
            "checks": lambda: psconv._psel_check("psel", x, k, None, top, bot, adjoint),
            "weights": lambda: psconv._psel_weights(*wargs),
            "output": lambda: torch.empty_like(x),
            "stream": lambda: build.stream_ptr(x),
            "ctypes": lambda: c_call(0),  # the C call of an empty batch: argument passing, no map, no launch
            "c_call": c_call,
        }
    w = psconv._kernel_weights(psconv._adjoint(k) if adjoint else k, x.device, x.dtype)

    def checks():
        build.check_cuda_input("x_s2d", x, x.dtype)
        build.require(tuple(k.shape[:2]) == (3, 3) and k.dim() == 4, f"kernel {tuple(k.shape)}")
        psconv._check_rows("top", top, x)
        psconv._check_rows("bottom", bot, x)

    return {
        "checks": checks,
        "weights": (lambda: psconv._kernel_weights(psconv._adjoint(k), x.device, x.dtype)) if adjoint
        else (lambda: psconv._kernel_weights(k, x.device, x.dtype)),
        "output": lambda: torch.empty((b, hh, ww, z), dtype=x.dtype, device=x.device),
        "stream": lambda: build.stream_ptr(x),
        "c_call": lambda: lib.mgu_psel_conv3x3_halo(x.data_ptr(), top.data_ptr(), bot.data_ptr(), w.data_ptr(),
                                                    None, y.data_ptr(), b, hh, ww, c, c, 1, 0, stream),
    }


def _k4shard(cs, tree, dev):
    import torch

    from mingraph_unet_tpu_torch.ops.kernels import psconv

    g = torch.Generator(device=dev).manual_seed(17)
    for lvl, c in ((0, 32), (1, 64)):
        hh = cs.SIZE // 2 ** (lvl + 1)
        inp = {"fwd": torch.randn((cs.BATCH, hh, hh, 4 * c), generator=g, device=dev).to(torch.bfloat16),
               "dgrad": torch.randn((cs.BATCH, hh, hh, 4 * c), generator=g, device=dev).to(torch.bfloat16)}
        k = torch.randn((3, 3, c, c), generator=g, device=dev) * (1.0 / (9 * c)) ** 0.5
        for name, fn, whole_fn in (("fwd", psconv.psconv_fwd_halo, psconv.psconv_fwd),
                                   ("dgrad", psconv.psconv_dgrad_halo, psconv.psconv_dgrad)):
            x = inp[name]
            whole = whole_fn(x, k)
            views = cs._shard_views(x, cs._shard_cuts(hh)[0])
            got = torch.cat([fn(s, t, b, k) for s, t, b, _ in views], dim=1)
            torch.cuda.synchronize()
            if not torch.equal(got, whole):
                cs._fail(f"{tree}: psconv_{name}_halo L{lvl}: shards not bit-equal to K4 on the whole tensor")
            xs, top, bot, _ = views[1]
            call = lambda: fn(xs, top, bot, k)  # noqa: E731
            row = _row(cs, tree, f"K4 shard {name}", call, ("psel_wgmma_kernel",), cs.KERNEL_ITERS, 10,
                       level=lvl, shape=list(xs.shape))
            row["host_us"] = cs._host_us(call)
            row["host_split_us"] = {st: cs._host_us(f) for st, f in
                                    _psel_stages(xs, top, bot, k, name == "dgrad").items()}
            row["norows_device_us"] = _device(cs, lambda: fn(xs, None, None, k), ("psel_wgmma_kernel",), 10)[1]
            kb = k.to(torch.bfloat16)
            row["bf16_kernel_device_us"] = _device(cs, lambda: fn(xs, top, bot, kb), ("psel_wgmma_kernel",), 10)[1]
            row["whole_device_us_over_4"] = _device(cs, lambda: whole_fn(x, k), ("psel_wgmma_kernel",), 10)[1] / 4
            yield row


def _psel(cs, tree, dev):
    import torch

    from mingraph_unet_tpu_torch.ops.kernels import psconv

    g = torch.Generator(device=dev).manual_seed(1)
    for lvl, c in ((0, 32), (1, 64)):
        hh = cs.SIZE // 2 ** (lvl + 1)
        x = torch.randn((cs.BATCH, hh, hh, 4 * c), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((3, 3, c, c), generator=g, device=dev) * (1.0 / (9 * c)) ** 0.5
        bias = torch.randn((c,), generator=g, device=dev)
        xs, top, bot, _ = cs._shard_views(x, cs._shard_cuts(hh)[0])[1]
        for kernel, call in (("K1", lambda: psconv.psel_conv3x3(x, k, bias)),
                             ("K4 fwd", lambda: psconv.psconv_fwd(x, k)),
                             ("K4 dgrad", lambda: psconv.psconv_dgrad(x, k)),
                             ("K9 shard", lambda: psconv.psel_conv3x3_halo(xs, top, bot, k, bias))):
            row = _row(cs, tree, kernel, call, ("psel_wgmma_kernel",), cs.KERNEL_ITERS, 10, level=lvl)
            row["host_us"] = cs._host_us(call)
            yield row


F32_CELLS = (("512^2 b8", 8, 512), ("128^2 b16", 16, 128))  # the bf16 rows' shapes; configs/*.yaml's
F32_OWN = ("psel_split_kernel",)  # the f32 psel kernel (split wgmma)
STEP_ITERS = 20


def _f32(cs, tree, dev):
    """The f32 instantiations: K1, K4 forward and dgrad at both cells' L0
    and L1, K9 and K4 on the inner shard of 4 (512^2 b8), K2 at its two
    bf16 shapes, each held against its plain version (TF32 off), with the
    full-resolution ``F.conv2d`` in f32 (channels-last, TF32 off and, as
    context, on); then the configured f32 segmentation step."""
    import torch
    import torch.nn.functional as F

    from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
    from mingraph_unet_tpu_torch.ops.kernels import psconv

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(23)
    for cell, b, size in F32_CELLS:
        for lvl, c in ((0, 32), (1, 64)):
            hh = size // 2 ** (lvl + 1)
            x = torch.randn((b, hh, hh, 4 * c), generator=g, device=dev)
            k = torch.randn((3, 3, c, c), generator=g, device=dev) * (1.0 / (9 * c)) ** 0.5
            bias = torch.randn((c,), generator=g, device=dev)
            fields = dict(dtype="f32", cell=cell, level=lvl, shape=list(x.shape))
            cases = {"K1": (lambda: psconv.psel_conv3x3(x, k, bias), lambda: psconv.psel_conv3x3_plain(x, k, bias)),
                     "K4 fwd": (lambda: psconv.psconv_fwd(x, k), lambda: psconv.psconv_train_plain(x, k)),
                     "K4 dgrad": (lambda: psconv.psconv_dgrad(x, k), lambda: psconv.psconv_dgrad_plain(x, k))}
            if cell == F32_CELLS[0][0]:
                xs, top, bot, _ = cs._shard_views(x, cs._shard_cuts(hh)[0])[1]
                cases.update({
                    "K9 shard": (lambda: psconv.psel_conv3x3_halo(xs, top, bot, k, bias),
                                 lambda: psconv.psel_conv3x3_halo_plain(xs, top, bot, k, bias)),
                    "K4 shard fwd": (lambda: psconv.psconv_fwd_halo(xs, top, bot, k),
                                     lambda: psconv.psconv_halo_plain(xs, top, bot, k)),
                    "K4 shard dgrad": (lambda: psconv.psconv_dgrad_halo(xs, top, bot, k),
                                       lambda: psconv.psconv_halo_plain(xs, top, bot, k.flip(0, 1).transpose(2, 3)))})
                for name, shard, whole in (("K9", psconv.psel_conv3x3_halo, psconv.psel_conv3x3),
                                           ("K4 fwd", psconv.psconv_fwd_halo, psconv.psconv_fwd),
                                           ("K4 dgrad", psconv.psconv_dgrad_halo, psconv.psconv_dgrad)):
                    args = (k, bias) if name == "K9" else (k,)
                    for cuts in cs._shard_cuts(hh):
                        got = torch.cat([shard(s, t, u, *args) for s, t, u, _ in cs._shard_views(x, cuts)], dim=1)
                        if not torch.equal(got, whole(x, *args)):
                            cs._fail(f"{tree}: f32 {name} L{lvl} shards {cuts} not bit-equal to the whole launch")
            for kernel, (call, plain) in cases.items():
                err = cs._check_close(f"{tree} {kernel} f32 {cell} L{lvl}", call(), plain(), cs.F32_TOL)
                row = _row(cs, tree, kernel, call, F32_OWN, cs.KERNEL_ITERS, 10, max_abs_err=err, **fields)
                if kernel.startswith("K4 shard") or kernel == "K9 shard":
                    row["shape"] = list(xs.shape)
                row["host_us"] = cs._host_us(call)
                row["plain_us"] = cs._time_ms(plain, cs.KERNEL_ITERS) * 1e3
                yield row
            # The full-resolution conv of the same function, channels-last.
            xf = s2d_ops.depth_to_space(x).permute(0, 3, 1, 2)
            wf = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            lib = lambda: F.conv2d(xf, wf, padding=1)  # noqa: E731
            cs._check_close(f"{tree} library f32 {cell} L{lvl}", s2d_ops.space_to_depth(lib().permute(0, 2, 3, 1)),
                            psconv.psconv_train_plain(x, k), cs.F32_TOL)
            for tf32 in (False, True):
                torch.backends.cudnn.allow_tf32 = tf32
                yield _row(cs, tree, f"library F.conv2d full-res{' TF32' if tf32 else ''}", lib, ("",),
                           cs.KERNEL_ITERS, 10, **fields)
            torch.backends.cudnn.allow_tf32 = False
    for case in cs._kernel_cases(dev):
        if case["kind"] != "dec1":
            continue
        args = [a.float() for a in case["args"]]
        call = lambda: psconv.dec_conv1_fused(*args)  # noqa: E731
        err = cs._check_close(f"{tree} K2 f32 L{case['level']}", call(), psconv.dec_conv1_fused_plain(*args),
                              cs.F32_TOL)
        row = _row(cs, tree, "K2", call, F32_OWN + ("dec1",), cs.KERNEL_ITERS, 10, dtype="f32", cell="512^2 b8",
                   level=case["level"], shape=list(args[0].shape), max_abs_err=err)
        row["plain_us"] = cs._time_ms(lambda: psconv.dec_conv1_fused_plain(*args), cs.KERNEL_ITERS) * 1e3
        cudnn = cs._dec1_cudnn(args[0], args[1], *case["unfolded"])
        row["cudnn_route_us"] = cs._time_ms(cudnn, cs.KERNEL_ITERS) * 1e3
        row["cudnn_route_device_us"] = _device(cs, cudnn, (), 10)[0]
        yield row
        # K2's sharded entry on the inner shard of 4, stitched shards held bit
        # for bit against the whole launch.
        hh, whole = args[0].shape[1], call()
        views = lambda cuts: zip(cs._shard_views(args[0], cuts), cs._shard_views(args[1], cuts))  # noqa: E731
        for cuts in cs._shard_cuts(hh):
            got = torch.cat([psconv.dec_conv1_halo(s, st, sb, p, pt, pb, *args[2:], row0, hh)
                             for (s, st, sb, row0), (p, pt, pb, _) in views(cuts)], dim=1)
            if not torch.equal(got, whole):
                cs._fail(f"{tree}: f32 K2 L{case['level']} shards {cuts} not bit-equal to the whole launch")
        (s, st, sb, row0), (p, pt, pb, _) = list(views(cs._shard_cuts(hh)[0]))[1]
        shard = lambda: psconv.dec_conv1_halo(s, st, sb, p, pt, pb, *args[2:], row0, hh)  # noqa: E731
        shard_plain = lambda: psconv.dec_conv1_halo_plain(s, st, sb, p, pt, pb, *args[2:], row0, hh)  # noqa: E731
        err = cs._check_close(f"{tree} K2 shard f32 L{case['level']}", shard(), shard_plain(), cs.F32_TOL)
        row = _row(cs, tree, "K2 shard", shard, F32_OWN + ("dec1",), cs.KERNEL_ITERS, 10, dtype="f32",
                   cell="512^2 b8", level=case["level"], shape=list(s.shape), max_abs_err=err)
        row["host_us"] = cs._host_us(shard)
        yield row
    torch.backends.cudnn.allow_tf32 = True
    yield from _f32_forward(cs, tree, dev)
    yield _f32_step(cs, tree, dev)


def _f32_forward(cs, tree, dev):
    """The f32 serving forward at 512² b8 with cuDNN's TF32 as PyTorch's
    default (on) and off: CUDA-event µs, device µs of the whole forward and
    of its hand-written f32 conv kernels (psel, K2, K8)."""
    import torch

    with torch.no_grad():
        model, x = cs._serving_model(dev, dtype=torch.float32)
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            yield _row(cs, tree, "f32 serving forward", lambda: model(x), F32_OWN + ("dec1", "conv_block_kernel"), 5,
                       3, dtype="f32", cell="512^2 b8", tf32=tf32)
    torch.backends.cudnn.allow_tf32 = True
    del model, x
    torch.cuda.empty_cache()


def _f32_step(cs, tree, dev):
    """The segmentation step as ``configs/*.yaml`` configure it (f32, 128²,
    batch 16, Adam), timed by ``chip_smoke._configured_step``: ms/step by
    CUDA events, host issue ms, peak memory, K4 launches a step."""
    run = cs._configured_step(dev, STEP_ITERS)
    if not all(math.isfinite(v) for v in run["losses"]):
        cs._fail(f"{tree}: the configured f32 step's loss is not finite")
    return {"tree": tree, "path": "segmentation step f32 128^2 b16 (configs/*.yaml)", "ms": run["ms"],
            "host_ms": run["host_ms"], "peak_gib": run["peak_gib"],
            "k4_launches_a_step": run["counts"]["k4_fwd"] + run["counts"]["k4_dgrad"]}


CASES = {"K2": _k2, "K6": _k6, "K8": _k8, "K4shard": _k4shard, "psel": _psel, "f32": _f32, "f32fwd": _f32_forward,
         "paths": _paths}


def one(tree: str, cases: list) -> int:
    """Run ``cases`` on the checkout at ``tree`` (this process imports it)."""
    import importlib.util

    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from mingraph_unet_tpu_torch.ops.kernels import build

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")  # this checkout's
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("[kernel_ab] no CUDA device", file=sys.stderr)
        return 2
    build.build_all()
    dev = torch.device("cuda", 0)
    for name in cases:
        with torch.no_grad() if name not in ("paths", "f32") else torch.enable_grad():
            for row in CASES[name](cs, tree, dev):
                print(json.dumps(row), flush=True)
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cases", default=",".join(CASES), help="comma-separated, of " + ", ".join(CASES))
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("trees", nargs="+")
    a = p.parse_args()
    cases = a.cases.split(",")
    unknown = [c for c in cases if c not in CASES]
    if unknown:
        p.error(f"unknown cases {unknown}")
    if a.one:
        return one(a.trees[0], cases)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or "nvidia-smi gave nothing", flush=True)
    for tree in a.trees:
        rc = subprocess.run([sys.executable, __file__, "--one", "--cases", a.cases, tree], timeout=1500).returncode
        if rc != 0:
            print(f"[kernel_ab] {tree}: exit code {rc}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
