#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

1. Build the hand-written CUDA kernels from ``mingraph_unet_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) into
   ``mingraph_unet_tpu_torch/build/``.
2. Hold each kernel against its plain PyTorch version at the shapes the
   512² b8 serving path gives it, on seeded bf16 inputs. The plain version
   runs in f32 on the same (bf16) inputs; a conv kernel must agree within
   ``CONV_TOL`` of max |plain| (one bf16 rounding of its f32 sum is 2^-9
   relative) over its whole output and again over its border rows and
   columns, the pool bit for bit.
3. Run ``MinGraphUNet(dtype=bfloat16, detection_pre_pool=32)`` at 512² b8
   with seeded weights, perturbed BN running statistics and seeded
   non-constant images. The launch counters must read psel 4, dec-conv1 2
   and pool 2, and every output must be finite. At batch 1 the card's f32
   outputs (TF32 off) must agree with the same port and weights on the CPU
   within ``CPU_TOL`` of max |CPU|.
4. Time the forward (ms/step, images/s, and the host's time to issue a
   step) and each kernel at each shape with CUDA events, beside its plain
   version, its one-call PyTorch counterpart where there is one, and its
   bound on an H100 SXM (3.35 TB/s, 989 bf16 TFLOP/s dense).

It prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``. It also prints the
forward's device time by kernel (torch.profiler) and its busy share.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

BATCH, SIZE = 8, 512
CONV_TOL = 1e-2      # kernel (bf16 out) vs plain (f32) on bf16 inputs, of max |plain|
CPU_TOL = 1e-3       # card f32 vs CPU f32 at batch 1, of max |CPU|
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_SIMT_FLOPS = 67e12
FORWARD_ITERS, KERNEL_ITERS = 20, 20

PSCONV_SRC = "mingraph_unet_tpu/ops/pallas/psconv.py"
POOL_SRC = "mingraph_unet_tpu/ops/pallas/pool.py"


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
            kind="dec1", level=lvl, args=(x_skip, x_prev, k_skip, k_prev, t9),
            bytes=(x_skip.numel() + x_prev.numel() + x_skip.numel()) * 2
            + (k_skip.numel() + k_prev.numel()) * 2 + t9.numel() * 4,
            # Least work: the explicit ConvTranspose (Cp -> 4c per s2d pixel),
            # then the 3x3 conv over the 2c channels of [skip ‖ up]. The
            # kernel's folded form does 27 instead of 20 c² per pixel.
            ops=2 * b * hh * hh * cp * 4 * c + 2 * full_px * 9 * (2 * c) * c,
            rate=BF16_TENSOR_FLOPS,
        ))
        y = rnd(b, hh, hh, 4 * c).to(torch.bfloat16)
        cases.append(dict(
            kind="pool", level=lvl, args=(y,),
            bytes=y.numel() * 2 + y.numel() // 4 * 2,
            ops=3 * y.numel() // 4, rate=F32_SIMT_FLOPS,
        ))
    return cases


def _kernel_table(dev, launches):
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
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if case["kind"] == "pool":
            ok = torch.equal(got, ref.to(got.dtype))
            tol_txt = "bit-equal"
        else:
            ok = err <= CONV_TOL * scale
            tol_txt = f"<= {CONV_TOL} * max|plain| = {CONV_TOL * scale:.4g}"
            # The border rows and columns (where the padding and dec-conv1's
            # class table act) again, against their own scale.
            edge = lambda t: torch.cat([e.flatten() for e in (t[:, 0], t[:, -1], t[:, :, 0], t[:, :, -1])]).float()  # noqa: E731
            b_err = (edge(got) - edge(ref)).abs().max().item()
            b_scale = edge(ref).abs().max().item()
            b_ok = b_err <= CONV_TOL * b_scale
            print(f"[chip_smoke] {name} L{case['level']} border: max_abs_err {b_err:.6g}, tolerance "
                  f"{CONV_TOL} * max|plain border| = {CONV_TOL * b_scale:.4g}: {'ok' if b_ok else 'FAIL'}")
            ok = ok and b_ok
        shape = tuple(args[0].shape)
        print(f"[chip_smoke] {name} L{case['level']} {shape}: max_abs_err {err:.6g} "
              f"(rel {err / max(scale, 1e-30):.3g}), tolerance {tol_txt}: {'ok' if ok else 'FAIL'}")
        if not ok or not torch.isfinite(got.float()).all():
            _fail(f"{name} at L{case['level']} disagrees with its plain version")
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
        rows.append({
            "name": f"{name} L{case['level']}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[case["kind"]],
            "shape": list(shape),
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
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


def _main_path(dev):
    """Phase 3: the serving forward through the kernels, then batch-1 card
    vs CPU. Returns (model, images, launch counts)."""
    import torch

    from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
    from mingraph_unet_tpu_torch.ops.kernels import pool, psconv

    model = MinGraphUNet(dtype=torch.bfloat16, detection_pre_pool=32, device=dev, seed=0)
    _perturb_bn(model, seed=1)
    x = _images(BATCH, SIZE, seed=2).to(dev)

    wrappers = {"psel": psconv.psel_conv3x3, "dec1": psconv.dec_conv1_fused, "pool": pool.phase_max_pool_kernel}
    for w in wrappers.values():
        w.launches = 0
    out = model(x)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[chip_smoke] main path launches: {launches}")
    if launches != {"psel": 4, "dec1": 2, "pool": 2}:
        _fail(f"expected psel 4, dec1 2, pool 2 launches per forward, got {launches}")
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
    card = MinGraphUNet(dtype=torch.float32, detection_pre_pool=32, device=dev)
    cpu = MinGraphUNet(dtype=torch.float32, detection_pre_pool=32, device="cpu")
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
    print(f"[chip_smoke] batch-1 f32 card vs CPU ({time.perf_counter() - t0:.1f}s): "
          f"hard labels equal {labels_equal}, min top-2 margin {margin:.3g}")
    for k in ("logits", "pred_bboxes", "pred_confidence", "l_partition"):
        ref, got = o_cpu[k], o_card[k].cpu()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        ok = err <= CPU_TOL * max(scale, 1e-6)
        print(f"[chip_smoke]   {k}: max_abs_err {err:.3g}, tolerance {CPU_TOL} * max|cpu| = "
              f"{CPU_TOL * scale:.3g}: {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"card and CPU disagree on {k}")
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


def _profile(model, x, fwd_ms: float, steps: int = 5, top: int = 15) -> None:
    """Device time by kernel over ``steps`` forward steps with
    torch.profiler, and the busy share of the unprofiled step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model(x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    print(f"[chip_smoke] profile: {busy_ms:.3f} ms of kernel time per step, {launches:.0f} kernel launches "
          f"per step of {len(kernels)} distinct kernels; busy share of the {fwd_ms:.3f} ms step {busy_ms / fwd_ms:.3f}")
    for e in kernels[:top]:
        print(f"[chip_smoke]   {e.self_device_time_total / 1e3 / steps:8.3f} ms/step  "
              f"{e.count / steps:5.1f}/step  {e.key[:100]}")


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
        regs = [ln.split(":", 1)[-1].strip() for ln in log if "registers" in ln]
        spills = [ln.strip() for ln in log if "spill stores" in ln and " 0 bytes spill stores" not in ln]
        print(f"[chip_smoke]   {name}: {'; '.join(regs)}; spills: {'; '.join(spills) or 'none'}")

    model, x, launches = _main_path(dev)
    fwd_ms = _forward_time(model, x)
    _profile(model, x, fwd_ms)
    del model, x
    torch.cuda.empty_cache()
    rows = _kernel_table(dev, launches)

    print(f"[chip_smoke] forward_ms {fwd_ms:.4f} images_per_s {BATCH / fwd_ms * 1e3:.2f}")
    print(card_line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
