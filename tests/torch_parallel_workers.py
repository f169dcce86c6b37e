"""Multi-process checks of the port's parallel layer (``parallel/*`` and the
trainers' data parallelism), run in ``gloo`` processes on the CPU.

This module imports torch, numpy and the port only, so the spawned
children never import JAX. :func:`run_checks` starts ``world`` processes
with ``torch.multiprocessing.start_processes(..., start_method="spawn")``;
each joins a ``gloo`` group on a free local port and runs the named checks
of :data:`CHECKS` in order, every rank the same ones, and the parent
collects each rank's results, in that order. A check returns plain data (numpy arrays,
numbers, strings); one that raises returns its traceback under "error".
The parent's ``join`` has a hard limit: past it the children are killed
and the run fails.

Also usable by hand, e.g. ``python tests/torch_parallel_workers.py``
runs the halo exchange on four ranks and prints what each received.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.parallel import data as t_data
from mingraph_unet_tpu_torch.parallel import halo as t_halo
from mingraph_unet_tpu_torch.parallel import mesh as t_mesh
from mingraph_unet_tpu_torch.parallel import spatial as t_spatial

Check = Tuple[str, Dict[str, Any]]


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, outdir: str, checks: Sequence[Check]) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    results: List[Any] = []
    try:
        for name, kwargs in checks:
            try:
                results.append(CHECKS[name](**kwargs))
            except Exception:
                results.append({"error": traceback.format_exc()})
    finally:
        torch.save(results, os.path.join(outdir, f"{rank}.pt"))
        dist.destroy_process_group()


def run_checks(checks: Sequence[Check], world: int, timeout: float) -> List[List[Any]]:
    """Run ``checks`` on ``world`` gloo ranks; returns each rank's results,
    in the order of ``checks``.
    Raises ``TimeoutError`` (after killing the children) past ``timeout``
    seconds."""
    outdir = tempfile.mkdtemp(prefix="mgu_gloo_")
    ctx = mp.start_processes(_entry, args=(world, free_port(), outdir, list(checks)), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} gloo processes did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(os.path.join(outdir, f"{r}.pt"), weights_only=False) for r in range(world)]


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# The checks. Each runs on every rank; arguments are numpy arrays and plain
# values made by the parent from seeds.
# ---------------------------------------------------------------------------


def mesh_layout() -> Dict[str, Any]:
    """The meshes a 4-rank world builds, and the one it cannot."""
    out = {}
    for key, args in (("data4", (4, 1)), ("data0_spatial2", (0, 2)), ("dcn2_spatial2", (1, 2, 2))):
        m = t_mesh.make_mesh(*args)
        out[key] = dict(shape=m.shape, coords=m.coords, batch_ranks=m.batch_ranks, spatial_ranks=m.spatial_ranks,
                        batch_index=m.batch_index)
    x = torch.arange(4 * 8).reshape(4, 8, 1, 1)
    out["dcn2_spatial2"]["shard"] = _np(t_mesh.shard_batch(x, t_mesh.make_mesh(1, 2, 2), spatial=True))
    for key, args in (("too_many", (4, 2)), ("too_few", (2, 1))):
        try:
            t_mesh.make_mesh(*args)
            out[key] = "no error"
        except ValueError as e:
            out[key] = str(e)
    return out


def halo_rows(x: np.ndarray) -> Dict[int, Tuple]:
    """What :func:`halo_exchange_rows` brings each shard of a (1, 4) mesh."""
    mesh = t_mesh.make_mesh(1, 4)
    local = t_mesh.shard_batch(torch.from_numpy(x), mesh, spatial=True)
    return {h: tuple(_np(r) for r in t_halo.halo_exchange_rows(local, h, mesh)) for h in (1, 2)}


def sharded_conv(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """:func:`sharded_conv2d_same` on a (1, world) mesh, gathered."""
    mesh = t_mesh.make_mesh(1, dist.get_world_size())
    y = t_halo.sharded_conv2d_same(t_mesh.shard_batch(torch.from_numpy(x), mesh, spatial=True),
                                   torch.from_numpy(k), mesh)
    return _np(t_spatial.gather_rows(y, mesh))


def sharded_psconv(cases: Sequence[Tuple]) -> List[np.ndarray]:
    """:func:`sharded_psconv` (the plain K9 per shard) on each case's mesh,
    gathered."""
    out = []
    for mesh_shape, xs, k, bias in cases:
        mesh = t_mesh.make_mesh(*mesh_shape)
        local = t_mesh.shard_batch(torch.from_numpy(xs), mesh, spatial=True)
        y = t_halo.sharded_psconv(local, torch.from_numpy(k), torch.from_numpy(bias), mesh)
        out.append(_np(t_spatial.gather_rows(y, mesh)))
    return out


def spatial_apply(unet_state: Dict[str, np.ndarray], unet_args: Dict[str, Any], scene: np.ndarray,
                  conv_scene: np.ndarray, conv_k: np.ndarray) -> Dict[str, Any]:
    """``spatial_sharded_apply`` of the U-Net's eval forward (logits and
    the s2d levels' features) and of a 'SAME' conv, on a (1, 4) mesh."""
    from mingraph_unet_tpu_torch.models.unet import UNet

    mesh = t_mesh.make_mesh(1, 4)
    model = UNet(torch.Generator(), **unet_args)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in unet_state.items()})
    model.eval()
    with torch.no_grad():
        out = t_spatial.spatial_sharded_apply(lambda x, spatial: model(x, spatial=spatial), torch.from_numpy(scene),
                                              mesh)
    k = torch.from_numpy(conv_k)
    conv = t_spatial.spatial_sharded_apply(lambda x, spatial: t_halo.sharded_conv2d_same(x, k, spatial.mesh),
                                           torch.from_numpy(conv_scene), mesh)
    return {"logits": _np(t_spatial.gather_rows(out["logits"], mesh)),
            "f_u_s2d0": _np(t_spatial.gather_rows(out["f_u_s2d"][0], mesh)),
            "conv": _np(t_spatial.gather_rows(conv, mesh))}


def halo_transpose(x: np.ndarray, cot: np.ndarray, halo: int) -> Dict[str, Any]:
    """:func:`halo_rows` on a (1, world) mesh under autograd: this shard
    extended by its halo rows (JAX's ``halo_exchange_rows`` block), the
    gradient of ⟨block, cot's block⟩ in the shard, and both sides of the
    transpose identity ⟨A x, c⟩ = ⟨x, Aᵀ c⟩ as this rank's terms."""
    n = dist.get_world_size()
    mesh = t_mesh.make_mesh(1, n)
    xl = t_mesh.shard_batch(torch.from_numpy(x), mesh, spatial=True).clone().requires_grad_()
    top, bottom = t_halo.halo_rows(xl, halo, mesh)
    block = torch.cat([top, xl, bottom], dim=1)
    rows = block.shape[1]
    c = torch.from_numpy(cot[:, mesh.spatial_index * rows : (mesh.spatial_index + 1) * rows])
    (dx,) = torch.autograd.grad(block, xl, c)
    return {"block": _np(block), "dx": _np(dx), "fwd": float((block * c).sum()), "bwd": float((xl * dx).sum())}


def sharded_conv_grad(x: np.ndarray, k: np.ndarray, bias: np.ndarray, cot: np.ndarray) -> Dict[str, np.ndarray]:
    """:func:`sharded_conv2d_same` (+ bias) on a (1, world) mesh under
    autograd for the cotangent ``cot``: this rank's output rows and the
    gradients of x's shard, the kernel and the bias (this rank's share)."""
    mesh = t_mesh.make_mesh(1, dist.get_world_size())
    rows = lambda a: t_mesh.shard_batch(torch.from_numpy(a), mesh, spatial=True)  # noqa: E731
    xl = rows(x).clone().requires_grad_()
    kk, bb = torch.from_numpy(k).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    y = t_halo.sharded_conv2d_same(xl, kk, mesh, bb)
    (y * rows(cot)).sum().backward()
    return {"y": _np(y), "dx": _np(xl.grad), "dk": _np(kk.grad), "db": _np(bb.grad)}


def psconv_halo_train(x: np.ndarray, k: np.ndarray, cot: np.ndarray) -> Dict[str, Dict[str, np.ndarray]]:
    """K4 on a shard of a (1, world) mesh under autograd for ``cot``:
    ``psconv_train_halo`` (the exchanged x rows, and the cotangent's rows in
    its backward; its plain forward and dgrad on the CPU) and the plain form
    over a differentiable exchange (``psconv_halo_plain`` of ``halo_rows``).
    Each: this rank's output rows, dx of its shard and its dK share."""
    from mingraph_unet_tpu_torch.ops.kernels import psconv as t_psconv

    mesh = t_mesh.make_mesh(1, dist.get_world_size())
    rows = lambda a: t_mesh.shard_batch(torch.from_numpy(a), mesh, spatial=True)  # noqa: E731
    out = {}
    for form in ("function", "plain"):
        xl = rows(x).clone().requires_grad_()
        kk = torch.from_numpy(k).requires_grad_()
        if form == "function":
            def exchange(t):
                return t_halo.halo_exchange_rows(t, 1, mesh)

            y = t_psconv.psconv_train_halo(xl, *exchange(xl), kk, exchange)
        else:
            y = t_psconv.psconv_halo_plain(xl, *t_halo.halo_rows(xl, 1, mesh), kk)
        (y * rows(cot)).sum().backward()
        out[form] = {"y": _np(y), "dx": _np(xl.grad), "dk": _np(kk.grad)}
    return out


def sharded_unet_train(unet_state: Dict[str, np.ndarray], unet_args: Dict[str, Any], x: np.ndarray,
                       cot: np.ndarray, dp: int, sp: int) -> Dict[str, Any]:
    """The train-mode U-Net on a (data ``dp``, spatial ``sp``) mesh through
    ``spatial_sharded_unet`` (this rank's batch rows, H-sharded over its
    spatial group, BN over batch × spatial) for the loss ⟨logits, cot⟩:
    the gathered logits of its batch rows, the input gradient of its batch
    rows (nonzero in its H rows only), every parameter gradient summed over
    the mesh, and the BN running statistics."""
    from mingraph_unet_tpu_torch.models.unet import UNet

    mesh = t_mesh.make_mesh(dp, sp)
    model = UNet(torch.Generator(), **unet_args, dtype=torch.float64).double()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in unet_state.items()})
    model.train()
    xb = t_mesh.shard_batch(torch.from_numpy(x), mesh).clone().requires_grad_()
    with t_data.data_parallel(mesh, xb.shape[0]):
        logits = t_spatial.spatial_sharded_unet(model, xb, mesh)["logits"]
        share = t_data.spatial_share((logits * t_mesh.shard_batch(torch.from_numpy(cot), mesh)).sum())
    share.backward()
    t_data.all_reduce_gradients(model.parameters(), mesh)
    out = {"logits": _np(logits), "dx": _np(xb.grad)}
    out.update({f"grad:{n}": _np(p.grad) for n, p in model.named_parameters()})
    out.update({f"stat:{n}": _np(b) for n, b in model.named_buffers()})
    return out


def all_reduce_grad() -> Dict[str, float]:
    """Rank r holds x_r and the loss ℓ_r = (r + 1)·Σx: the global loss is
    Σ_r ℓ_r, so each x_r's gradient is Σ_r (r + 1)."""
    r = dist.get_rank()
    mesh = t_mesh.make_mesh(dist.get_world_size(), 1)
    x = torch.tensor([float(r + 1)], requires_grad=True)
    y = t_data.all_reduce_sum(x * 1.0, mesh.batch_group)
    ((r + 1) * y).sum().backward()
    return {"y": float(y), "grad": float(x.grad)}


def seg_cfg(size: int, init: int, batch: int, optimizer: str = "sgd", remat: bool = False) -> PipelineConfig:
    """The small segmentation config of the data-parallel step tests
    (``remat``: the rematerialized U-Net)."""
    cfg = PipelineConfig()
    cfg.preprocessing.resize_dim = (size, size)
    cfg.model.unet.init_features, cfg.model.unet.depth = init, 2
    cfg.model.unet.remat = remat
    cfg.training.optimizer, cfg.training.batch_size = optimizer, batch
    return cfg


def e2e_cfg(size: int = 32, optimizer: str = "sgd", balance: str = "uncertainty", dense: bool = False
            ) -> PipelineConfig:
    """The small end-to-end config of ``tests/test_torch_e2e.py`` (``dense``:
    with the dense detection head)."""
    cfg = PipelineConfig()
    cfg.preprocessing.resize_dim = (size, size)
    cfg.model.unet.init_features, cfg.model.unet.depth = 4, 2
    cfg.model.gat.hidden_dim, cfg.model.gat.output_dim, cfg.model.gat.num_heads = 8, 4, 2
    cfg.model.graph_construction.patch_size, cfg.model.graph_construction.unet_patch_feature_dim = 8, 4
    cfg.model.fusion_detection.use_dense_detection = dense
    cfg.training.optimizer, cfg.training.loss_balance = optimizer, balance
    return cfg


def build_model(kind: str, cfg: PipelineConfig, dtype: str, state: Dict[str, np.ndarray]):
    """The trainers' model (``"seg"``: the U-Net, ``"e2e"``: MinGraphUNet
    with its loss balancer) in train mode on the CPU, with ``state``. An
    f64 model has f64 parameters too (a reference free of f32 rounding)."""
    from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
    from mingraph_unet_tpu_torch.models.unet import UNet
    from mingraph_unet_tpu_torch.train import end_to_end, segmentation

    if dtype == "float32":
        model = (segmentation.build_unet(cfg, device="cpu") if kind == "seg"
                 else end_to_end.build_mingraph_unet(cfg, device="cpu"))
    elif kind == "seg":
        u = cfg.model.unet
        model = UNet(torch.Generator(), u.in_channels, u.out_channels, u.init_features, u.depth, torch.float64,
                     u.use_batchnorm, u.remat)
    else:
        model = MinGraphUNet(**end_to_end.mingraph_unet_kwargs(cfg), dtype=torch.float64, device="cpu")
        model.loss_balance = end_to_end.LossBalance()
    model = model.to(dtype=getattr(torch, dtype)).train()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def train_step(kind: str, state: Dict[str, np.ndarray], cfg_args: Dict[str, Any], imgs: np.ndarray,
               masks: np.ndarray, dtype: str, seed: int, dp: int = 0, dcn: int = 1, augment: bool = True,
               mesh: Any = "auto", sp: int = 1, instances: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """One train step (``kind`` "seg" or "e2e") on this rank's rows of the
    global batch (``mesh`` "auto": data ``dp`` × spatial ``sp`` × dcn
    ``dcn`` over the process group, the ranks of a spatial group on the
    same rows; None: the whole batch in one process), the e2e step with
    annotated ``instances`` where given. Returns the metrics and every
    parameter, gradient and BN statistic after it."""
    from mingraph_unet_tpu_torch.train import common, end_to_end, segmentation

    mesh = t_mesh.make_mesh(dp, sp, dcn) if mesh == "auto" else mesh
    cfg = seg_cfg(**cfg_args) if kind == "seg" else e2e_cfg(**cfg_args)
    model = t_mesh.replicate(build_model(kind, cfg, dtype, state), mesh) if mesh else build_model(kind, cfg, dtype,
                                                                                                  state)
    opt, sched = common.make_optimizer(model.parameters(), cfg.training, 1)
    step = (segmentation.make_train_step(cfg, augment=augment, mesh=mesh) if kind == "seg"
            else end_to_end.make_e2e_train_step(model, opt, cfg, augment=augment, mesh=mesh))
    rows = (lambda a: t_mesh.shard_batch(torch.from_numpy(a), mesh)) if mesh else torch.from_numpy
    extra = {} if instances is None else {"instances": rows(instances)}
    metrics = step(common.TrainState(model, opt, sched), rows(imgs), rows(masks), torch.Generator().manual_seed(seed),
                   **extra)
    out = {"metrics": {k: float(v) for k, v in metrics.items()}}
    out.update({f"param:{n}": _np(p) for n, p in model.named_parameters()})
    out.update({f"grad:{n}": _np(p.grad) for n, p in model.named_parameters()})
    out.update({f"stat:{n}": _np(b) for n, b in model.named_buffers()})
    return out


def trainers(seg_dir: str, e2e_dir: str) -> Dict[str, Any]:
    """Both trainers' entry points for one epoch of two steps, here under
    the caller's process group (the mesh their ``training.yaml`` sets)."""
    from mingraph_unet_tpu_torch.train.end_to_end import train_end_to_end
    from mingraph_unet_tpu_torch.train.segmentation import train_unet_segmentation

    seg, _ = train_unet_segmentation(seg_dir, max_epochs=1, max_steps_per_epoch=2, device="cpu")
    e2e, _ = train_end_to_end(e2e_dir, max_epochs=1, max_steps_per_epoch=2, device="cpu")
    return {"seg": {k: _np(v) for k, v in seg.model.state_dict().items()},
            "e2e": {k: _np(v) for k, v in e2e.model.state_dict().items()}}


CHECKS = {f.__name__: f for f in (mesh_layout, halo_rows, sharded_conv, sharded_psconv, spatial_apply,
                                   halo_transpose, sharded_conv_grad, psconv_halo_train, sharded_unet_train,
                                   all_reduce_grad, train_step, trainers)}


if __name__ == "__main__":
    x = np.arange(1 * 8 * 2 * 1, dtype=np.float32).reshape(1, 8, 2, 1)
    for rank, res in enumerate(run_checks([("halo_rows", {"x": x})], world=4, timeout=120)):
        top, bottom = res[0][1]
        print(rank, None if top is None else top.ravel(), None if bottom is None else bottom.ravel())
