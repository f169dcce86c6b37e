"""Closed-loop serving with one client: a request is one batch of uint8
tiles in pinned host memory, uploaded, normalized (the port's
``ops/image.py::normalize``), run through the model's eval forward, and its
outputs copied back into pinned host memory; it ends when they are there.

The configuration picks the forward: ``MinGraphUNet`` returns the U-Net
logits, the patch GAT's embeddings, the soft segment assignments, the
region embeddings, the detection outputs and the segment labels; ``UNet``
returns the logits.

The traffic file gives ``batch``, ``height``, ``width``, ``pool`` (distinct
input batches, drawn from the seed and served in turn), ``warmup``
(requests before the window) and ``check``: ``sample`` request indices
drawn from the seed below ``within``, whose outputs are kept, besides the
window's last request, for the comparison with the reference once the
window has closed.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import core, inputs, program
from port_bench.reference import model as ref
from port_bench.reference.numerics import Precision

PIPELINE_KEYS = ("logits", "gat_feats", "soft_assignments", "region_embeddings", "pred_bboxes", "pred_confidence",
                 "hard_patch_labels")
REF_CHUNK = 8  # images a reference call, so that it fits beside nothing else
# A patch whose two best soft assignments differ by more than this in the
# reference must get the reference's segment. The soft assignments' limit
# stays under half of it, so a sound run never reads above 0 here.
CLEAR_MARGIN = 0.025


class Driver:
    kind = "serve"
    sync_each = True

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        self.b, self.h, self.w = traffic["batch"], traffic["height"], traffic["width"]
        self.pixels_per_unit = self.b * self.h * self.w
        self.images_per_unit = self.b
        self.flops_per_unit = core.forward_flops(config, self.h, self.w) * self.b
        self.precision = config["precision"]
        self.pipeline = config["model"] == "MinGraphUNet"
        self.keys = PIPELINE_KEYS if self.pipeline else ("logits",)
        self.mean, self.std = program.normalization(config)
        chk = traffic["check"]
        rng = np.random.default_rng([int(seed) % (1 << 63), 7919])
        self.sample = sorted(int(i) for i in rng.choice(chk["within"], size=chk["sample"], replace=False))
        self.kept: Dict[int, Dict[str, torch.Tensor]] = {}
        self.kept_bufs: Dict[int, Dict[str, torch.Tensor]] = {}  # pinned outputs of the sampled requests

    # -- the system under test ------------------------------------------------

    def _host(self, like: torch.Tensor) -> torch.Tensor:
        t = torch.empty(like.shape, dtype=like.dtype)
        return t.pin_memory() if self.dev.type == "cuda" else t

    def setup(self) -> None:
        from mingraph_unet_tpu_torch.ops.image import normalize

        self._normalize = normalize
        t0 = time.perf_counter()
        program.set_backend_flags(self.config)
        self.model = program.build(self.config, program.make_weights(self.config, self.seed, self.dev), self.dev,
                                   train=False)
        t1 = time.perf_counter()
        self.pool = []
        for s in range(self.traffic["pool"]):
            t = torch.from_numpy(inputs.tiles(self.seed, s, self.b, self.h, self.w)[0])
            self.pool.append(t.pin_memory() if self.dev.type == "cuda" else t)
        t2 = time.perf_counter()
        self.ring = None
        for i in range(self.traffic["warmup"]):
            self.wait(self.issue(i))
        self.kept_bufs = {i: {k: self._host(v) for k, v in self.ring.items()} for i in self.sample}
        self.setup_phases = {"model": t1 - t0, "inputs": t2 - t1, "warmup": time.perf_counter() - t2}

    def forward(self, x_host: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x_host.to(self.dev, non_blocking=True)
        with torch.no_grad():
            out = self.model(self._normalize(x.float() / 255.0, self.mean, self.std))
        return {k: out[k] for k in self.keys}

    def issue(self, i: int):
        out = self.forward(self.pool[i % len(self.pool)])
        if self.ring is None:
            self.ring = {k: self._host(v) for k, v in out.items()}
        bufs = self.kept_bufs.get(i, self.ring)
        for k, v in out.items():
            bufs[k].copy_(v, non_blocking=True)
        if self.dev.type != "cuda":
            return None
        done = torch.cuda.Event()
        done.record()
        return done

    def wait(self, handle) -> None:
        if handle is not None:
            handle.synchronize()

    def end_window(self, n: int) -> None:
        """Keep the sampled requests that the window finished and its last."""
        self.kept = {i: self.kept_bufs[i] for i in self.sample if i < n}
        if n and n - 1 not in self.kept:  # a sampled last request wrote its own buffers, not the ring
            self.kept[n - 1] = {k: v.clone() for k, v in self.ring.items()}

    def layer_modules(self) -> Dict[str, List[torch.nn.Module]]:
        if not self.pipeline:
            return {"unet": [self.model]}
        m = self.model
        return {"unet": [m.unet], "graph": [m.patch_gat, m.mincut, m.region_gat, m.detection_head]}

    def free(self) -> None:
        self.model = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the comparison ---------------------------------------------------------

    def reference(self, prec: Precision, got=None) -> Dict[int, Dict[str, torch.Tensor]]:
        """The reference's outputs for every kept request, on the host. With
        ``got`` (the outputs being judged) the reference pools the regions by
        their segment labels: the argmax of near-equal soft assignments is a
        discrete decision that rounding may flip, and a flipped patch moves a
        region's mean by far more than rounding does. The labels themselves
        are judged by ``hard_labels``."""
        weights = program.make_weights(self.config, self.seed, self.dev)
        out: Dict[int, Dict[str, torch.Tensor]] = {}
        with torch.no_grad(), prec.active():
            for i in self.kept:
                x = self.pool[i % len(self.pool)]
                parts = []
                for c in range(0, self.b, REF_CHUNK):
                    xc = x[c : c + REF_CHUNK].to(self.dev)
                    if self.pipeline:
                        labels = None if got is None or i not in got else got[i]["hard_patch_labels"][c : c + REF_CHUNK]
                        y = ref.pipeline(weights, xc, self.config["args"], self.mean, self.std, prec, labels)
                    else:
                        m = torch.tensor(self.mean, device=self.dev)
                        s = torch.tensor(self.std, device=self.dev)
                        u = self.config["pipeline"]["model"]["unet"]
                        y = ref.unet(weights, (xc.float() / 255.0 - m) / s, u["depth"], prec)
                    parts.append({k: y[k].cpu() if k == "hard_patch_labels" else y[k].float().cpu() for k in self.keys})
                out[i] = {k: torch.cat([p[k] for p in parts]) for k in self.keys}
        return out

    def compare(self, got: Dict[int, Dict[str, torch.Tensor]], want: Dict[int, Dict[str, torch.Tensor]]):
        """Per output: the widest gap over every kept request, over the largest
        magnitude the reference gives it; and ``hard_labels``, the patches
        whose segment differs from the reference's where the reference's
        two best soft assignments are more than :data:`CLEAR_MARGIN` apart.
        A missing request reads infinite."""
        numbers = {}
        if self.pipeline:
            wrong = 0
            for i, w in want.items():
                if i in got:
                    top2 = w["soft_assignments"].topk(2, dim=-1).values
                    clear = (top2[..., 0] - top2[..., 1]) > CLEAR_MARGIN
                    wrong += int((clear & (got[i]["hard_patch_labels"] != w["hard_patch_labels"])).sum())
            numbers["hard_labels"] = float(wrong)
        for k in self.keys:
            if k == "hard_patch_labels":
                continue
            gap, scale = 0.0, 0.0
            for i, w in want.items():
                g = got.get(i)
                if g is None:
                    gap = float("inf")
                    continue
                d = (g[k].float() - w[k]).abs().max().item()
                gap = max(gap, d if np.isfinite(d) else float("inf"))
                scale = max(scale, w[k].abs().max().item())
            numbers[k] = gap / scale if scale > 0 else gap
        if not want:
            numbers = {k: float("inf") for k in numbers}
        return numbers

    def program_outputs(self):
        return self.kept


def make(config: dict, traffic: dict, seed: int, device) -> Driver:
    return Driver(config, traffic, seed, device)
