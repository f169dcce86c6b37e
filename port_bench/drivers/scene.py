"""Closed-loop serving of large scenes with the dense fruit head, one
client: a request is one batch of uint8 RGB scenes in pinned host memory,
uploaded, normalized (``ops/image.py::normalize``), run through
``train/infer.py::pipeline_forward_large`` (the U-Net over overlapping
``tile + 2·halo`` windows, its outputs stitched in f32, the graph branch,
fusion and both heads once over the whole scene) and
``models/detection.py::decode_dense_detections`` (stable top-k, NMS, the
score threshold), its outputs copied back into pinned host memory; it ends
when they are there.

The loop, the pool of seeded batches, the warm-up and the kept requests
are ``drivers/serve.py``'s; the traffic file adds ``tile``, ``halo``,
``top_k``, ``score_threshold`` and ``iou_threshold`` (the decode's cell is
the configuration's ``patch_size``). The weights are drawn from
``reference/scene.py::scene_spec``, which holds the dense head; drawn
weights score a scene's cells alike and may leave every score under the
threshold, so the set-up then sets the dense head's objectness and
box-size biases from one forward (:meth:`Driver.serve_fruit`), and the
decode keeps fruit. In the
traced steps the program's ranges ``mgu.<name>`` are also opened as
``pb.mgu.<name>`` (``drivers/train_e2e.py::mirrored_spans``), the form the
trace reader ties device operations to, for the readers of the windows, the
stitch and the decode.

The comparison (``correct``), over the kept requests: the widest gap of
each compared output over the reference's largest magnitude;
``hard_labels`` as ``drivers/serve.py`` counts it; and ``decode_slots``,
the slots where the program's decode and the reference's, both of the
program's own dense outputs, disagree, counted where the reference's
decisions are clear (:data:`DECODE_MARGIN`); it reads infinite where the
reference keeps no clear fruit, since it would then judge nothing.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import core, inputs, program
from port_bench.reference import scene as ref_scene
from port_bench.reference.numerics import Precision
from port_bench.weights import draw_weights

_serve = core.driver_module("serve")
mirrored_spans = core.driver_module("train_e2e").mirrored_spans

GAP_KEYS = ("logits", "gat_feats", "soft_assignments", "region_embeddings", "pred_bboxes", "pred_confidence",
            "dense_objectness_logits", "dense_boxes")
DECODE_KEYS = ("det_boxes", "det_scores", "det_valid")
KEYS = GAP_KEYS + ("hard_patch_labels",) + DECODE_KEYS
# A decision of the decode is clear where the reference's score, and each IoU
# it is suppressed by or could be, lies more than this from its threshold:
# eight f32 units in the last place at 0.5 (6e-8 each). Both sides decode the
# same dense outputs in exactly rounded f32, apart from the f64 sigmoid,
# whose one rounding to f32 may differ by one such unit on another library.
DECODE_MARGIN = 5e-7
# A valid slot's box and score agree to f32 rounding: a few units in the last
# place of the scene's size (the boxes' pixel scale) and of 1 (the scores).
BOX_ULPS, SCORE_ULPS = 4, 4
# The median box's side, in cells, once :meth:`Driver.serve_fruit` has set
# the size biases: 48 px at the cell's 16, a mango in a 1024² scene cut
# from a drone orthomosaic. Boxes of three cells meet their neighbours' at
# an IoU about 0.5, so NMS both keeps and suppresses.
BOX_CELLS = 3


def scene_flops(config: dict, traffic: dict) -> float:
    """Model FLOPs of one scene from ``core``'s counts: the U-Net on every
    window as run, the rest of ``core.pipeline_forward_flops`` over the
    whole scene (the graph branch and the single-box head), and the dense
    head's convs."""
    a, h, w = config["args"], traffic["height"], traffic["width"]
    tile, halo = traffic["tile"], traffic["halo"]
    win = tile + 2 * halo

    def unet(hh: int, ww: int) -> float:
        return core.unet_forward_flops(hh, ww, a.get("in_channels", 3), a["num_classes"], a["init_features"],
                                       a["depth"])

    windows = unet(h, w) if h <= win or w <= win else len(ref_scene.window_starts(h, tile, halo)) * len(
        ref_scene.window_starts(w, tile, halo)) * unet(win, win)
    c, d = a["init_features"] + a["gat_output_dim"], ref_scene.DENSE_HIDDEN
    gh, gw = h // a["patch_size"], w // a["patch_size"]
    dense = (core.conv_flops(h, w, 3, c, d) + core.conv_flops(gh, gw, 3, d, d) + core.conv_flops(gh, gw, 1, d, 1)
             + core.conv_flops(gh, gw, 1, d, 4))
    return windows + core.pipeline_forward_flops(h, w, a) - unet(h, w) + dense


class Driver(_serve.Driver):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.keys = KEYS
        self.flops_per_unit = scene_flops(config, traffic) * self.b
        self.cell = config["args"]["patch_size"]
        self.fruit_biases: Dict[str, torch.Tensor] = {}  # set by serve_fruit
        self.live_slots = 0  # the clear valid slots of the reference's decode, set by compare

    def weights(self) -> Dict[str, torch.Tensor]:
        w = draw_weights(ref_scene.scene_spec(self.config["args"]), self.seed, self.dev)
        w.update(self.fruit_biases)
        return w

    def serve_fruit(self) -> None:
        """Set the dense head's objectness and box-size biases from the
        forward of the pool's first batch, so that the decode has fruit to
        keep and to suppress. The objectness bias moves the batch's
        ``1 − top_k / cells`` quantile of the logits to the score
        threshold's logit: as many cells as the top-k keeps score at or
        above the threshold, a scene on average. The size biases move the
        median box side to :data:`BOX_CELLS` cells. Both are rounded to the
        model's precision, and the reference takes the same values
        (:meth:`weights`)."""
        tf = self.traffic
        with torch.no_grad():
            out = Driver.forward(self, self.pool[0])  # the forward as built: a planted fault replaces self.forward
            obj, box = out["dense_objectness_logits"].float(), out["dense_boxes"].float()
            cells = obj[0].numel()
            q = torch.quantile(obj.flatten(), 1.0 - min(tf["top_k"], cells) / cells)
            t = tf["score_threshold"]
            side = torch.logit(box[..., 2:].clamp(1e-6, 1.0 - 1e-6)).flatten(0, -2).median(dim=0).values
            want = torch.tensor([BOX_CELLS * self.cell / self.w, BOX_CELLS * self.cell / self.h], device=self.dev)
            head = self.model.dense_detection_head
            box_bias = head.box_head.bias.detach().clone()
            box_bias[2:] += torch.logit(want) - side
            for name, value in (("obj_head", head.obj_head.bias.detach() + (math.log(t / (1.0 - t)) - q)),
                                ("box_head", box_bias)):
                value = value.to(program.DTYPES[self.precision]).float()
                getattr(head, name).bias.copy_(value)
                self.fruit_biases[f"dense_detection_head.{name}.bias"] = value

    def setup(self) -> None:
        from mingraph_unet_tpu_torch.models.detection import decode_dense_detections
        from mingraph_unet_tpu_torch.ops.image import normalize
        from mingraph_unet_tpu_torch.train.infer import pipeline_forward_large

        self._normalize, self._forward_large, self._decode = normalize, pipeline_forward_large, decode_dense_detections
        t0 = time.perf_counter()
        program.set_backend_flags(self.config)
        self.model = program.build(self.config, self.weights(), self.dev, train=False)
        t1 = time.perf_counter()
        self.pool = []
        for s in range(self.traffic["pool"]):
            t = torch.from_numpy(inputs.tiles(self.seed, s, self.b, self.h, self.w)[0])
            self.pool.append(t.pin_memory() if self.dev.type == "cuda" else t)
        t2 = time.perf_counter()
        self.serve_fruit()
        self.ring = None
        for i in range(self.traffic["warmup"]):
            self.wait(self.issue(i))
        self.kept_bufs = {i: {k: self._host(v) for k, v in self.ring.items()} for i in self.sample}
        self.setup_phases = {"model": t1 - t0, "inputs": t2 - t1, "warmup": time.perf_counter() - t2}

    def forward(self, x_host: torch.Tensor) -> Dict[str, torch.Tensor]:
        tf = self.traffic
        x = x_host.to(self.dev, non_blocking=True)
        scene = self._normalize(x.float() / 255.0, self.mean, self.std)
        out = self._forward_large(self.model, scene, tile=tf["tile"], halo=tf["halo"])
        det = self._decode(out["dense_objectness_logits"], out["dense_boxes"], (self.h, self.w), cell_size=self.cell,
                           top_k=tf["top_k"], score_threshold=tf["score_threshold"],
                           iou_threshold=tf["iou_threshold"])
        return {**{k: out[k] for k in GAP_KEYS + ("hard_patch_labels",)}, **dict(zip(DECODE_KEYS, det))}

    def issue(self, i: int):
        if torch.autograd.profiler._is_profiler_enabled:
            with mirrored_spans():
                return super().issue(i)
        return super().issue(i)

    def layer_modules(self) -> Dict[str, List[torch.nn.Module]]:
        m = self.model
        return {"unet": [m.unet],
                "graph": [m.patch_gat, m.mincut, m.region_gat, m.detection_head, m.dense_detection_head]}

    # -- the comparison ---------------------------------------------------------

    def reference(self, prec: Precision, got=None) -> Dict[int, Dict[str, torch.Tensor]]:
        """The reference's outputs for every kept request, on the host, one
        scene at a time. With ``got`` (the outputs being judged) the region
        pooling takes the program's patch labels and the decode the
        program's dense outputs (the module's docstring,
        ``reference/scene.py``); without, its own."""
        weights = self.weights()
        tf = self.traffic
        out: Dict[int, Dict[str, torch.Tensor]] = {}
        with torch.no_grad(), prec.active():
            for i in self.kept:
                x = self.pool[i % len(self.pool)]
                g = None if got is None else got.get(i)
                parts = []
                for c in range(self.b):
                    labels = None if g is None else g["hard_patch_labels"][c : c + 1]
                    y = ref_scene.scene_forward(weights, x[c : c + 1].to(self.dev), self.config["args"], self.mean,
                                                self.std, tf["tile"], tf["halo"], prec, labels)
                    parts.append({k: v.cpu() if k == "hard_patch_labels" else v.float().cpu() for k, v in y.items()})
                y = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
                src = y if g is None else g
                y.update(ref_scene.decode(src["dense_objectness_logits"].to(self.dev), src["dense_boxes"].to(self.dev),
                                          (self.h, self.w), self.cell, tf["top_k"], tf["score_threshold"],
                                          tf["iou_threshold"], DECODE_MARGIN))
                out[i] = {k: v.cpu() for k, v in y.items()}
        return out

    def compare(self, got: Dict[int, Dict[str, torch.Tensor]], want: Dict[int, Dict[str, torch.Tensor]]):
        """Each of :data:`GAP_KEYS`: the widest gap over every kept request,
        over the largest magnitude the reference gives it; ``hard_labels``:
        patches whose segment differs from the reference's where the
        reference's two best soft assignments are more than
        ``drivers/serve.py::CLEAR_MARGIN`` apart; ``decode_slots``: clear
        slots (:data:`DECODE_MARGIN`) whose valid flag differs, or whose
        valid box or score differs beyond f32 rounding; infinite where
        the reference's decode keeps no clear slot (:attr:`live_slots`
        counts them). A missing request reads infinite."""
        eps = float(torch.finfo(torch.float32).eps)
        numbers = {"hard_labels": 0.0, "decode_slots": 0.0}
        gap = {k: 0.0 for k in GAP_KEYS}
        scale = {k: 0.0 for k in GAP_KEYS}
        self.live_slots = 0
        for i, w in want.items():
            g = got.get(i)
            if g is None:
                numbers = {k: float("inf") for k in ("hard_labels", "decode_slots") + GAP_KEYS}
                return numbers
            top2 = w["soft_assignments"].topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > _serve.CLEAR_MARGIN
            numbers["hard_labels"] += float((clear & (g["hard_patch_labels"] != w["hard_patch_labels"])).sum())
            for k in GAP_KEYS:
                d = (g[k].float() - w[k]).abs().max().item()
                gap[k] = max(gap[k], d if np.isfinite(d) else float("inf"))
                scale[k] = max(scale[k], w[k].abs().max().item())
            both = g["det_valid"] & w["det_valid"]
            box_off = ((g["det_boxes"] - w["det_boxes"]).abs() > BOX_ULPS * eps * max(self.h, self.w)).any(-1)
            score_off = (g["det_scores"] - w["det_scores"]).abs() > SCORE_ULPS * eps
            wrong = (g["det_valid"] != w["det_valid"]) | (both & (box_off | score_off))
            numbers["decode_slots"] += float((wrong & w["decode_clear"]).sum())
            self.live_slots += int((w["det_valid"] & w["decode_clear"]).sum())
        if self.live_slots == 0:
            numbers["decode_slots"] = float("inf")
        for k in GAP_KEYS:
            numbers[k] = gap[k] / scale[k] if scale[k] > 0 else gap[k]
        if not want:
            numbers = {k: float("inf") for k in numbers}
        return numbers


def make(config: dict, traffic: dict, seed: int, device) -> Driver:
    return Driver(config, traffic, seed, device)
