"""End-to-end training: each unit is one optimizer step of the configured
end-to-end trainer (``train/end_to_end.py::make_e2e_train_step`` on the
model of ``build_mingraph_unet`` and a ``TrainState`` of
``train/common.py::make_optimizer``: augmentation on the device from the
step's generator, MinGraph-UNet in train mode with dropout from the same
generator, CE and the graph terms at their configured weights, the
detection losses against the union box, backward, Adam with weight decay),
fed uint8 images and masks from pinned host memory.

The loop is the segmentation driver's (``drivers/train.py``): set-up builds
one train state from the configuration's ``pipeline`` block (its ``args``
must be what ``mingraph_unet_kwargs`` derives from it: the weights and the
model FLOPs are read from them), drives it through ``checked`` steps on
distinct batches and ``warmup`` more; the window continues the same state.
In the checked steps the driver also records the parameters before each
step, at which the reference computes that step's terms, and, where the
program makes them, the decisions the reference replays
(``reference/e2e.py``): the keep
mask of every dropout, the region labels (the argmax of the MinCut soft
assignments), the instance slots of L_shape, and the foreground probability
map that L_smooth reads and the CC thresholds. The slots must be, pixel for
pixel, what the reference's own instancing makes of that map
(``cc_instances``).

In the traced steps the program's ranges ``mgu.<name>``
(``utils/profiling.py::span``) are also opened as ``pb.mgu.<name>``, the
form the trace reader ties device operations to, for the metrics of the
graph branch and the connected components.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, Iterator, List

import torch

from port_bench import core, inputs, program
from port_bench.reference import e2e as ref_e2e
from port_bench.reference import train as ref_train
from port_bench.reference.numerics import Precision

_seg = core.driver_module("train")
# A decision is held to the reference where the reference's margin is clearer than this: hundreds of times the
# largest gap of the foreground map (PERF.md §6).
MARGIN = 0.025
PACKAGE = "mingraph_unet_tpu_torch"


@contextlib.contextmanager
def recording(model, into: List[dict]) -> Iterator[None]:
    """Within: each step of ``model`` appends to ``into`` its dropout keep
    masks in the order applied (``keeps``), its region labels (``labels``),
    its instance slots (``slots``, (B, H, W) int8, −1 for none) and its
    foreground map (``p_fg``), read where the program makes them."""
    from mingraph_unet_tpu_torch.models import layers, losses
    from mingraph_unet_tpu_torch.ops import cc

    dropout, top, tv = layers.dropout, cc.top_instances_dense, losses.total_variation_loss

    def step() -> dict:
        if not into or "p_fg" in into[-1]:
            into.append({"keeps": []})
        return into[-1]

    def rec_dropout(x, p, gen):
        y = dropout(x, p, gen)
        if gen is not None and p != 0.0:
            # Where x is 0 the output is 0 kept or not: y != 0 is the mask in effect.
            step()["keeps"].append((y != 0).detach())
        return y

    def rec_top(labels, max_objects, *args, **kwargs):
        masks, areas = top(labels, max_objects, *args, **kwargs)
        slot = masks.argmax(dim=1)  # the slots hold distinct components
        step()["slots"] = torch.where(masks.amax(dim=1) > 0, slot, -1).to(torch.int8)
        return masks, areas

    def rec_tv(x, *args, **kwargs):
        step()["p_fg"] = x[..., 0].detach().clone()
        return tv(x, *args, **kwargs)

    def rec_labels(_mod, _args, out):
        step()["labels"] = out[1].argmax(dim=-1).detach()

    hook = model.mincut.register_forward_hook(rec_labels)
    layers.dropout, cc.top_instances_dense, losses.total_variation_loss = rec_dropout, rec_top, rec_tv
    try:
        yield
    finally:
        hook.remove()
        layers.dropout, cc.top_instances_dense, losses.total_variation_loss = dropout, top, tv


@contextlib.contextmanager
def mirrored_spans() -> Iterator[None]:
    """Within, while a profiler records: each range ``mgu.<name>`` that the
    program opens also opens ``pb.mgu.<name>`` around it (the program's
    ``span`` swapped in the modules that bound it, and swapped back)."""
    from mingraph_unet_tpu_torch.utils import profiling

    orig = profiling.span

    @contextlib.contextmanager
    def span(name, args=None):
        with torch.profiler.record_function("pb." + profiling.SPAN_PREFIX + name), orig(name, args):
            yield

    swapped = [m for m in list(sys.modules.values())
               if getattr(m, "__name__", "").startswith(PACKAGE) and getattr(m, "span", None) is orig]
    for m in swapped:
        m.span = span
    try:
        yield
    finally:
        for m in swapped:
            m.span = orig


class Driver(_seg.Driver):
    kind = "train"

    def setup(self) -> None:
        from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer
        from mingraph_unet_tpu_torch.train.end_to_end import (build_mingraph_unet, make_e2e_train_step,
                                                              mingraph_unet_kwargs)

        t0 = time.perf_counter()
        program.set_backend_flags(self.config)
        cfg = program.pipeline_config(self.config)
        derived = {k: list(v) if isinstance(v, tuple) else v for k, v in mingraph_unet_kwargs(cfg).items()}
        if derived != self.config["args"]:
            raise ValueError("the configuration's args are not what mingraph_unet_kwargs derives from its pipeline")
        if program.DTYPES[self.config["precision"]] != (torch.bfloat16 if cfg.training.bf16 else torch.float32):
            raise ValueError("the configuration's precision and its training.bf16 disagree")
        model = build_mingraph_unet(cfg, self.dev)
        model.load_state_dict(program.make_weights(self.config, self.seed, self.dev), strict=True)
        opt, sched = make_optimizer(model.parameters(), cfg.training, _seg.STEPS_PER_EPOCH)
        self.state = TrainState(model, opt, sched)
        self.step = make_e2e_train_step(model, opt, cfg, augment=True, train_detection=True)
        self.gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        t1 = time.perf_counter()
        pin = (lambda t: t.pin_memory()) if self.dev.type == "cuda" else (lambda t: t)
        self.pool = []
        for s in range(self.traffic["pool"]):
            imgs, masks = inputs.tiles(self.seed, s, self.b, self.h, self.w)
            self.pool.append((pin(torch.from_numpy(imgs)), pin(torch.from_numpy(masks))))
        t2 = time.perf_counter()
        self.gen_states, self.starts, self.decisions, metrics = [], [], [], []
        with recording(model, self.decisions):
            for t in range(self.checked):
                self.gen_states.append(self.gen.get_state())
                self.starts.append({k: v.detach().clone() for k, v in model.state_dict().items()})
                metrics.append(self.run_step(t))
                if t == 0:
                    b1 = opt.param_groups[0]["betas"][0]
                    self.opt_grads = {n: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p)).detach() / (1 - b1)
                                      for n, p in model.named_parameters()}
        self.after = {k: v.detach().clone() for k, v in model.state_dict().items()}
        self.losses = [{k: float(m[k]) for k in ref_e2e.TERMS} for m in metrics]
        self.offset = self.checked
        for i in range(self.traffic["warmup"]):
            self.issue(i)
        self.offset += self.traffic["warmup"]
        self.wait(None)
        self.setup_phases = {"model": t1 - t0, "inputs": t2 - t1, "warmup": time.perf_counter() - t2}

    def issue(self, i: int):
        if torch.autograd.profiler._is_profiler_enabled:
            with mirrored_spans():
                return super().issue(i)
        return super().issue(i)

    # -- the comparison ---------------------------------------------------------

    def program_outputs(self) -> dict:
        return {"losses": self.losses, "p_fg": [d.get("p_fg") for d in self.decisions], "opt_grads": self.opt_grads,
                "params": self.after}

    def replayed(self, t: int):
        """Step t's decisions, None where they do not fit its batch."""
        d = self.decisions[t] if t < len(self.decisions) else {}
        fits = all(k in d for k in ("labels", "slots", "p_fg")) and d["p_fg"].shape[0] == self.b
        return d if fits else None

    def reference(self, prec: Precision, got=None) -> dict:
        pipe = self.config["pipeline"]
        tr = pipe["training"]
        p0 = program.make_weights(self.config, self.seed, self.dev)
        with prec.active():
            return ref_e2e.train_steps(
                p0, self.pool[: self.checked], self.gen_states, [self.replayed(t) for t in range(self.checked)],
                self.config["args"], pipe["preprocessing"], pipe["model"]["losses"],
                pipe["model"]["fusion_detection"]["max_instances"],
                {"learning_rate": tr["learning_rate"], "weight_decay": tr["weight_decay"]}, prec, self.dev,
                starts=self.starts)

    def compare(self, got: dict, want: dict) -> Dict[str, float]:
        p0 = program.make_weights(self.config, self.seed, self.dev)
        numbers = {}
        for k in ref_e2e.TERMS:
            if k == "l_smooth":
                continue
            numbers[k] = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for g, w in zip(got["losses"], want["losses"]))
        smooth = [ref_e2e.smooth_gap(g["l_smooth"], *tv) for g, tv in zip(got["losses"], want["tv"])]
        p_fg = [float((g.float() - w).abs().max()) if g is not None and g.shape == w.shape else float("inf")
                for g, w in zip(got["p_fg"], want["p_fg"])]
        numbers["l_smooth"], numbers["p_fg"] = max(smooth), max(p_fg)
        self.worst.update(l_smooth_steps=smooth, p_fg_steps=p_fg)
        trainable = sorted(want["grads"])
        numbers["grad1"], self.worst["grad1"] = ref_train.leaf_norm_gaps(got["opt_grads"], want["opt_grads"], trainable)
        gnorm = {k: float(want["grads"][k].double().norm()) for k in trainable}
        med = sorted(gnorm.values())[len(gnorm) // 2]
        moving = [k for k in trainable if gnorm[k] >= _seg.SMALL_GRAD * med]
        change = lambda p: {k: p[k].float() - p0[k] for k in p0}  # noqa: E731
        numbers["change3"], self.worst["change3"] = ref_train.leaf_norm_gaps(change(got["params"]),
                                                                            change(want["params"]), moving)
        stats = sorted(k for k in p0 if k not in want["grads"])
        numbers["bn_change3"], self.worst["bn_change3"] = ref_train.leaf_norm_gaps(change(got["params"]),
                                                                                  change(want["params"]), stats)
        decided = [self.replayed(t) for t in range(self.checked)]
        numbers["hard_labels"], numbers["cc_slots"], seen = ref_e2e.decision_gaps(
            [d and d["labels"] for d in decided], [d and d["slots"] for d in decided], want["soft"], want["p_fg"],
            MARGIN)
        self.worst.update(seen)
        numbers["cc_instances"] = ref_e2e.instance_gap(
            [d and d["slots"] for d in decided], [d and d["p_fg"] for d in decided],
            self.config["pipeline"]["model"]["fusion_detection"]["max_instances"])
        return {k: (v if v == v else float("inf")) for k, v in numbers.items()}


def make(config: dict, traffic: dict, seed: int, device) -> Driver:
    return Driver(config, traffic, seed, device)
