"""Segmentation training: each unit is one optimizer step of the configured
trainer (``train/segmentation.py::make_train_step``: augmentation on the
device from the step's generator, the U-Net in train mode, CE + Dice,
backward, Adam with weight decay), fed uint8 images and masks from pinned
host memory.

Set-up builds one train state and drives it through ``checked`` steps on
distinct batches, recording what the comparison needs (the generator's
state before each step, each step's losses, Adam's first moments after
step 1, every leaf after the last checked step), then ``warmup`` more
steps; the window continues the same state. The traffic file gives
``batch``, ``height``, ``width``, ``pool`` (distinct batches drawn from the
seed, served in turn), ``checked`` and ``warmup``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from port_bench import core, inputs, program
from port_bench.reference import train as ref_train
from port_bench.reference.numerics import Precision

STEPS_PER_EPOCH = 1_000_000  # the StepLR period: the rate stays the configured one
SMALL_GRAD = 1e-3  # a leaf whose reference gradient is below this share of the median leaf's moves by round-off


class Driver:
    kind = "train"
    sync_each = False

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        self.b, self.h, self.w = traffic["batch"], traffic["height"], traffic["width"]
        self.pixels_per_unit = self.b * self.h * self.w
        self.images_per_unit = self.b
        # Forward, and the backward's two products (data and kernel gradients) of every conv.
        self.flops_per_unit = 3 * core.forward_flops(config, self.h, self.w) * self.b
        self.precision = config["precision"]
        self.checked = traffic["checked"]
        self.worst: Dict[str, str] = {}  # the leaf behind each worst-leaf number of the last comparison

    def setup(self) -> None:
        from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer
        from mingraph_unet_tpu_torch.train.segmentation import make_train_step

        t0 = time.perf_counter()
        program.set_backend_flags(self.config)
        cfg = program.pipeline_config(self.config)
        model = program.build(self.config, program.make_weights(self.config, self.seed, self.dev), self.dev,
                              train=True)
        opt, sched = make_optimizer(model.parameters(), cfg.training, STEPS_PER_EPOCH)
        self.state = TrainState(model, opt, sched)
        self.step = make_train_step(cfg, augment=True)
        self.gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        t1 = time.perf_counter()
        pin = (lambda t: t.pin_memory()) if self.dev.type == "cuda" else (lambda t: t)
        self.pool = []
        for s in range(self.traffic["pool"]):
            imgs, masks = inputs.tiles(self.seed, s, self.b, self.h, self.w)
            self.pool.append((pin(torch.from_numpy(imgs)), pin(torch.from_numpy(masks))))
        t2 = time.perf_counter()
        self.gen_states, metrics = [], []
        for t in range(self.checked):
            self.gen_states.append(self.gen.get_state())
            metrics.append(self.run_step(t))
            if t == 0:
                b1 = opt.param_groups[0]["betas"][0]
                self.opt_grads = {n: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p)).detach() / (1 - b1)
                                  for n, p in model.named_parameters()}
        self.after = {k: v.detach().clone() for k, v in model.state_dict().items()}
        self.losses = [tuple(float(m[k]) for k in ("loss", "ce", "dice")) for m in metrics]
        self.offset = self.checked
        for i in range(self.traffic["warmup"]):
            self.issue(i)
        self.offset += self.traffic["warmup"]
        self.wait(None)
        self.setup_phases = {"model": t1 - t0, "inputs": t2 - t1, "warmup": time.perf_counter() - t2}

    def run_step(self, t: int):
        imgs, masks = self.pool[t % len(self.pool)]
        return self.step(self.state, imgs, masks, self.gen)

    def issue(self, i: int):
        return self.run_step(self.offset + i)

    def wait(self, handle) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def end_window(self, n: int) -> None:
        self.offset += n

    def layer_modules(self) -> Dict[str, List[torch.nn.Module]]:
        return {"forward": [self.state.model]}

    def free(self) -> None:
        self.state = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the comparison ---------------------------------------------------------

    def program_outputs(self) -> dict:
        return {"losses": self.losses, "opt_grads": self.opt_grads, "params": self.after}

    def reference(self, prec: Precision, got=None) -> dict:
        pre = self.config["pipeline"]["preprocessing"]
        tr = self.config["pipeline"]["training"]
        u = self.config["pipeline"]["model"]["unet"]
        p0 = program.make_weights(self.config, self.seed, self.dev)
        with prec.active():
            out = ref_train.train_steps(p0, self.pool[: self.checked], self.gen_states, u["depth"], pre,
                                        {"learning_rate": tr["learning_rate"], "weight_decay": tr["weight_decay"]},
                                        self.config["pipeline"]["model"]["losses"]["dice_weight"], prec, self.dev)
        out["losses"] = [tuple(float(x) for x in step) for step in out["losses"]]
        return out

    def compare(self, got: dict, want: dict) -> Dict[str, float]:
        p0 = program.make_weights(self.config, self.seed, self.dev)
        numbers = {}
        for j, name in enumerate(("loss", "ce", "dice")):
            numbers[name] = max(abs(g[j] - w[j]) / max(abs(w[j]), 1e-30) for g, w in zip(got["losses"], want["losses"]))
        trainable = sorted(want["grads"])
        numbers["grad1"], self.worst["grad1"] = ref_train.leaf_norm_gaps(got["opt_grads"], want["opt_grads"], trainable)
        gnorm = {k: float(want["grads"][k].double().norm()) for k in trainable}
        med = sorted(gnorm.values())[len(gnorm) // 2]
        moving = [k for k in trainable if gnorm[k] >= SMALL_GRAD * med]
        change = lambda p: {k: p[k].float() - p0[k] for k in p0}  # noqa: E731
        numbers["change3"], self.worst["change3"] = ref_train.leaf_norm_gaps(change(got["params"]), change(want["params"]),
                                                                            moving)
        stats = sorted(k for k in p0 if k not in want["grads"])
        numbers["bn_change3"], self.worst["bn_change3"] = ref_train.leaf_norm_gaps(change(got["params"]),
                                                                                  change(want["params"]), stats)
        return {k: (v if v == v else float("inf")) for k, v in numbers.items()}


def make(config: dict, traffic: dict, seed: int, device) -> Driver:
    return Driver(config, traffic, seed, device)
