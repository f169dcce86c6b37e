"""The benchmark's end-to-end cell on the CPU at its tiny size: the port's
``make_e2e_train_step`` held to the plain reference
(``port_bench/reference/e2e.py``) term by term, with the first step's
gradient and the parameters after the checked steps; every number the
comparison returns has a limit; the planted faults and the control fail
it; the reference's instancing is the program's, and a CC that merges
components or a top-K that drops one fails the comparison; L_smooth's
conditioned gap is bounded by the foreground map's error;
the traced steps open the program's ranges in the trace reader's form, and
the cell's readers of them; the configuration's ``args`` are the trainer's
own and its model FLOPs count the detection head on the full map."""

import contextlib
import copy

import pytest
import torch

from port_bench import calibrate, core, run, trace
from port_bench.reference import e2e as ref_e2e
from port_bench.tests.tiny import tiny_root

CELL = "mgu_e2e_f32.e2e_b16"
SEED = 3_000_000_019  # over 32 bits, as the benchmark's seeds may be
TIGHT = 1e-4  # f32 against f32 on the CPU: far below every limit
CONFIG = core.read_json(core.ROOT / "port_bench" / "configs" / "mgu_e2e_f32.json")
LIMITS = core.read_json(core.ROOT / "port_bench" / "limits" / f"{CELL}.json")


@contextlib.contextmanager
def one_thread():
    """The tiny steps take a hundredth of the time on one thread of a
    shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return core.load_cell(CELL, tiny_root(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="module")
def sound(cell):
    with one_thread():
        return calibrate.reading(cell, SEED, "cpu")["numbers"]


@pytest.mark.parametrize("number", sorted(LIMITS))
def test_the_port_matches_the_reference(sound, number):
    assert sound[number] <= min(LIMITS[number], TIGHT), (number, sound[number])


def test_every_number_of_the_comparison_has_a_limit(cell, sound):
    assert set(sound) == set(cell.limits) == set(LIMITS)


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_a_planted_fault_fails_the_comparison(cell, fault):
    with one_thread():
        numbers = calibrate.reading(cell, SEED, "cpu", fault=fault)["numbers"]
    assert any(v > cell.limits[k] for k, v in numbers.items()), numbers


def _merged(label):
    """Every foreground pixel of an image takes the image's least label: its
    components merge into one."""
    def faulty(mask, *args, **kwargs):
        lab = label(mask, *args, **kwargs)
        least = torch.where(lab >= 0, lab, torch.iinfo(lab.dtype).max).amin(dim=(1, 2), keepdim=True)
        return torch.where(lab >= 0, least, lab)
    return faulty


def _dropped(top):
    """The largest instance of every image is dropped from its slot."""
    def faulty(labels, *args, **kwargs):
        masks, areas = top(labels, *args, **kwargs)
        masks, areas = masks.clone(), areas.clone()
        masks[:, 0], areas[:, 0] = 0.0, 0.0
        return masks, areas
    return faulty


@pytest.mark.parametrize("fault", ["merged", "dropped"])
def test_a_planted_cc_fault_fails_the_comparison(cell, fault, monkeypatch):
    """L_shape reads the program's slots on both sides, so only the check of
    the slots against the reference's own instancing can see a CC that
    merges components or a top-K that drops one."""
    from mingraph_unet_tpu_torch.ops import cc

    if fault == "merged":
        monkeypatch.setattr(cc, "label_components_stencil", _merged(cc.label_components_stencil))
    else:
        monkeypatch.setattr(cc, "top_instances_dense", _dropped(cc.top_instances_dense))
    with one_thread():
        numbers = calibrate.reading(cell, SEED, "cpu")["numbers"]
    assert numbers["cc_instances"] > cell.limits["cc_instances"], numbers
    assert numbers["l_shape"] <= cell.limits["l_shape"]  # the terms cannot see it


def test_the_control_fails_the_comparison(cell):
    with one_thread():
        numbers = calibrate.reading(cell, SEED, "cpu", control=cell.config["control"])["numbers"]
    assert any(v > cell.limits[k] for k, v in numbers.items()), numbers


# ---------------------------------------------------------------------------
# The reference's instancing
# ---------------------------------------------------------------------------


def _instancing_maps(kind: str) -> torch.Tensor:
    """Foreground maps (B, H, W): smooth random blobs; a grid of more
    components of at least 10 pixels than the top-K's candidates; thin random
    walks, some of whose roots' windows hold fewer than 10 pixels; a snake
    whose geodesic diameter is over the 128 sweeps."""
    gen = torch.Generator().manual_seed(5)
    if kind == "blobs":
        x = torch.rand((3, 1, 17, 13), generator=gen)
        return torch.nn.functional.interpolate(x, size=(64, 48), mode="bilinear", align_corners=False)[:, 0]
    p = torch.zeros((2, 96, 160))
    if kind == "grid":
        for y in range(0, 96, 6):
            for x in range(0, 160, 6):
                sy, sx = torch.randint(2, 6, (2,), generator=gen).tolist()
                p[:, y : y + sy, x : x + sx] = 0.9
        return p
    if kind == "walks":
        for i in range(2):
            for y in range(0, 96 - 23, 24):
                for x in range(0, 160 - 23, 24):
                    r, c = y + 12, x + 12
                    for _ in range(int(torch.randint(8, 30, (1,), generator=gen))):
                        p[i, r, c] = 1.0
                        dr, dc = ((0, 1), (0, -1), (1, 0), (-1, 0))[int(torch.randint(0, 4, (1,), generator=gen))]
                        r, c = min(max(r + dr, y + 1), y + 22), min(max(c + dc, x + 1), x + 22)
        return p
    p[:, ::2, :] = 1.0
    for r in range(1, 96, 2):
        p[:, r, 159 if (r // 2) % 2 == 0 else 0] = 1.0
    return p


@pytest.mark.parametrize("kind", ["blobs", "grid", "walks", "snake"])
@pytest.mark.parametrize("max_instances", [2, 16])
def test_the_reference_instancing_is_the_program_s(kind, max_instances):
    from mingraph_unet_tpu_torch.ops import cc

    p = _instancing_maps(kind)
    masks, _ = cc.top_instances_dense(cc.label_components_stencil((p > 0.5).to(torch.int32)), max_instances,
                                      min_area=ref_e2e.SHAPE_MIN_PIXELS)
    program = torch.where(masks.amax(dim=1) > 0, masks.argmax(dim=1), -1).to(torch.int8)
    assert int((program >= 0).sum()) > 0
    assert torch.equal(ref_e2e.instance_slots(p, max_instances), program)
    assert ref_e2e.instance_gap([program, program], [p, p], max_instances) == 0.0
    assert ref_e2e.instance_gap([program[:1]], [p], max_instances) == float("inf")


# ---------------------------------------------------------------------------
# L_smooth's conditioned gap
# ---------------------------------------------------------------------------


def _maps(kind: str, eps: float):
    """A foreground map (B, H, W) in f64 and a perturbation of at most eps."""
    gen = torch.Generator().manual_seed(11)
    if kind == "random":
        p = torch.rand((2, 24, 20), generator=gen, dtype=torch.float64) * 0.1 + 0.45
        return p, (torch.rand(p.shape, generator=gen, dtype=torch.float64) * 2 - 1) * eps
    # Equal |d| everywhere and a perturbation in phase with it: the bound is met.
    chk = (torch.arange(24)[:, None] + torch.arange(20)[None, :]) % 2 * 2.0 - 1.0
    chk = chk.to(torch.float64).expand(2, 24, 20)
    return 0.5 + 0.01 * chk, eps * chk


@pytest.mark.parametrize("kind", ["random", "checkerboard"])
def test_the_conditioned_smooth_gap_is_bounded_by_the_map_error(kind):
    from mingraph_unet_tpu_torch.models.losses import total_variation_loss

    eps = 1e-6
    p, dp = _maps(kind, eps)
    tv_h, tv_w = ref_e2e.tv_parts(p)
    tv = float(total_variation_loss((p + dp)[..., None]))
    gap = ref_e2e.smooth_gap(tv, float(tv_h), float(tv_w))
    assert gap <= float(dp.abs().max()) * (1 + 1e-3)
    if kind == "checkerboard":
        assert gap >= 0.99 * eps
    assert abs(tv - float(tv_h + tv_w)) / float(tv_h + tv_w) > gap  # the relative gap reads larger


# ---------------------------------------------------------------------------
# The traced steps and the readers of the program's ranges
# ---------------------------------------------------------------------------


def test_the_traced_steps_open_the_program_ranges_for_the_reader(cell):
    with one_thread():
        d = core.driver_module(cell.traffic["entry"]).make(cell.config, cell.traffic, SEED, "cpu")
        d.setup()
        ctx = run.traced_steps(d, torch, cell, run.Window(units=1, seconds=1.0))
    names = {h["name"] for h in ctx.trace.host}
    want = {"mgu.train.e2e.augment", "mgu.train.e2e.forward", "mgu.train.e2e.loss", "mgu.train.e2e.backward",
            "mgu.train.e2e.optimizer", "mgu.cc.stencil", "mgu.cc.top_instances", "mgu.graph.patch_gat",
            "mgu.detection"} | {f"mgu.loss.{t}" for t in ("seg", "feature", "partition", "shape", "smooth",
                                                           "detection")}
    assert want <= names
    assert {f"pb.{n}" for n in want} <= names
    from mingraph_unet_tpu_torch.ops import cc
    from mingraph_unet_tpu_torch.train import end_to_end
    from mingraph_unet_tpu_torch.utils import profiling

    assert cc.span is end_to_end.span is profiling.span  # swapped back


def _ctx(ops):
    t = trace.Trace((0.0, 100.0), [trace.DeviceOp(f"k{i}", float(i), 1.0, r) for i, r in enumerate(ops)])
    return run.LayerContext("train", 2, [], 1.0, 1.0, 1.0, t)


@pytest.mark.parametrize("metric,want", [("graph.device_ms.train", 3 / 1e3 / 2), ("cc.device_ms.train", 2 / 1e3 / 2),
                                         ("cc.launches.train", 2 / 2)])
def test_the_readers_of_the_program_ranges(metric, want):
    ops = [("pb.layer:forward", "pb.mgu.graph.patch_gat"), ("pb.mgu.detection",), ("pb.mgu.loss.seg",),
           ("pb.mgu.loss.shape", "pb.mgu.cc.stencil"), ("pb.mgu.loss.shape", "pb.mgu.cc.top_instances"),
           ("pb.layer:forward",), ()]
    read = core.metric_module(metric).read
    assert read(_ctx(ops)) == pytest.approx(want)
    # A program without the ranges (the loss terms' and the CC's): nothing.
    assert read(_ctx([r for r in ops if not any("loss" in x or "cc" in x for x in r)])) is None


# ---------------------------------------------------------------------------
# The configuration
# ---------------------------------------------------------------------------


def _derived_args():
    from mingraph_unet_tpu_torch.train.end_to_end import mingraph_unet_kwargs
    from port_bench import program

    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in mingraph_unet_kwargs(program.pipeline_config(CONFIG)).items()}


@pytest.mark.parametrize("key", sorted(CONFIG["args"]))
def test_the_args_are_what_the_trainer_derives_from_the_pipeline(key):
    derived = _derived_args()
    assert sorted(derived) == sorted(CONFIG["args"])
    assert derived[key] == CONFIG["args"][key]


def test_the_configured_trainer_options():
    from port_bench import program

    cfg = program.pipeline_config(CONFIG)
    assert (cfg.training.bf16, cfg.training.instancing, cfg.training.graph_warmup_epochs) == (False, "fast", 0)
    assert cfg.model.fusion_detection.detection_pre_pool is None and cfg.training.loss_balance == "none"
    assert CONFIG["precision"] == "float32" and CONFIG["reduced"] == []


def test_the_model_flops_count_the_head_on_the_full_map():
    assert core.forward_flops(CONFIG, 512, 512) == 123_795_079_424.0
    pooled = copy.deepcopy(CONFIG)
    pooled["args"]["detection_pre_pool"] = 32  # the serving path: the head on the 32 x 32 patch grid
    head = 2.0 * 9 * (96 * 48 + 48 * 24)  # conv1 96 -> 48 and conv2 48 -> 24, 3 x 3, a pixel
    assert core.forward_flops(CONFIG, 512, 512) - core.forward_flops(pooled, 512, 512) == head * (512**2 - 32**2)
