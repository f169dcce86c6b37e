"""The benchmark's large-scene cell on the CPU at its tiny size: the port's
``pipeline_forward_large`` and ``decode_dense_detections`` held to the plain
reference (``port_bench/reference/scene.py``) output by output in f32, on a
scene whose border windows are clamped; the reference's decode is the
port's, bit for bit, on planted dense outputs; the cell's set-up serves
fruit that NMS both keeps and suppresses, with the reference on the same
biases; every number of the cell's comparison has a limit and the planted
faults fail it; the traced steps
open the program's scene, dense-head and decode ranges in the trace
reader's form, and the cell's readers of them; the model FLOPs of a
request; the configuration builds the port's model from the reference's
leaves."""

import ast
import contextlib

import pytest
import torch

from port_bench import calibrate, core, inputs, run, trace
from port_bench.reference import scene as ref_scene
from port_bench.reference.numerics import Precision
from port_bench.tests.tiny import tiny_file, tiny_root
from port_bench.weights import draw_weights

CELL = "mgu_dense_bf16.scene_1024"
SEED = 3_000_000_019  # over 32 bits, as the benchmark's seeds may be
TIGHT = 1e-4  # f32 against f32 on the CPU: far below every limit
BENCH_DIR = core.ROOT / "port_bench"
CONFIG = core.read_json(BENCH_DIR / "configs" / "mgu_dense_bf16.json")
TRAFFIC = core.read_json(BENCH_DIR / "traffic" / "scene_1024.json")
LIMITS = core.read_json(BENCH_DIR / "limits" / f"{CELL}.json")
GAP_KEYS = ("logits", "gat_feats", "soft_assignments", "region_embeddings", "pred_bboxes", "pred_confidence",
            "dense_objectness_logits", "dense_boxes")
RANGES = ("scene.windows", "scene.stitch", "dense_head", "decode.topk", "decode.nms")


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _tiny():
    args = dict(CONFIG["args"], **tiny_file("configs", "mgu_dense_bf16")["overrides"]["args"])
    return args, dict(TRAFFIC, **tiny_file("traffic", "scene_1024"))


def _decode_args(tf: dict) -> dict:
    return {"top_k": tf["top_k"], "score_threshold": tf["score_threshold"], "iou_threshold": tf["iou_threshold"]}


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return core.load_cell(CELL, tiny_root(tmp_path_factory.mktemp("bench")))


# ---------------------------------------------------------------------------
# The port against the reference, in f32
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f32_pair():
    """The port's f32 model and the reference on one tiny scene batch:
    (program outputs, reference outputs), the reference's region pooling
    and decode fed the program's labels and dense outputs."""
    from mingraph_unet_tpu_torch.models.detection import decode_dense_detections
    from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
    from mingraph_unet_tpu_torch.ops.image import normalize
    from mingraph_unet_tpu_torch.train.infer import pipeline_forward_large

    args, tf = _tiny()
    h, w = tf["height"], tf["width"]
    weights = draw_weights(ref_scene.scene_spec(args), SEED, "cpu")
    x = torch.from_numpy(inputs.tiles(SEED, 0, tf["batch"], h, w)[0])
    mean, std = args["normalization_mean"], args["normalization_std"]
    with one_thread(), torch.no_grad():
        model = MinGraphUNet(**args, dtype=torch.float32, device="cpu")
        model.load_state_dict(weights, strict=True)
        out = pipeline_forward_large(model, normalize(x.float() / 255.0, mean, std), tile=tf["tile"], halo=tf["halo"])
        det = decode_dense_detections(out["dense_objectness_logits"], out["dense_boxes"], (h, w),
                                      cell_size=args["patch_size"], **_decode_args(tf))
        got = {**out, "det_boxes": det[0], "det_scores": det[1], "det_valid": det[2]}
        with Precision("f32").active():
            want = ref_scene.scene_forward(weights, x, args, mean, std, tf["tile"], tf["halo"], Precision("f32"),
                                           got["hard_patch_labels"])
            want.update(ref_scene.decode(got["dense_objectness_logits"], got["dense_boxes"], (h, w),
                                         args["patch_size"], margin=5e-7, **_decode_args(tf)))
    return got, want


def test_the_tiny_scene_clamps_its_border_windows():
    _, tf = _tiny()
    win = tf["tile"] + 2 * tf["halo"]
    assert tf["height"] != tf["width"]
    for size in (tf["height"], tf["width"]):
        starts = ref_scene.window_starts(size, tf["tile"], tf["halo"])
        assert size > win and len(starts) >= 3
        assert starts[-1] == size - win < (len(starts) - 1) * tf["tile"] - tf["halo"]  # the last one clamped


@pytest.mark.parametrize("key", GAP_KEYS)
def test_the_port_matches_the_reference(f32_pair, key):
    got, want = f32_pair
    assert got[key].shape == want[key].shape
    gap = float((got[key].float() - want[key]).abs().max())
    assert gap <= TIGHT * float(want[key].abs().max()), (key, gap)


def test_the_port_s_patch_labels_are_the_reference_s(f32_pair):
    got, want = f32_pair
    assert torch.equal(got["hard_patch_labels"], want["hard_patch_labels"])


@pytest.mark.parametrize("key", ["det_boxes", "det_scores", "det_valid"])
def test_the_port_s_decode_is_the_reference_s(f32_pair, key):
    got, want = f32_pair
    assert torch.equal(got[key], want[key])
    assert int(want["det_valid"].sum()) > 0


# ---------------------------------------------------------------------------
# The decode, bit for bit, on planted dense outputs
# ---------------------------------------------------------------------------


def _planted():
    """Dense outputs of one 64 × 128 image (cells of 16: a 4 × 8 grid).
    Row 0: a chain of 64-pixel boxes 16 pixels apart with falling scores
    (neighbours' IoU 0.6, every other's 1/3): the first and third kept,
    the second and fourth suppressed. Row 2: four small boxes of one score
    (a tie, across the top-k's cut for some k). Row 3: scores exactly at
    the threshold (logit 0) and a hair below it. Elsewhere: small random
    boxes and scores."""
    gen = torch.Generator().manual_seed(7)
    obj = torch.randn((1, 4, 8), generator=gen, dtype=torch.float64).float() - 1.0
    box = torch.rand((1, 4, 8, 4), generator=gen) * torch.tensor([1.0, 1.0, 0.05, 0.05])
    box[0, 0, :4] = torch.tensor([0.5, 0.5, 64 / 128, 64 / 64])
    obj[0, 0, :4] = torch.tensor([4.0, 3.5, 3.0, 2.5])
    obj[0, 2, ::2] = 2.0
    box[0, 2, ::2, 2:] = 0.04
    obj[0, 3, 1], obj[0, 3, 5] = 0.0, -1e-6
    box[0, 3, 1::4, 2:] = 0.04
    return obj, box


@pytest.mark.parametrize("top_k", [5, 6, 7, 32])
@pytest.mark.parametrize("iou_threshold", [0.5, 0.6, 0.65])
def test_the_reference_decode_is_the_port_s_bit_for_bit(top_k, iou_threshold):
    from mingraph_unet_tpu_torch.models.detection import decode_dense_detections

    obj, box = _planted()
    port = decode_dense_detections(obj, box, (64, 128), cell_size=16, top_k=top_k, score_threshold=0.5,
                                   iou_threshold=iou_threshold)
    mine = ref_scene.decode(obj, box, (64, 128), 16, top_k, 0.5, iou_threshold, margin=5e-7)
    for k, v in zip(("det_boxes", "det_scores", "det_valid"), port):
        assert torch.equal(v, mine[k]), k
    if top_k == 32:
        boxes, scores = port[0][0], port[1][0]
        lefts = [(c + 0.5) * 16 - 32 for c in range(4)]
        kept = [bool(((boxes[:, 0] == x) & (boxes[:, 2] == x + 64)).any()) for x in lefts]
        # The neighbours' IoU is 0.6: an IoU at least the threshold suppresses.
        assert kept == ([True] * 4 if iou_threshold > 0.6 else [True, False, True, False])
        assert int((scores == torch.sigmoid(torch.tensor(2.0, dtype=torch.float64)).float()).sum()) == 4  # the tie
        assert bool((scores == 0.5).any())  # a score at the threshold is kept


def test_the_clear_slots_leave_out_decisions_at_a_threshold():
    obj, box = _planted()
    mine = ref_scene.decode(obj, box, (64, 128), 16, 32, 0.5, 0.6, margin=5e-7)
    scores = torch.sigmoid(obj.double()).float().reshape(-1).sort(descending=True, stable=True).values[:32]
    at_threshold = (scores - 0.5).abs() <= 5e-7
    assert at_threshold.sum() == 2  # logit 0 and a hair below
    assert not mine["decode_clear"][0][at_threshold].any()
    # The chain's neighbours meet at IoU 0.6: those after the first are not clear at an IoU threshold of 0.6.
    assert int((~mine["decode_clear"][0][~at_threshold]).sum()) == 3


# ---------------------------------------------------------------------------
# The cell's comparison
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sound(cell):
    with one_thread():
        return calibrate.reading(cell, SEED, "cpu")["numbers"]


def test_every_number_of_the_comparison_has_a_limit(cell, sound):
    assert set(sound) == set(cell.limits) == set(LIMITS)
    assert LIMITS["decode_slots"] == 0 and LIMITS["hard_labels"] == 0


@pytest.mark.parametrize("number", sorted(LIMITS))
def test_the_sound_tiny_comparison_passes_every_limit(sound, number):
    assert sound[number] <= LIMITS[number], (number, sound[number])


@pytest.mark.parametrize("fault", ["altered", "half_batch"])
def test_a_planted_fault_fails_the_comparison(cell, fault):
    with one_thread():
        numbers = calibrate.reading(cell, SEED, "cpu", fault=fault)["numbers"]
    assert any(v > cell.limits[k] for k, v in numbers.items()), numbers


@pytest.fixture(scope="module")
def served(cell):
    """A sound tiny run of the cell's driver: (driver, program outputs,
    reference outputs), compared."""
    with one_thread():
        d = core.driver_module(cell.traffic["entry"]).make(cell.config, cell.traffic, SEED, "cpu")
        d.setup()
        n = cell.traffic["check"]["within"]
        for i in range(n):
            d.wait(d.issue(i))
        d.end_window(n)
        got = d.program_outputs()
        want = d.reference(Precision("f32"), got)
    d.compare(got, want)
    return d, got, want


def test_the_set_up_serves_fruit_that_nms_both_keeps_and_suppresses(served):
    d, got, want = served
    k = d.traffic["top_k"]
    assert d.live_slots > 0
    for w in want.values():
        live = torch.sigmoid(w["dense_objectness_logits"].double()) >= d.traffic["score_threshold"]
        assert int(live.sum()) >= k  # as many live cells as the top-k keeps, a scene on average
        kept = w["det_valid"].sum(dim=1)
        assert bool((kept > 0).all()) and bool((kept < k).any())  # NMS suppresses some of the top-k
    side = torch.cat([w["dense_boxes"][..., 2:] for w in want.values()]) * torch.tensor([d.w, d.h])
    assert float(side.median()) == pytest.approx(core.driver_module("scene").BOX_CELLS * d.cell, rel=0.05)


def test_the_reference_takes_the_program_s_fruit_biases(served):
    d, _, _ = served
    weights, state = d.weights(), d.model.state_dict()
    assert set(d.fruit_biases) == {"dense_detection_head.obj_head.bias", "dense_detection_head.box_head.bias"}
    drawn = draw_weights(ref_scene.scene_spec(d.config["args"]), SEED, "cpu")
    for name, value in d.fruit_biases.items():
        assert torch.equal(weights[name], value) and torch.equal(state[name], value)
        assert not torch.equal(drawn[name], value)
        assert torch.equal(value.to(torch.bfloat16).float(), value)  # the model's precision holds it exactly


def test_a_comparison_with_no_clear_fruit_reads_infinite(served):
    d, got, want = served
    none = {i: dict(w, det_valid=torch.zeros_like(w["det_valid"])) for i, w in want.items()}
    assert d.compare(got, none)["decode_slots"] == float("inf") and d.live_slots == 0
    assert d.compare(got, want)["decode_slots"] == 0.0 and d.live_slots > 0


def _no_nms(boxes, scores, iou_threshold=0.5):
    order = torch.argsort(-scores, dim=-1, stable=True)
    return torch.ones(scores.shape, dtype=torch.bool), order


def _shifted(boxes):
    from mingraph_unet_tpu_torch.ops.boxes import cxcywh_to_xyxy

    return cxcywh_to_xyxy(boxes) + 1.0


@pytest.mark.parametrize("fault", ["no_nms", "shifted_boxes"])
def test_a_planted_decode_fault_fails_the_comparison(cell, fault, monkeypatch):
    """Both sides decode the program's dense outputs, so only the slots'
    check can see a decode that keeps what NMS suppresses, or moves every
    box by a pixel."""
    from mingraph_unet_tpu_torch.models import detection

    if fault == "no_nms":
        monkeypatch.setattr(detection, "nms", _no_nms)
    else:
        monkeypatch.setattr(detection, "cxcywh_to_xyxy", _shifted)
    with one_thread():
        numbers = calibrate.reading(cell, SEED, "cpu")["numbers"]
    assert numbers["decode_slots"] > cell.limits["decode_slots"], numbers
    assert numbers["dense_boxes"] <= cell.limits["dense_boxes"]  # the dense outputs cannot see it


def test_the_reference_imports_nothing_of_the_port_and_no_jax():
    tree = ast.parse((BENCH_DIR / "reference" / "scene.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert names and not any(m.split(".")[0] in ("jax", "jaxlib", "flax", "mingraph_unet_tpu",
                                                 "mingraph_unet_tpu_torch") for m in names)


# ---------------------------------------------------------------------------
# The traced steps and the readers of the program's ranges
# ---------------------------------------------------------------------------


def test_the_traced_steps_open_the_program_ranges_for_the_reader(cell):
    with one_thread():
        d = core.driver_module(cell.traffic["entry"]).make(cell.config, cell.traffic, SEED, "cpu")
        d.setup()
        ctx = run.traced_steps(d, torch, cell, run.Window(units=1, seconds=1.0))
    names = {h["name"] for h in ctx.trace.host}
    want = {f"mgu.{r}" for r in RANGES} | {"mgu.unet", "mgu.detection"}
    assert want <= names
    assert {f"pb.{n}" for n in want} <= names
    from mingraph_unet_tpu_torch.models import detection
    from mingraph_unet_tpu_torch.parallel import spatial
    from mingraph_unet_tpu_torch.train import infer
    from mingraph_unet_tpu_torch.utils import profiling

    assert detection.span is spatial.span is infer.span is profiling.span  # swapped back


def _ctx(ops):
    t = trace.Trace((0.0, 100.0), [trace.DeviceOp(f"k{i}", float(i), 1.0, r) for i, r in enumerate(ops)])
    return run.LayerContext("serve", 2, [], 1.0, 1.0, 1.0, t)


@pytest.mark.parametrize("metric,want", [("scene.device_ms.serve", 3 / 1e3 / 2),
                                         ("decode.device_ms.serve", 2 / 1e3 / 2), ("decode.launches.serve", 2 / 2)])
def test_the_readers_of_the_program_ranges(metric, want):
    ops = [("pb.mgu.scene.windows",), ("pb.layer:unet", "pb.mgu.unet"), ("pb.mgu.scene.stitch",),
           ("pb.layer:unet", "pb.mgu.scene.stitch"), ("pb.layer:graph", "pb.mgu.dense_head"),
           ("pb.mgu.decode.topk",), ("pb.mgu.decode.nms",), ()]
    read = core.metric_module(metric).read
    assert read(_ctx(ops)) == pytest.approx(want)
    # A program without the ranges (the parent's): nothing.
    assert read(_ctx([r for r in ops if not any("scene" in x or "decode" in x for x in r)])) is None


# ---------------------------------------------------------------------------
# The configuration and its model FLOPs
# ---------------------------------------------------------------------------


def test_the_model_flops_of_a_request():
    driver = core.driver_module("scene").make(CONFIG, TRAFFIC, SEED, "cpu")
    a = CONFIG["args"]
    assert (TRAFFIC["height"], TRAFFIC["width"], TRAFFIC["tile"], TRAFFIC["halo"], TRAFFIC["batch"]) == (
        1024, 1024, 512, 64, 16)
    windows = 4 * core.unet_forward_flops(640, 640, 3, 2, 32, 4)  # 2 x 2 windows of 640 a scene
    rest = core.pipeline_forward_flops(1024, 1024, a) - core.unet_forward_flops(1024, 1024, 3, 2, 32, 4)
    dense = 2.0 * (1024 * 1024 * 9 * 96 * 64 + 64 * 64 * 9 * 64 * 64 + 64 * 64 * 64 * 1 + 64 * 64 * 64 * 4)
    assert driver.flops_per_unit == 16 * (windows + rest + dense) == 11_522_526_154_752.0
    assert driver.pixels_per_unit == 16 * 1024 * 1024


def test_the_args_differ_from_the_tiles_configuration_in_the_dense_head_alone():
    tiles = core.read_json(BENCH_DIR / "configs" / "mgu_bf16.json")["args"]
    assert sorted(tiles) == sorted(CONFIG["args"])
    assert {k for k in tiles if tiles[k] != CONFIG["args"][k]} == {"use_dense_detection"}
    assert CONFIG["args"]["use_dense_detection"] is True and CONFIG["reduced"] == []


def test_the_args_build_the_port_s_model_from_the_reference_s_leaves():
    from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet

    model = MinGraphUNet(**CONFIG["args"], dtype=torch.float32, device="cpu")
    spec = ref_scene.scene_spec(CONFIG["args"])
    assert model.load_state_dict(draw_weights(spec, SEED, "cpu"), strict=True)
    assert {n: tuple(s) for n, s, _ in spec} == {n: tuple(v.shape) for n, v in model.state_dict().items()}
