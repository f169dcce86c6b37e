"""The port's command-line entry points and their I/O against the JAX
repo's, on the CPU: the four CLIs of ``mingraph_unet_tpu_torch/scripts``
(``main([... "--cpu"])`` on a ``make_dummy_run`` directory), the
experiments' ``main()``, ``run_results`` and ``run_value_study`` (their
config writer, loss history, renderers and one ``--quick`` run), the YAML
reader and writer of ``config.py`` and the PNG writer of ``data/png.py``.

Tolerances: inference labels and PNGs equal JAX's on the same weights
(carried across by ``convert.py``; the fixture's weights leave every
pixel's argmax clear of a tie, and the test checks it); L_partition within
2e-4 of JAX's, the hard patch labels equal (the soft assignments checked
clear of a tie); parsed YAML equal to ``yaml.safe_load``'s, rendered text
equal.
"""

import dataclasses
import glob
import importlib.util
import json
import math
import os
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mingraph_unet_tpu.config import PipelineConfig as JaxPipelineConfig
from mingraph_unet_tpu.experiments import ablation_study as j_abl
from mingraph_unet_tpu.experiments import yield_estimation_performance as j_yield
from mingraph_unet_tpu.models.gat import GATNetwork as JaxGAT
from mingraph_unet_tpu.models.mincut import MinCutRefinement as JaxMinCut
from mingraph_unet_tpu.train import infer as j_infer
from mingraph_unet_tpu.train import segmentation as j_seg
from mingraph_unet_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from mingraph_unet_tpu.utils.bootstrap import make_dummy_run
from mingraph_unet_tpu_torch import config as t_config
from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.convert import load_jax_variables, variables_from_jax
from mingraph_unet_tpu_torch.data import png as t_png
from mingraph_unet_tpu_torch.data.dataset import read_image
from mingraph_unet_tpu_torch.experiments import ablation_study as t_abl
from mingraph_unet_tpu_torch.experiments import segmentation_performance as t_segperf
from mingraph_unet_tpu_torch.experiments import yield_estimation_performance as t_yield
from mingraph_unet_tpu_torch.scripts import graph_refinement as t_graph
from mingraph_unet_tpu_torch.scripts import infer_segmentation as t_infer_cli
from mingraph_unet_tpu_torch.scripts import run_results as t_rr
from mingraph_unet_tpu_torch.scripts import run_value_study as t_vs
from mingraph_unet_tpu_torch.scripts import train_end_to_end as t_e2e_cli
from mingraph_unet_tpu_torch.scripts import train_segmentation as t_seg_cli
from mingraph_unet_tpu_torch.train.checkpoint import CheckpointManager
from mingraph_unet_tpu_torch.train.infer import load_variables
from mingraph_unet_tpu_torch.utils import bootstrap as t_boot
from mingraph_unet_tpu_torch.utils import env as t_env

REPO = Path(__file__).resolve().parents[1]
S = 32
REL_TOL = 2e-4
ARGMAX_MARGIN = 1e-3  # the smallest top-two logit gap, of the largest


def _jax_script(name):
    """``scripts/<name>.py`` of the JAX repo as a module (they are no
    package); loaded under another name so that pytest collects none of
    its functions."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_RR = _jax_script("run_results")
J_VS = _jax_script("run_value_study")
J_GRAPH = _jax_script("graph_refinement")


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A ``make_dummy_run`` directory at 32² (4 images, batch 2, depth 2,
    patch 8) and one of its images."""
    base = str(tmp_path_factory.mktemp("scripts_run"))
    cfg_dir = make_dummy_run(base, num_images=4, image_size=(S, S), batch_size=2, num_epochs=1, patch_size=8,
                             init_features=4, depth=2, seed=2)
    image = sorted(glob.glob(os.path.join(base, "data", "train", "images", "*.png")))[0]
    return base, cfg_dir, image


# ---------------------------------------------------------------------------
# The CLIs and the experiments' main() need the card unless --cpu
# ---------------------------------------------------------------------------

MAINS = {
    "train_segmentation": (t_seg_cli.main, ["--config_path", "{cfg}"]),
    "train_end_to_end": (t_e2e_cli.main, ["--config_path", "{cfg}"]),
    "infer_segmentation": (t_infer_cli.main, ["--config_path", "{cfg}", "--image_path", "{img}",
                                              "--weights_path", "{cfg}"]),
    "graph_refinement": (t_graph.main, ["--config_path", "{cfg}", "--image_path", "{img}"]),
    "segmentation_performance": (t_segperf.main, ["--config_path", "{cfg}", "--weights_path", "{cfg}"]),
    "yield_estimation_performance": (t_yield.main, []),
    "ablation_study": (t_abl.main, []),
    "run_results": (t_rr.main, ["--quick"]),
    "run_value_study": (t_vs.main, ["--quick"]),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_runs_on_the_card_unless_cpu(name, run_dir):
    """Without ``--cpu`` every entry point asks for the card, and without
    one it raises before it reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run on it")
    fn, argv = MAINS[name]
    _, cfg_dir, image = run_dir
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn([a.format(cfg=cfg_dir, img=image) for a in argv])


def test_setup_host():
    assert t_env.setup_host(force_cpu=True) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_env.setup_host()


# ---------------------------------------------------------------------------
# Training CLIs
# ---------------------------------------------------------------------------


def _copy_run(tmp_path, base):
    """A fresh copy of the run's configs pointing at its data but at new
    checkpoint and log directories."""
    cfg_dir = tmp_path / "configs"
    cfg_dir.mkdir()
    for name in ("dataset.yaml", "model.yaml", "preprocessing.yaml", "training.yaml"):
        data = t_config.load_yaml(os.path.join(base, "configs", name))
        if name == "training.yaml":
            data.update(checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"))
        t_config.write_yaml(str(cfg_dir / name), data)
    return str(cfg_dir)


@pytest.mark.parametrize("cli", ["train_segmentation", "train_end_to_end", "train_end_to_end_no_detection"])
def test_training_cli_trains_and_checkpoints(cli, run_dir, tmp_path):
    """One epoch through ``main``: the history of the trainer's own call,
    finite, and the checkpoint it writes holds the trained weights."""
    base, _, _ = run_dir
    cfg_dir = _copy_run(tmp_path, base)
    main = t_seg_cli.main if cli == "train_segmentation" else t_e2e_cli.main
    extra = ["--no_detection"] if cli.endswith("no_detection") else []
    state, history = main(["--config_path", cfg_dir, "--epochs", "1", "--cpu", *extra])
    assert len(history["epoch_loss"]) == 1 and math.isfinite(history["epoch_loss"][0])
    saved = load_variables(str(tmp_path / "ckpt"))
    own = state.model.state_dict()
    assert sorted(saved) == sorted(own)
    for k, v in own.items():
        assert torch.equal(saved[k], v.cpu()), k
    if cli != "train_segmentation":  # the detection losses are logged unless --no_detection
        logged = [json.loads(line) for f in glob.glob(str(tmp_path / "logs" / "*.jsonl")) for line in open(f)]
        assert logged and all(("l_bbox" in row) == (not extra) for row in logged)


# ---------------------------------------------------------------------------
# Inference CLI on JAX weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unet_weights(run_dir, tmp_path_factory):
    """The run's U-Net, initialized by JAX with its final conv sharpened so
    that every argmax is clear, as a JAX (Orbax) and a port checkpoint."""
    _, cfg_dir, _ = run_dir
    root = str(tmp_path_factory.mktemp("unet_weights"))
    v = jax.jit(j_seg.build_unet(JaxPipelineConfig.from_config_dir(cfg_dir)).init)(
        jax.random.key(8), jnp.zeros((1, S, S, 3)))
    tree = jax.tree_util.tree_map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})
    fc = tree["params"]["decoder"]["final_conv"]
    fc["kernel"] = fc["kernel"] * 16.0
    fc["bias"] = fc["bias"] + np.asarray([0.1, -0.1], np.float32)
    jdir, tdir = os.path.join(root, "jax"), os.path.join(root, "torch")
    mngr = JaxCheckpointManager(jdir)
    mngr.save(0, tree)
    mngr.close()
    CheckpointManager(tdir).save(0, variables_from_jax(tree))
    return jdir, tdir


def _check_margin(cfg_dir, weights_dir, image_u8):
    from mingraph_unet_tpu_torch.ops.image import normalize
    from mingraph_unet_tpu_torch.train.segmentation import build_unet

    cfg = PipelineConfig.from_config_dir(cfg_dir)
    model = build_unet(cfg, "cpu").eval()
    model.load_state_dict(load_variables(weights_dir))
    pre = cfg.preprocessing
    x = normalize(torch.from_numpy(image_u8).float() / 255.0, pre.normalization_mean, pre.normalization_std)[None]
    with torch.no_grad():
        top2 = model(x)["logits"].topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    assert float(gap.min()) >= ARGMAX_MARGIN * float(gap.max()), float(gap.min() / gap.max())


def _decoded(path):
    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


@pytest.mark.parametrize("large_scene", [False, True], ids=["image", "large_scene"])
def test_infer_segmentation_cli_matches_jax(large_scene, run_dir, unet_weights, tmp_path):
    """The CLI's labels and both PNGs (decoded) equal JAX's
    ``infer_segmentation`` on the same weights; ``--large_scene`` on a 96²
    scene at tile 16, halo 24 (36 windows)."""
    _, cfg_dir, image = run_dir
    jdir, tdir = unet_weights
    args = ["--config_path", cfg_dir, "--weights_path", tdir, "--output_dir", str(tmp_path / "t"), "--cpu"]
    if large_scene:
        image_path = str(tmp_path / "scene.png")
        cv2.imwrite(image_path, cv2.resize(cv2.imread(image), (96, 96), interpolation=cv2.INTER_LINEAR))
        ref = j_infer.infer_segmentation_large(cfg_dir, image_path, jdir, str(tmp_path / "j"), tile=16, halo=24)
        args += ["--large_scene", "--tile", "16", "--halo", "24"]
    else:
        image_path = image
        ref = j_infer.infer_segmentation(cfg_dir, image_path, jdir, str(tmp_path / "j"))
    _check_margin(cfg_dir, tdir, read_image(image_path) if large_scene else read_image(image_path, (S, S)))
    got = t_infer_cli.main(["--image_path", image_path, *args])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    assert 0 < int(got["labels"].sum()) < got["labels"].size  # both classes appear
    for key in ("label_path", "vis_path"):
        assert os.path.basename(got[key]) == os.path.basename(ref[key])
        np.testing.assert_array_equal(_decoded(got[key]), _decoded(ref[key]))


@pytest.mark.parametrize("cli", ["train_segmentation", "train_end_to_end", "infer_segmentation",
                                 "graph_refinement"])
def test_cli_smoke_without_a_config(cli, tmp_path, capsys):
    """Without ``--config_path`` each CLI writes a tiny dataset and configs
    to a temporary directory, runs on them and removes them, as the JAX
    scripts do."""
    main = {"train_segmentation": t_seg_cli.main, "train_end_to_end": t_e2e_cli.main,
            "infer_segmentation": t_infer_cli.main, "graph_refinement": t_graph.main}[cli]
    extra = ["--output_dir", str(tmp_path)] if cli == "infer_segmentation" else []
    main(["--cpu", *extra, *(["--epochs", "1"] if cli.startswith("train") else [])])
    assert f"[smoke] {cli} OK" in capsys.readouterr().out
    if cli == "infer_segmentation":
        assert sorted(os.listdir(tmp_path)) == ["img_000_seg_labels.png", "img_000_seg_visualization.png"]


def test_infer_segmentation_cli_needs_image_and_weights(run_dir):
    _, cfg_dir, _ = run_dir
    with pytest.raises(SystemExit):
        t_infer_cli.main(["--config_path", cfg_dir, "--cpu"])


# ---------------------------------------------------------------------------
# Graph refinement on JAX's initialized variables
# ---------------------------------------------------------------------------


def _jax_graph_features(cfg_dir, image_path):
    """JAX's feature recipe (``scripts/graph_refinement.py``), as numpy."""
    from mingraph_unet_tpu.data.dataset import _resize_image, load_image_rgb
    from mingraph_unet_tpu.ops import filters
    from mingraph_unet_tpu.ops.image import normalize
    from mingraph_unet_tpu.ops.patches import patch_reduce_mean

    cfg = JaxPipelineConfig.from_config_dir(cfg_dir)
    patch = cfg.model.graph_construction.patch_size
    rgb = _resize_image(load_image_rgb(image_path), cfg.preprocessing.resize_dim)
    x = normalize(jnp.asarray(rgb, jnp.float32) / 255.0, cfg.preprocessing.normalization_mean,
                  cfg.preprocessing.normalization_std)
    sobel = filters.sobel_magnitude(jnp.asarray(rgb))[None, ..., None] / 255.0
    histeq = filters.equalize_histogram_rgb(jnp.asarray(rgb)).astype(jnp.float32)[None] / 255.0
    return cfg, jnp.concatenate([patch_reduce_mean(x[None], patch), patch_reduce_mean(sobel, patch),
                                 patch_reduce_mean(histeq, patch)], axis=-1)


def test_graph_refinement_matches_jax(run_dir):
    """Features, L_partition and hard labels against JAX's
    ``test_graph_pipeline``, the port's modules holding JAX's GAT (key 0)
    and MinCut (key 1) variables."""
    _, cfg_dir, image = run_dir
    ref_l, ref_hard = getattr(J_GRAPH, "test_graph_pipeline")(cfg_dir, image)
    jcfg, jfeats = _jax_graph_features(cfg_dir, image)
    g = jcfg.model.gat
    jgat = JaxGAT(hidden_dim=g.hidden_dim, output_dim=g.output_dim, num_heads=g.num_heads, num_layers=1,
                  dropout_rate=g.dropout, alpha=g.alpha, backend="lattice")
    v_gat = jax.jit(jgat.init)(jax.random.key(0), jfeats)
    jmc = JaxMinCut(num_segments=jcfg.dataset.num_semantic_regions, sigma_ncut=jcfg.model.mincut.sigma_ncut,
                    backend="lattice")
    v_mc = jax.jit(jmc.init)(jax.random.key(1), jgat.apply(v_gat, jfeats))

    cfg = PipelineConfig.from_config_dir(cfg_dir)
    feats = t_graph.graph_features(cfg, image, torch.device("cpu"))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0, atol=REL_TOL * float(np.abs(jfeats).max()))
    gat, mincut = t_graph.build_graph_modules(cfg, feats.shape[-1], torch.device("cpu"))
    load_jax_variables(gat, v_gat)
    load_jax_variables(mincut, v_mc)
    with torch.no_grad():
        soft = mincut(gat(feats))[1]
    top2 = soft.topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4  # no tie for the argmax to break
    l_part, hard = t_graph.run_graph_pipeline(feats, gat, mincut)
    assert abs(l_part - ref_l) <= REL_TOL * max(abs(ref_l), 1e-6)
    np.testing.assert_array_equal(hard, ref_hard)


def test_graph_refinement_cli(run_dir, capsys):
    """``main`` with the seeded modules: a finite L_partition and one label
    per patch, printed as the JAX script prints them."""
    _, cfg_dir, image = run_dir
    l_part, hard = t_graph.main(["--config_path", cfg_dir, "--image_path", image, "--cpu"])
    assert math.isfinite(l_part) and l_part >= 0 and hard.shape == (S // 8, S // 8)
    out = capsys.readouterr().out
    assert "[graph] patch grid 4x4, node feature dim 7" in out and "L_partition" in out


# ---------------------------------------------------------------------------
# The experiments' main()
# ---------------------------------------------------------------------------


def test_experiment_mains_match_jax(capsys):
    """The mock rows (no weights needed) through each ``main`` equal the
    JAX functions' rows."""
    got = t_yield.main(["--model_type", "mock", "--num_images", "3", "--cpu"])
    ref = j_yield.evaluate_yield_model(None, None, "mock", 3)
    assert got == pytest.approx(ref)
    got_rows = t_abl.main(["--num_images", "2", "--cpu"])
    ref_rows = j_abl.run_ablation_study(None, None, 2, allow_mock=True)
    assert got_rows == ref_rows


def test_segmentation_performance_main(run_dir, unet_weights, capsys):
    _, cfg_dir, _ = run_dir
    args = ["--config_path", cfg_dir, "--weights_path", unet_weights[1], "--batch_size", "2", "--cpu"]
    got = t_segperf.main(args)
    ref = t_segperf.evaluate_segmentation_model(cfg_dir, unet_weights[1], "unet", 2, device="cpu")
    assert json.dumps(got, default=str) == json.dumps(ref, default=str)


# ---------------------------------------------------------------------------
# run_results and run_value_study
# ---------------------------------------------------------------------------

WRITE_CASES = {
    "unet": dict(epochs=3, batch_size=4, lr_step=2, annotations=False),
    "full_dense": dict(epochs=5, batch_size=2, lr_step=1, use_dense=True, patch_size=8, graph_warmup_epochs=2),
    "variant": dict(epochs=2, batch_size=8, lr_step=3, ablation=t_abl.VARIANT_TOGGLES["mincut_only"],
                    losses=dict(l_feature_weight=0.01), lr=2e-3, instancing="exact", loss_balance="uncertainty",
                    scan_window=1),
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_write_config_dir_matches_jax(case, tmp_path):
    """The four files parse (by PyYAML and by the port) to what JAX's
    ``write_config_dir`` writes, and read as the same configs."""
    kw = dict(WRITE_CASES[case], data_root=str(tmp_path / "data"), image_size=(48, 64),
              ckpt_dir=str(tmp_path / "ck"), log_dir=str(tmp_path / "logs"))
    jdir = J_RR.write_config_dir(str(tmp_path / "j"), **kw)
    tdir = t_rr.write_config_dir(str(tmp_path / "t"), **kw)
    for name in ("dataset.yaml", "model.yaml", "preprocessing.yaml", "training.yaml"):
        ref_text, got_text = (Path(d, name).read_text() for d in (jdir, tdir))
        assert yaml.safe_load(got_text) == yaml.safe_load(ref_text) == t_config.parse_yaml(ref_text), name
        assert got_text == ref_text, name
    got, ref = PipelineConfig.from_config_dir(tdir), JaxPipelineConfig.from_config_dir(jdir)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_read_loss_history_and_fmt_pct_match_jax(tmp_path):
    (tmp_path / "a.jsonl").write_text('{"step": 1, "loss": 2.5}\nnot json\n{"step": 2, "loss": 1.5}\n')
    (tmp_path / "b.jsonl").write_text('{"step": 3, "total": 0.5}\n')
    assert t_rr.read_loss_history(str(tmp_path)) == J_RR.read_loss_history(str(tmp_path))
    for x in (95.3, 7, "—", None, float("nan")):
        assert t_rr.fmt_pct(x) == J_RR.fmt_pct(x)


def test_plot_losses(tmp_path, monkeypatch, capsys):
    histories = {"unet": [{"step": 1, "loss": 2.0}, {"step": 2, "loss": 1.0}], "empty": []}
    out = t_rr.plot_losses(histories, str(tmp_path / "curves.png"))
    assert out == str(tmp_path / "curves.png") and os.path.getsize(out) > 0
    assert t_rr.plot_losses({"empty": []}, str(tmp_path / "none.png")) is None
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert t_rr.plot_losses(histories, str(tmp_path / "skipped.png")) is None
    assert "skipping loss plot" in capsys.readouterr().out and not (tmp_path / "skipped.png").exists()


def _seg_row(rng):
    iou = rng.random(2).tolist()
    cm = rng.integers(0, 100, (2, 2)).tolist()
    return {"mean_iou": float(np.mean(iou)), "iou_per_class": iou, "mean_precision": float(rng.random()),
            "mean_recall": float(rng.random()), "mean_f1": float(rng.random()), "confusion_matrix": cm}


def _yield_row(rng):
    keys = ("count_accuracy_perc", "yield_estimation_error_perc", "object_matching_rate_perc",
            "occlusion_robustness_perc", "ap50_perc")
    return {k: float(rng.uniform(0, 100)) for k in keys}


def test_render_markdown_matches_jax():
    rng = np.random.default_rng(4)
    results = {
        "config": {"num_train": 12, "num_val": 4, "num_test": 6, "image_size": 64, "batch_size": 2,
                   "epochs": 2, "variant_epochs": 1, "eval_images": 4, "quick": True},
        "table1_segmentation": {"unet": _seg_row(rng), "mingraph-unet": _seg_row(rng),
                                "no cm": {"mean_iou": 0.5, "iou_per_class": [0.4]}},
        "table2_yield": {"unet_cc_counting": _yield_row(rng), "partial": {"count_accuracy_perc": 90.0}},
        "table3_ablation": [{"variant": name, **_yield_row(rng)} for name in t_abl.ABLATION_VARIANTS],
        "wall_clock_sec": 12.3,
    }
    for curve in (None, "outputs/loss_curves.png"):
        assert t_rr._render_markdown(results, curve) == J_RR._render_markdown(results, curve)


def _study_results(rng, with_sweep):
    rows = {}
    for slug in list(t_vs.LABELS) + ["unlabelled_arm"]:
        row = {"segmentation": _seg_row(rng), "cc_counting": _yield_row(rng)}
        if slug != "unet":
            row["dense_head"] = _yield_row(rng)
            if "nofusion" not in slug:
                row["segmentation_refined"] = _seg_row(rng)
                row["cc_counting_refined"] = _yield_row(rng)
        rows[slug] = row
    rows["full_lfeat_0"] = {"error": "RuntimeError: boom"}
    results = {"scene": {**J_VS.HARD_SCENE, "train_only": J_VS.HARD_TRAIN_ONLY},
               "config": {"num_train": 320, "num_test": 200, "image_size": 64, "patch_size": 8, "epochs": 16,
                          "batch_size": 16, "warmup_epochs": 8},
               "rows": rows, "wall_clock_sec": 99.5}
    if with_sweep:
        results["blend_sweep"] = {"full_twophase": {"γ=0.1": _seg_row(rng), "γ=0.5": {"error": "x"}},
                                  "twophase_psup": {"γ=0.2, τ=0.01": _seg_row(rng)}}
    return results


@pytest.mark.parametrize("with_sweep", [False, True])
def test_value_study_renderers_match_jax(with_sweep):
    rng = np.random.default_rng(7)
    results = _study_results(rng, with_sweep)
    assert t_vs.render_markdown(results) == J_VS.render_markdown(results)
    for row in results["rows"].values():
        if "segmentation" in row:
            assert t_vs.seg_cells(row) == J_VS.seg_cells(row)
            assert t_vs.yield_cells(row.get("dense_head")) == J_VS.yield_cells(row.get("dense_head"))
    assert t_vs.yield_cells(None) == J_VS.yield_cells(None)
    assert (t_vs.LABELS, t_vs.HARD_SCENE, t_vs.HARD_TRAIN_ONLY, t_vs.ZERO_GRAPH_LOSSES) == (
        J_VS.LABELS, J_VS.HARD_SCENE, J_VS.HARD_TRAIN_ONLY, J_VS.ZERO_GRAPH_LOSSES)


def _stub_stages(monkeypatch, module, calls):
    """Replace a driver's dataset, training and evaluation stages with
    stubs that record each call (the config's run directory and the
    device) and return seeded rows."""
    rng = np.random.default_rng(3)

    def generate(root, *args, **kwargs):
        os.makedirs(root, exist_ok=True)
        calls.append(("data", os.path.basename(root), kwargs.get("train_only_kwargs")))

    def train(name):
        def run(cfg_dir, device=None, **kwargs):
            calls.append((name, Path(cfg_dir).parent.name, device))
            return None, {"epoch_loss": [1.0]}
        return run

    def evaluate_seg(cfg_dir, ckpt, model_type, *args, device=None, **kwargs):
        calls.append(("table1", Path(cfg_dir).parent.name, model_type, device))
        row = _seg_row(rng)
        row.update({k: row["iou_per_class"] for k in ("precision_per_class", "recall_per_class", "f1_per_class")})
        return row

    def evaluate_yield(cfg_dir, ckpt, model_type="mock", *args, device=None, **kwargs):
        calls.append(("yield", Path(cfg_dir).parent.name, model_type, device))
        return _yield_row(rng)

    monkeypatch.setattr(module, "generate_orchard_dataset", generate)
    monkeypatch.setattr(module, "train_unet_segmentation", train("train_unet"))
    monkeypatch.setattr(module, "train_end_to_end", train("train_e2e"))
    monkeypatch.setattr(module, "evaluate_segmentation_model", evaluate_seg)
    monkeypatch.setattr(module, "evaluate_yield_model", evaluate_yield)


def test_run_results_stages(tmp_path, monkeypatch):
    """``run_results.main`` with its stages stubbed: the runs it trains on
    the CPU, each with its own config directory, the tables it evaluates,
    and results.json / RESULTS.md from them."""
    calls = []
    _stub_stages(monkeypatch, t_rr, calls)
    out = tmp_path / "outputs"
    results = t_rr.main(["--quick", "--cpu", "--out", str(tmp_path / "run"), "--results_dir", str(out)])
    cpu = torch.device("cpu")
    variants = [slug for slug in t_abl.ABLATION_VARIANTS.values() if slug != "combined"]
    trained = [c[1:] for c in calls if c[0].startswith("train")]
    assert trained == [("unet", cpu), ("full", cpu), ("full_twophase", cpu)] + [(v, cpu) for v in variants]
    assert all(c[-1] == cpu for c in calls if c[0] in ("table1", "yield"))
    assert len([c for c in calls if c[0] == "table1"]) == 4 and len([c for c in calls if c[0] == "yield"]) == 10
    assert t_config.load_yaml(str(tmp_path / "run" / "full_twophase" / "configs" / "training.yaml"))[
        "graph_warmup_epochs"] == 1
    saved = json.loads((out / "results.json").read_text())
    assert saved["config"]["quick"] is True and len(saved["table3_ablation"]) == len(t_abl.ABLATION_VARIANTS)
    curve = str(out / "loss_curves.png") if (out / "loss_curves.png").exists() else None
    assert (out / "RESULTS.md").read_text() == t_rr._render_markdown(results, curve)
    assert calls[0][0] == "data" and (tmp_path / "run" / "data" / ".complete").exists()
    calls.clear()
    t_rr.main(["--quick", "--cpu", "--out", str(tmp_path / "run"), "--results_dir", str(out)])
    assert calls[0][0] != "data"  # the dataset is generated once


@pytest.mark.parametrize("mode", ["all", "only", "eval_only", "abort"])
def test_run_value_study_stages(tmp_path, monkeypatch, mode):
    """``run_value_study.main`` with its stages stubbed: every arm in
    order, ``--only`` merging into the saved rows, ``--eval_only``
    training nothing, and the baseline gate aborting a collapsed study."""
    calls = []
    _stub_stages(monkeypatch, t_vs, calls)
    out = tmp_path / "outputs"
    argv = ["--quick", "--cpu", "--out", str(tmp_path / "run"), "--results_dir", str(out)]
    if mode == "abort":
        argv += ["--require_baseline_iou", "1.01"]
    results = t_vs.main(argv)
    arms = ["unet", "full_default", "full_twophase", "dense_nofusion", "nofusion_twophase", "control_nographstages",
            "full_lfeat_0.01", "full_lfeat_0", "twophase_psup", "full_uncertainty", "twophase_psup_nofusion",
            "twophase_lgrid_low", "twophase_lgrid_hi"]  # the study's order, most telling first
    assert set(arms) == set(t_vs.LABELS)
    if mode == "abort":
        assert list(results["rows"]) == ["unet"] and "baseline collapsed" in results["aborted"]
        return
    assert list(results["rows"]) == arms and not results.get("blend_sweep")  # no checkpoint to sweep
    assert all(c[-1] == torch.device("cpu") for c in calls[1:])
    assert ("data", "data", t_vs.HARD_TRAIN_ONLY) in calls
    saved = json.loads((out / "value_study.json").read_text())
    assert list(saved["rows"]) == arms
    assert (out / "VALUE_STUDY.md").read_text() == t_vs.render_markdown(saved)
    if mode == "only":
        calls.clear()
        results = t_vs.main(argv + ["--only", "unet,dense_nofusion"])
        assert {c[1] for c in calls if c[0].startswith("train")} == {"unet", "dense_nofusion"}
        assert list(results["rows"]) == arms  # the other arms' rows kept
    if mode == "eval_only":
        for slug in ("unet", "twophase_psup"):
            (tmp_path / "run" / slug / "checkpoints").mkdir(parents=True, exist_ok=True)
            (tmp_path / "run" / slug / "checkpoints" / "ckpt").write_text("x")
        calls.clear()
        results = t_vs.main(argv + ["--eval_only"])
        assert not [c for c in calls if c[0].startswith("train")]
        assert {c[1] for c in calls if c[0] == "table1"} == {"unet", "twophase_psup"}
        assert set(results["blend_sweep"]) == {"twophase_psup"}


@pytest.mark.slow
def test_run_results_quick(tmp_path):
    """All of ``run_results`` at ``--quick`` on the CPU: dataset, both
    models, the two-phase model, four variants, Tables 1-3, the loss plot
    and RESULTS.md. Marked slow: alone it takes ~30 s on 8 cores, but in
    the tier-1 run, beside five other workers, 683 s; the stage tests
    above hold its orchestration there."""
    out = tmp_path / "outputs"
    results = t_rr.main(["--quick", "--cpu", "--out", str(tmp_path / "run"), "--results_dir", str(out)])
    assert set(results["table1_segmentation"]) == {"unet", "mingraph-unet", "mingraph-unet + graph-refined eval",
                                                   "mingraph-unet (two-phase)"}
    assert len(results["table2_yield"]) == 5 and len(results["table3_ablation"]) == len(t_abl.ABLATION_VARIANTS)
    for row in results["table1_segmentation"].values():
        assert all(math.isfinite(v) for v in row["iou_per_class"])
    saved = json.loads((out / "results.json").read_text())
    assert saved["config"]["quick"] is True and saved["config"]["image_size"] == 64
    assert (out / "RESULTS.md").read_text() == t_rr._render_markdown(saved, str(out / "loss_curves.png"))
    assert (out / "loss_curves.png").stat().st_size > 0


# ---------------------------------------------------------------------------
# YAML and PNG without PyYAML and OpenCV
# ---------------------------------------------------------------------------

FENCED = (
    "---\n\n**`configs/dataset.yaml`**\n\n```yaml\n"
    "dataset_name: Test  # the reference's fenced file\nnum_classes: 3\nimage_height: 64\nimage_width: 64\n"
    "mean: [0.5, 0.5, 0.5]\n```\n"
)

YAML_TEXTS = {
    "scalars": "a: 1e-5\nb: 1.0e-05\nc: 0x1F\nd: 010\ne: yes\nf: Off\ng: ~\nh: .inf\ni: -.5\nj: 1_000\nk: 1:30\n"
               "l: 'it''s'\nm: \"q \\\" # not a comment\"\nn: plain text # a comment\no: -x\np: ''\n",
    "collections": "a: [1, [2, 'x y'], {}]\nb: {k: v, 'q': [1]}\nc:\n- 1\n- two\nd:\n  - 3\n  - -4\n"
                   "e:\n  f:\n    g: null\n  h: []\n",
    "folded": "key: a value\n  folded on\n\nnext: 2\n...\n",
}


@pytest.mark.parametrize("name", sorted(YAML_TEXTS))
def test_parse_yaml_matches_pyyaml(name):
    text = YAML_TEXTS[name]
    assert t_config.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: &x 1\n", "a: |\n  x\n", "- a: 1\n", "a: [1, 2\n", "%YAML 1.1\n---\na: 1\n",
                                  "a: 1\n---\nb: 2\n", "a: 2020-01-01\n"])
def test_parse_yaml_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        t_config.parse_yaml(text)


def test_load_yaml_matches_jax_on_configs_and_written_files(tmp_path):
    """``configs/*.yaml``, the fenced reference file and what both
    ``make_dummy_run``s write: the port's reader gives PyYAML's dicts and
    JAX's ``load_yaml``'s."""
    from mingraph_unet_tpu.config import load_yaml as jax_load_yaml

    (tmp_path / "fenced.yaml").write_text(FENCED)
    jax_dir = make_dummy_run(str(tmp_path / "j"), num_images=1, image_size=(16, 16), with_annotations=True)
    port_dir = t_boot.make_dummy_run(str(tmp_path / "t"), num_images=1, image_size=(16, 16), with_annotations=True)
    paths = sorted(glob.glob(str(REPO / "configs" / "*.yaml")) + glob.glob(os.path.join(jax_dir, "*.yaml"))
                   + glob.glob(os.path.join(port_dir, "*.yaml")))
    assert len(paths) == 12
    for path in paths:
        assert t_config.load_yaml(path) == yaml.safe_load(open(path)) == jax_load_yaml(path), path
    assert t_config.load_yaml(str(tmp_path / "fenced.yaml")) == jax_load_yaml(str(tmp_path / "fenced.yaml"))
    assert t_config.load_yaml(str(tmp_path / "fenced.yaml"))["num_classes"] == 3


def test_dump_yaml_round_trips_through_pyyaml(tmp_path):
    data = {"a": 1e-5, "b": "1e-5", "c": None, "d": "", "e": "yes", "f": [1, [2, 3], (4.5,)], "g": {}, "h": [],
            "i": "a: b", "j": float("-inf"), "k": "010", "l": 1.0, "m": 3e20, "n": "-x", "o": "#c",
            "p": "path/with space/x", "q": "ünï", "r": "a\nb", "t": 12345678901234567890, "u": 0.1 + 0.2,
            "v": {"w": [1.5, "x"], "y": {"z": None}}, "w": "null", "x": "-", "y": "a,b", "z": "2020-01-01",
            "aa": "=", "ab": True, "ac": "it's", 7: "int key"}
    want = json.loads(json.dumps(data, default=list).replace('"-Infinity"', '"x"'))  # tuples as lists
    want["j"], want[7] = float("-inf"), want.pop("7")
    text = t_config.dump_yaml(data)
    assert yaml.safe_load(text) == t_config.parse_yaml(text) == want
    for name, section in (("model.yaml", PipelineConfig().model), ("training.yaml", PipelineConfig().training)):
        sec = dataclasses.asdict(section)
        t_config.write_yaml(str(tmp_path / name), sec)
        assert (tmp_path / name).read_text() == yaml.safe_dump(json.loads(json.dumps(sec)), sort_keys=False)
    with pytest.raises(TypeError):
        t_config.dump_yaml({"a": [{"b": 1}]})


@pytest.mark.parametrize("shape", [(7, 9), (13, 5, 3), (1, 1), (40, 33, 3)])
def test_png_writer_decodes_bit_equal(shape, tmp_path):
    """OpenCV and the C++ loader decode the writer's file to the array
    (every row filter, odd widths); ``png_size`` reads its header."""
    rng = np.random.default_rng(sum(shape))
    arr = rng.integers(0, 256, shape).astype(np.uint8)
    arr[::3] //= 7  # runs beside the noise
    path = t_png.write_png(str(tmp_path / "x.png"), arr)
    flag = cv2.IMREAD_GRAYSCALE if arr.ndim == 2 else cv2.IMREAD_COLOR
    decoded = cv2.imread(path, flag)
    np.testing.assert_array_equal(decoded if arr.ndim == 2 else decoded[..., ::-1], arr)
    assert t_png.png_size(path) == shape[:2]
    if arr.ndim == 3:
        np.testing.assert_array_equal(read_image(path), arr)
    with pytest.raises(ValueError):
        t_png.png_bytes(arr.astype(np.int32))


def test_read_image_matches_opencv(run_dir, tmp_path):
    """A PNG through the C++ loader equals OpenCV's decode at its own size
    and is within one grey level of OpenCV's bilinear resize at another
    (OpenCV's fixed-point weights; JAX's ``tests/test_native_loader.py``
    holds its loader so); another format goes through OpenCV."""
    _, _, image = run_dir
    rgb = cv2.cvtColor(cv2.imread(image), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(read_image(image), rgb)
    resized = cv2.resize(rgb, (45, 21), interpolation=cv2.INTER_LINEAR)
    assert np.abs(read_image(image, (21, 45)).astype(int) - resized).max() <= 1
    bmp = str(tmp_path / "x.bmp")
    cv2.imwrite(bmp, cv2.imread(image))
    np.testing.assert_array_equal(read_image(bmp), rgb)
    with pytest.raises(ValueError, match="not a PNG"):
        t_png.png_size(bmp)
