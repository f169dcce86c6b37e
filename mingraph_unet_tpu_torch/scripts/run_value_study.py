"""Graph-branch value study: does the graph branch earn its
FLOPs — and if not, why?

The finding that prompts it (the JAX package's study): on the easy synthetic set the full MinGraph-UNet LOSES to
its own U-Net baseline on segmentation (mIoU 0.9721 vs 0.9965) and barely
ties on counting. Structural diagnosis to test: the pipeline's segmentation
logits come purely from the U-Net (``models/pipeline.py`` stage 1 — the
reference wires it the same way), so the graph branch can influence
segmentation ONLY through shared-encoder gradients of the six extra losses
(multi-task interference), while its features reach DETECTION directly via
fusion. Hypotheses:

H1 (regime): on an easy dataset the extra losses are pure interference; a
   hard regime (fruit-colored clutter, strong lighting gradients, heavy
   occlusion, train-label noise) gives the graph losses signal to add.
H2 (weighting): the raw feature-consistency loss is ~25× the CE term, so
   λ_feature=0.1 makes it the dominant gradient — sweep it down.
H3 (schedule): two-phase training (CE(+detection)-only warmup → joint)
   protects early segmentation learning from noisy graph-loss gradients.
H4 (mechanism): graph features help where they're actually consumed — the
   (dense) detection head. Ablating fusion OFF under the SAME dense head
   isolates the graph branch's contribution to counting.

Protocol: one hard-regime dataset (train-only label noise; eval GT clean),
all models trained with identical budgets and evaluated with the
reference-exact metrics on the test split (Table 1 mango IoU / mIoU,
Table 2 counting + AP@0.5). Every trained row is reported — no selection.
Writes ``outputs/VALUE_STUDY.md`` + ``value_study.json``.

Counterpart of ``scripts/run_value_study.py``:

    python -m mingraph_unet_tpu_torch.scripts.run_value_study --out runs/value_study [--only a,b] [--eval_only] [--cpu]

Every stage runs on the CUDA card unless ``--cpu`` is given; the synthetic
dataset is drawn with OpenCV (``data/synthetic.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from mingraph_unet_tpu_torch.data.synthetic import generate_orchard_dataset
from mingraph_unet_tpu_torch.experiments.segmentation_performance import evaluate_segmentation_model
from mingraph_unet_tpu_torch.experiments.yield_estimation_performance import evaluate_yield_model
from mingraph_unet_tpu_torch.scripts.run_results import write_config_dir
from mingraph_unet_tpu_torch.train.end_to_end import train_end_to_end
from mingraph_unet_tpu_torch.train.segmentation import train_unet_segmentation
from mingraph_unet_tpu_torch.utils.env import setup_host

# Regime calibration (measured by the JAX package's study): the first regime (occlusion 0.75, clutter 5,
# lighting 1.6, label_noise 0.35, 64²) collapsed EVERY arm to all-background
# (mango IoU 0.0000 across the board), which tests nothing. A second regime (clutter 3, noise 0.25, tried
# at both 64² and 96²) ALSO collapsed, for a measurable structural reason:
# argmax eval fires only at p(fruit)>0.5, and with clutter pixel mass ~5%
# vs fruit ~7% plus a ~20% label-noise discount, the Bayes posterior of a
# fruit-COLORED pixel sits just BELOW 0.5 — a color-level learner converges
# to all-background (diagnosed: the trained net predicted 0 foreground
# pixels even on its own train split in train mode, while CE kept falling).
# A FOURTH probe (clutter 2.0/noise 0.15, 96²) showed the deeper failure
# mode: the net sits at the TRIVIAL OPTIMUM — a near-constant p(fruit)
# ≈ 0.2-0.33 field (fruit-pixel p90 0.327 vs background p99 0.350, zero
# pixels above argmax threshold even on the train split), with train CE
# ≈ 0.30 ≈ exactly the constant-class-prior CE. When clutter shares the
# fruit color, the color gradient is too weak to escape the prior trap in
# a 240-step budget; escape then needs shape features that are slower to
# learn than the budget allows. The regime below restores enough color
# signal to escape (clutter 1.5, lighting 1.3, label noise 0.10, lr 2e-3)
# while keeping the causes of degradation (50 % occlusion, clutter FP
# pressure, lighting gradients). Eval GT stays clean (label noise is
# train-only).
HARD_SCENE = dict(
    occlusion_prob=0.5,
    max_fruits=7,
    min_fruits=2,
    lighting_strength=1.3,
    clutter=1.5,
)
HARD_TRAIN_ONLY = dict(label_noise=0.10)

ZERO_GRAPH_LOSSES = dict(
    l_shape_weight=0.0, l_feature_weight=0.0,
    l_partition_weight=0.0, l_smooth_weight=0.0,
)


def main(argv=None):
    """Returns the results dict written to ``value_study.json``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="runs/value_study")
    ap.add_argument("--num_train", type=int, default=320)
    ap.add_argument("--num_val", type=int, default=40)
    ap.add_argument("--num_test", type=int, default=200)
    ap.add_argument("--image_size", type=int, default=64)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=16)
    ap.add_argument("--warmup_epochs", type=int, default=8)
    # At 64² the reference-default 16-px patches give a 4×4 graph whose GT
    # patch labels y_p=(fg frac>0.5) are ALL ZERO for fruit-sized objects —
    # the feature-consistency loss degenerates and the graph branch cannot
    # possibly help. 8-px patches restore fruit-scale graph nodes (8×8 grid).
    ap.add_argument("--patch_size", type=int, default=8)
    # 2e-3 (vs the easy-regime 1e-3): measured escape energy for the
    # trivial-optimum trap on the hard regime (see HARD_SCENE comment).
    ap.add_argument("--lr", type=float, default=2e-3)
    # Calibration gate: if the U-Net baseline's mango IoU lands below this,
    # the regime collapsed again and every further arm would measure
    # nothing — abort with the evidence on disk instead of burning hours.
    ap.add_argument("--require_baseline_iou", type=float, default=0.05)
    ap.add_argument("--eval_images", type=int, default=200)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument(
        "--only", default=None,
        help="comma-separated arm slugs: train/evaluate ONLY these, merging "
        "into the existing outputs/value_study.json rows (for adding arms "
        "to a completed study without retraining it)",
    )
    ap.add_argument(
        "--eval_only", action="store_true",
        help="never train: evaluate every arm that already has a config dir "
        "and a checkpoint, then exit (checkpoint-of-record for a study whose "
        "training runs elsewhere/earlier)",
    )
    ap.add_argument("--results_dir", default="outputs")
    args = ap.parse_args(argv)

    if args.quick:
        args.num_train, args.num_val, args.num_test = 12, 4, 6
        args.image_size, args.batch_size = 64, 2
        args.epochs, args.warmup_epochs, args.eval_images = 2, 1, 4

    device = setup_host(force_cpu=args.cpu)

    out_root = os.path.abspath(args.out)
    data_root = os.path.join(out_root, "data")
    size = (args.image_size, args.image_size)
    t0 = time.time()

    # --- hard-regime dataset (train-only label noise) ---
    marker = os.path.join(data_root, ".complete")
    if not os.path.exists(marker):
        print(f"[study] generating HARD orchard dataset under {data_root} ...")
        generate_orchard_dataset(
            data_root, args.num_train, args.num_val, args.num_test, size,
            train_only_kwargs=HARD_TRAIN_ONLY, **HARD_SCENE,
        )
        with open(marker, "w") as f:
            f.write("ok")

    common = dict(
        data_root=data_root, image_size=size, batch_size=args.batch_size,
        patch_size=args.patch_size, lr=args.lr,
        # Late, gentle decay: the 64² calibration pilots froze all-background
        # when the 0.3× StepLR decay landed mid-run, before the model broke
        # the background symmetry on this hard regime.
        lr_step=max(2, (2 * args.epochs) // 3),
        # The JAX study's scan window (1 on the CPU, 8 on the accelerator),
        # kept so that both studies write the same configs.
        scan_window=1 if args.cpu else 8,
        # Label-noise regime: if any arm ever runs the in-step CC instance
        # proxies (it shouldn't — the study trains with real annotations),
        # speckle components must not crowd the fast form's candidate window.
        instancing="exact",
    )

    def cfg_for(slug, *, epochs, **kw):
        root = os.path.join(out_root, slug)
        return write_config_dir(
            os.path.join(root, "configs"), epochs=epochs,
            ckpt_dir=os.path.join(root, "checkpoints"),
            log_dir=os.path.join(root, "logs"), **common, **kw,
        ), os.path.join(root, "checkpoints")

    # --- incremental results: each arm is trained, evaluated, and flushed
    # to disk immediately (a 1-core CPU study runs for hours; an
    # interruption must leave every completed row on disk, not zero rows).
    test_img_dir = os.path.join(data_root, "test", "images")
    test_ann = os.path.join(data_root, "test", "annotations.json")
    results = {"scene": {**HARD_SCENE, "train_only": HARD_TRAIN_ONLY},
               "config": vars(args), "rows": {}}
    os.makedirs(args.results_dir, exist_ok=True)
    if args.only:
        # Merge mode: keep the completed study's rows, add/replace the named
        # arms only (same data_root, so the regime is identical by construction).
        prev_path = os.path.join(args.results_dir, "value_study.json")
        if os.path.exists(prev_path):
            with open(prev_path) as f:
                prev = json.load(f)
            results["rows"] = prev.get("rows", {})
            if prev.get("blend_sweep"):
                results["blend_sweep"] = prev["blend_sweep"]

    def flush():
        results["wall_clock_sec"] = round(time.time() - t0, 1)
        jpath = os.path.join(args.results_dir, "value_study.json")
        with open(jpath, "w") as f:
            json.dump(results, f, indent=2,
                      default=lambda o: o.tolist() if hasattr(o, "tolist") else float(o))
        with open(os.path.join(args.results_dir, "VALUE_STUDY.md"), "w") as f:
            f.write(render_markdown(results))
        print(f"[study] flushed {len(results['rows'])} rows -> {jpath}")

    def evaluate(slug, cfg, ck, mtype, ablation=None):
        print(f"\n[study] === evaluating {slug} ===")
        row = {"segmentation": evaluate_segmentation_model(cfg, ck, mtype, device=device)}
        if mtype != "unet" and (ablation or {}).get("use_partition", True):
            # The graph branch touching segmentation DIRECTLY (eval-time
            # region-mean logit blending over the trained MinCut partition)
            # instead of only via shared-encoder gradients.
            row["segmentation_refined"] = evaluate_segmentation_model(
                cfg, ck, "mingraph-unet-refined", device=device
            )
            row["cc_counting_refined"] = evaluate_yield_model(
                cfg, ck, model_type="mingraph-unet-refined",
                num_images=args.eval_images, image_dir=test_img_dir,
                ann_file=test_ann, ablation=ablation, device=device,
            )
        row["cc_counting"] = evaluate_yield_model(
            cfg, ck, model_type=("unet" if mtype == "unet" else "mingraph-unet"),
            num_images=args.eval_images, image_dir=test_img_dir,
            ann_file=test_ann, ablation=ablation, device=device,
        )
        if mtype != "unet":
            row["dense_head"] = evaluate_yield_model(
                cfg, ck, model_type="mingraph-unet-dense",
                num_images=args.eval_images, image_dir=test_img_dir,
                ann_file=test_ann, ablation=ablation, device=device,
            )
        results["rows"][slug] = row
        flush()

    def make_twophase_arm(slug, ablation=None, losses=None):
        # Two-phase: seg(+detection)-only warmup, then joint at default λ.
        # Phase A writes λ=0 configs into the SAME checkpoint dir; phase B
        # resumes from A's last epoch with the real λ (resume=True default).
        # ``losses`` overrides phase B's weights only (warmup is all-zero).
        def run():
            root = os.path.join(out_root, slug)
            ckpt_dir = os.path.join(root, "checkpoints")
            cfg_a = write_config_dir(
                os.path.join(root, "configs_warmup"), epochs=args.warmup_epochs,
                ckpt_dir=ckpt_dir, log_dir=os.path.join(root, "logs"),
                use_dense=True, losses=ZERO_GRAPH_LOSSES, ablation=ablation,
                **common,
            )
            print(f"\n[study] === {slug}: warmup (graph losses off) ===")
            train_end_to_end(cfg_a, device=device)
            cfg_b = write_config_dir(
                os.path.join(root, "configs"), epochs=args.epochs,
                ckpt_dir=ckpt_dir, log_dir=os.path.join(root, "logs"),
                use_dense=True, ablation=ablation, losses=losses, **common,
            )
            print(f"[study] === {slug}: joint (resumes warmup checkpoint) ===")
            train_end_to_end(cfg_b, device=device)
            return cfg_b, ckpt_dir
        return run

    train_twophase = make_twophase_arm("full_twophase")

    NO_GRAPH_STAGES = {"use_patch_gat": False, "use_partition": False,
                       "use_region_gat": False}
    NO_FUSION = {"use_fusion": False}

    # Arms in importance order (an interrupted study keeps the rows that
    # carry the headline comparison): baseline → full method → the schedule
    # most likely to fix it → the two attribution controls → the λ sweep.
    def arm_unet():
        cfg, ck = cfg_for("unet", epochs=args.epochs, annotations=False)
        print("\n[study] === U-Net baseline (hard regime) ===")
        train_unet_segmentation(cfg, device=device)
        return cfg, ck

    def arm_full_default():
        cfg, ck = cfg_for("full_default", epochs=args.epochs, use_dense=True)
        print("\n[study] === full MinGraph-UNet, default λ ===")
        train_end_to_end(cfg, device=device)
        return cfg, ck

    def make_e2e_arm(slug, label, **kw):
        def run():
            cfg, ck = cfg_for(slug, epochs=args.epochs, use_dense=True, **kw)
            print(f"\n[study] === {label} ===")
            train_end_to_end(cfg, device=device)
            return cfg, ck
        return run

    arms = [
        ("unet", arm_unet, "unet", None),
        ("full_default", arm_full_default, "mingraph-unet", None),
        ("full_twophase", train_twophase, "mingraph-unet", None),
        ("dense_nofusion",
         make_e2e_arm("dense_nofusion", "dense head without graph fusion",
                      ablation=NO_FUSION),
         "mingraph-unet", NO_FUSION),
        # The CLEAN fusion attribution: under default λ both
        # fusion arms collapse with segmentation, so their tie attributes
        # nothing. The two-phase schedule is the regime where the system
        # trains sanely — pairing it with fusion OFF isolates what the graph
        # features add to the dense head.
        ("nofusion_twophase",
         make_twophase_arm("nofusion_twophase", ablation=NO_FUSION),
         "mingraph-unet", NO_FUSION),
        ("control_nographstages",
         make_e2e_arm("control_nographstages",
                      "control: graph stages ablated, same losses",
                      ablation=NO_GRAPH_STAGES),
         "mingraph-unet", NO_GRAPH_STAGES),
        ("full_lfeat_0.01",
         make_e2e_arm("full_lfeat_0.01", "full method, λ_feature=0.01",
                      losses=dict(l_feature_weight=0.01)),
         "mingraph-unet", None),
        ("full_lfeat_0",
         make_e2e_arm("full_lfeat_0", "full method, λ_feature=0",
                      losses=dict(l_feature_weight=0.0)),
         "mingraph-unet", None),
        # --- the later arms ---
        # Supervised partition: patch-CE on the y_p labels — the lever that
        # could make the partition (and hence the blend mechanism and the
        # fused features) align with fruit.
        ("twophase_psup",
         make_twophase_arm("twophase_psup",
                           losses=dict(l_partition_sup_weight=0.5)),
         "mingraph-unet", None),
        # Principled balancer instead of the schedule: joint-from-cold with
        # Kendall uncertainty weighting over the graph losses. Tests whether
        # learned balancing alone fixes the measured cold-start collapse.
        ("full_uncertainty",
         make_e2e_arm("full_uncertainty",
                      "full method, uncertainty-weighted graph losses",
                      loss_balance="uncertainty"),
         "mingraph-unet", None),
        # Attribution control for the psup win: supervised partition with
        # fusion OFF. If this ties twophase_psup, the gain is the psup
        # loss's shared-encoder gradient (deep supervision), not the graph
        # features the dense head consumes through fusion.
        ("twophase_psup_nofusion",
         make_twophase_arm("twophase_psup_nofusion",
                           losses=dict(l_partition_sup_weight=0.5),
                           ablation=NO_FUSION),
         "mingraph-unet", NO_FUSION),
        # λ_partition/λ_smooth grid under the trainable (two-phase) regime.
        ("twophase_lgrid_low",
         make_twophase_arm("twophase_lgrid_low",
                           losses=dict(l_partition_weight=0.1,
                                       l_smooth_weight=0.05)),
         "mingraph-unet", None),
        ("twophase_lgrid_hi",
         make_twophase_arm("twophase_lgrid_hi",
                           losses=dict(l_partition_weight=1.0)),
         "mingraph-unet", None),
    ]
    def blend_sweep():
        # γ/purity envelope of the region-blend mechanism (an earlier study
        # evaluated one untuned operating point, γ=0.5 ungated, which
        # zeroed mango IoU). Eval-only — reuses trained checkpoints.
        points = [
            ("γ=0.05", 0.05, None), ("γ=0.1", 0.1, None),
            ("γ=0.2", 0.2, None), ("γ=0.5", 0.5, None),
            ("γ=0.2, τ=0.01", 0.2, 0.01), ("γ=0.2, τ=0.03", 0.2, 0.03),
            ("γ=0.5, τ=0.01", 0.5, 0.01), ("γ=0.5, τ=0.03", 0.5, 0.03),
        ]
        sweep = results.setdefault("blend_sweep", {})
        for slug in ("full_twophase", "twophase_psup"):
            cfg = os.path.join(out_root, slug, "configs")
            ck = os.path.join(out_root, slug, "checkpoints")
            if not (os.path.isdir(cfg) and os.path.isdir(ck) and os.listdir(ck)):
                print(f"[study] blend sweep: no checkpoint for {slug}, skipping")
                continue
            arm_sweep = sweep.setdefault(slug, {})
            for label, g, tau in points:
                if label in arm_sweep and "error" not in arm_sweep[label]:
                    continue
                print(f"\n[study] === blend sweep {slug} @ {label} ===")
                try:
                    arm_sweep[label] = evaluate_segmentation_model(
                        cfg, ck, "mingraph-unet-refined",
                        blend_gamma=g, blend_purity_tau=tau, device=device,
                    )
                except Exception as e:  # pragma: no cover - hardware-path guard
                    import traceback
                    traceback.print_exc()
                    arm_sweep[label] = {"error": f"{type(e).__name__}: {e}"}
                flush()

    only = set(args.only.split(",")) if args.only else None
    for slug, train_fn, mtype, ablation in arms:
        if only is not None and slug not in only:
            continue
        try:
            if args.eval_only:
                cfg = os.path.join(out_root, slug, "configs")
                ck = os.path.join(out_root, slug, "checkpoints")
                if not (os.path.isdir(cfg) and os.path.isdir(ck) and os.listdir(ck)):
                    print(f"[study] eval_only: no checkpoint for {slug}, skipping")
                    continue
            else:
                cfg, ck = train_fn()
            evaluate(slug, cfg, ck, mtype, ablation)
        except Exception as e:  # one broken arm must not kill the study
            import traceback
            traceback.print_exc()
            results["rows"][slug] = {"error": f"{type(e).__name__}: {e}"}
            flush()
        if (slug == "unet" and not args.eval_only
                and "segmentation" in results["rows"].get("unet", {})):
            iou = results["rows"]["unet"]["segmentation"]["iou_per_class"]
            mango = iou[1] if len(iou) > 1 else 0.0
            if mango < args.require_baseline_iou:
                msg = (f"baseline collapsed (mango IoU {mango:.4f} < "
                       f"{args.require_baseline_iou}): regime tests nothing, "
                       "aborting before the expensive arms")
                print(f"[study] ABORT: {msg}")
                results["aborted"] = msg
                flush()
                return results
    blend_sweep()
    return results


def seg_cells(row):
    seg = row["segmentation"]
    iou = seg.get("iou_per_class", [float("nan")] * 2)
    mango = iou[1] if len(iou) > 1 else float("nan")
    return f"{seg.get('mean_iou', float('nan')):.4f} | {mango:.4f}"


def yield_cells(r):
    if not r:
        return "— | — | —"
    return (f"{r.get('count_accuracy_perc', float('nan')):.2f} | "
            f"{r.get('yield_estimation_error_perc', float('nan')):.2f} | "
            f"{r.get('ap50_perc', float('nan')):.2f}")


LABELS = {
    "unet": "U-Net baseline (CE+dice only)",
    "full_default": "Full method, default λ",
    "full_twophase": "Full method, two-phase (seg warmup → joint)",
    "full_lfeat_0.01": "Full method, λ_feature=0.01",
    "full_lfeat_0": "Full method, λ_feature=0",
    "control_nographstages": "Control: graph stages OFF, same L_total",
    "dense_nofusion": "Full method, fusion OFF (dense head sees F_u only)",
    "nofusion_twophase": "Two-phase, fusion OFF (the clean fusion attribution)",
    "twophase_psup": "Two-phase + supervised partition (patch-CE on y_p)",
    "twophase_psup_nofusion": "Two-phase + supervised partition, fusion OFF",
    "full_uncertainty": "Full method, uncertainty-weighted graph losses (joint from cold)",
    "twophase_lgrid_low": "Two-phase, λ_partition=0.1 λ_smooth=0.05",
    "twophase_lgrid_hi": "Two-phase, λ_partition=1.0",
}


def render_markdown(results):
    cfg = results["config"]
    sc = results.get("scene", {})
    noise = sc.get("train_only", {}).get("label_noise", 0)
    lines = [
        "# VALUE STUDY — does the graph branch earn its FLOPs?",
        "",
        "Hard synthetic regime (fruit-colored clutter ×"
        f"{sc.get('clutter', '?')}, lighting gradients ×"
        f"{sc.get('lighting_strength', '?')}, "
        f"{100 * sc.get('occlusion_prob', 0):.0f} % leaf occlusion, "
        f"{sc.get('min_fruits', '?')}-{sc.get('max_fruits', '?')} fruits, "
        f"**train-only label noise {noise}** — eval "
        f"GT clean), {cfg['num_train']} train / {cfg['num_test']} test at "
        f"{cfg['image_size']}², graph patch size "
        f"{cfg.get('patch_size', 16)} px, every model {cfg['epochs']} epochs "
        f"batch {cfg['batch_size']} (two-phase: {cfg['warmup_epochs']} warmup "
        "+ joint). All rows reported — no selection. Metrics are the "
        "reference's exactly.",
        "",
        "| Model | mIoU | Mango IoU | CC count acc. (%) | CC yield err. (%) | CC AP@0.5 (%) |",
        "|---|---|---|---|---|---|",
    ]
    for slug, row in results["rows"].items():
        if "error" in row:
            lines.append(f"| {LABELS.get(slug, slug)} | failed: {row['error']} |||||")
            continue
        lines.append(
            f"| {LABELS.get(slug, slug)} | {seg_cells(row)} | "
            f"{yield_cells(row.get('cc_counting'))} |"
        )
        if "segmentation_refined" in row:
            lines.append(
                f"| &nbsp;&nbsp;↳ + graph-refined eval (region-mean logit blend) | "
                f"{seg_cells({'segmentation': row['segmentation_refined']})} | "
                f"{yield_cells(row.get('cc_counting_refined'))} |"
            )
    lines += [
        "",
        "## Dense-head counting (the fusion-attribution pair)",
        "",
        "| Model | Count acc. (%) | Yield err. (%) | AP@0.5 (%) |",
        "|---|---|---|---|",
    ]
    for slug, row in results["rows"].items():
        if "dense_head" in row:
            lines.append(f"| {LABELS.get(slug, slug)} | {yield_cells(row['dense_head'])} |")
    base = results["rows"].get("unet", {})
    if "segmentation" in base:
        b_iou = (base["segmentation"].get("iou_per_class") or [float("nan")] * 2)[1]
        b_cnt = (base.get("cc_counting") or {}).get(
            "count_accuracy_perc", float("nan"))
        lines += [
            "",
            "## Verdict vs the U-Net baseline",
            "",
            f"Baseline: mango IoU {b_iou:.4f}, CC count accuracy {b_cnt:.2f} %."
            " Positive deltas mean the graph machinery ADDS value; the"
            " refined sub-rows additionally apply the partition at eval time.",
            "",
            "| Arm | Δ mango IoU | Δ count acc. (pts) |",
            "|---|---|---|",
        ]
        for slug, row in results["rows"].items():
            if slug == "unet" or "segmentation" not in row:
                continue
            for label_suffix, seg, cnt in (
                ("", row.get("segmentation"), row.get("cc_counting")),
                (" + refined eval", row.get("segmentation_refined"),
                 row.get("cc_counting_refined")),
            ):
                if not seg:
                    continue
                iou = (seg.get("iou_per_class") or [float("nan")] * 2)[1]
                cr = (cnt or {}).get("count_accuracy_perc", float("nan"))
                d_iou, d_cnt = iou - b_iou, cr - b_cnt
                # Bold each delta cell independently, only when THAT delta
                # is positive (a shared mark previously bolded negative IoU
                # deltas whenever the count delta happened to be positive).
                iou_cell = f"**{d_iou:+.4f}**" if d_iou > 0 else f"{d_iou:+.4f}"
                cnt_cell = f"**{d_cnt:+.2f}**" if d_cnt > 0 else f"{d_cnt:+.2f}"
                lines.append(
                    f"| {LABELS.get(slug, slug)}{label_suffix} | "
                    f"{iou_cell} | {cnt_cell} |"
                )
    if "cc_counting" in base:
        # The SYSTEM comparison on the reference's end task (yield
        # estimation): the plain U-Net's only detector is CC instancing
        # over its segmentation; the full architecture's detector is the
        # graph-fused dense head. Count accuracy alone hides detection
        # quality — matching, occlusion robustness and AP@0.5 are where
        # per-fruit detection (vs blob counting) shows up.
        bc = base["cc_counting"]
        nan = float("nan")
        sys_keys = ("count_accuracy_perc", "object_matching_rate_perc",
                    "occlusion_robustness_perc", "ap50_perc")
        lines += [
            "",
            "## System verdict on the end task (yield estimation)",
            "",
            "| System | Detector | Count acc. (%) | Matching (%) | "
            "Occlusion robustness (%) | AP@0.5 (%) |",
            "|---|---|---|---|---|---|",
            "| U-Net baseline | CC over segmentation | "
            + " | ".join(f"{bc.get(k, nan):.2f}" for k in sys_keys) + " |",
        ]
        for slug, row in results["rows"].items():
            dh = row.get("dense_head")
            if not dh:
                continue
            cells = [dh.get(k, nan) for k in sys_keys]
            bases = [bc.get(k, nan) for k in sys_keys]
            body = " | ".join(
                (f"**{c:.2f}**" if c > b else f"{c:.2f}")
                for c, b in zip(cells, bases)
            )
            det = ("dense head (fusion OFF)" if "nofusion" in slug
                   else "graph-fused dense head")
            lines.append(f"| {LABELS.get(slug, slug)} | {det} | {body} |")
    if results.get("blend_sweep"):
        lines += [
            "",
            "## Blend-mechanism envelope (γ × purity gate, eval-time)",
            "",
            "The r4 study evaluated the region-blend mechanism at ONE "
            "untuned operating point (γ=0.5, ungated). This sweep maps its "
            "envelope on the trained checkpoints: γ scales the region-mean "
            "contribution; τ gates blending to regions whose foreground-"
            "probability variance is below τ (pure regions only).",
        ]
        for slug, arm_sweep in results["blend_sweep"].items():
            base_seg = results["rows"].get(slug, {}).get("segmentation")
            lines += [
                "", f"### {LABELS.get(slug, slug)}", "",
                "| Operating point | mIoU | Mango IoU |", "|---|---|---|",
            ]
            if base_seg:
                lines.append(
                    f"| unrefined (γ=0) | {seg_cells({'segmentation': base_seg})} |"
                )
            for label, m in arm_sweep.items():
                if "error" in m:
                    lines.append(f"| {label} | failed: {m['error']} ||")
                else:
                    lines.append(f"| {label} | {seg_cells({'segmentation': m})} |")
    # Diagnosis numbers are interpolated from the results dict (not
    # hardcoded) so a re-run with a different seed/config regenerates a
    # self-consistent document. The NARRATIVE was written against the
    # 2026-08 runs; the numbers always match the tables above.
    nan = float("nan")

    def mango(slug, key="segmentation"):
        seg = results["rows"].get(slug, {}).get(key) or {}
        iou = seg.get("iou_per_class") or [nan, nan]
        return iou[1] if len(iou) > 1 else nan

    def sysm(slug, metric, key="dense_head"):
        return (results["rows"].get(slug, {}).get(key) or {}).get(metric, nan)

    tp, nf = "full_twophase", "nofusion_twophase"
    ps, psnf = "twophase_psup", "twophase_psup_nofusion"
    b_match = sysm("unet", "object_matching_rate_perc", "cc_counting")
    b_occl = sysm("unet", "occlusion_robustness_perc", "cc_counting")
    b_ap = sysm("unet", "ap50_perc", "cc_counting")
    b_cntacc = sysm("unet", "count_accuracy_perc", "cc_counting")
    refined_best = max(
        (mango(s, "segmentation_refined") for s in results["rows"]
         if "segmentation_refined" in results["rows"][s]),
        default=nan,
    )

    def sweep_best(slug):
        pts = (results.get("blend_sweep") or {}).get(slug) or {}
        vals = [((m.get("iou_per_class") or [nan, nan])[1], label)
                for label, m in pts.items() if "error" not in m]
        return max(vals, default=(nan, "—"))
    lines += [
        "",
        "## Diagnosis (numbers interpolated from this run's tables)",
        "",
        "1. **Segmentation: the graph losses subtract, and scheduling — not "
        "λ — is the rescue.** Joint training from cold collapses "
        f"(mango IoU {mango('full_default'):.4f} at default λ) while the "
        f"CE+dice U-Net reaches {mango('unet'):.4f} on the same regime; "
        "removing L_feature entirely (λ_feature=0) still loses "
        f"({mango('full_lfeat_0'):.4f}), and the no-graph-stages control "
        f"with the same L_total also degrades "
        f"({mango('control_nographstages'):.4f}) — so the interference is "
        "the multi-loss cold-start itself (H3), not any single λ (H2). The "
        "two-phase schedule (seg-only warmup → joint) recovers most of it "
        f"({mango(tp):.4f}/{mango(nf):.4f}).",
        "2. **The end task is where the architecture pays: detection "
        "quality, not mask quality.** As a yield SYSTEM, the two-phase "
        "full method vs the U-Net baseline: matching "
        f"{sysm(tp, 'object_matching_rate_perc'):.2f} vs {b_match:.2f} %, "
        "occlusion robustness "
        f"{sysm(tp, 'occlusion_robustness_perc'):.2f} vs {b_occl:.2f} %, "
        f"AP@0.5 {sysm(tp, 'ap50_perc'):.2f} vs {b_ap:.2f} %: per-fruit "
        "detection separates touching fruit that CC blob-counting merges. "
        "Count accuracy alone hides this "
        f"({sysm(tp, 'count_accuracy_perc'):.2f} vs {b_cntacc:.2f} % — "
        "blob counts are right for the wrong instances).",
        "3. **Fusion attribution: the graph features are NOT the "
        "ingredient.** The clean pair (two-phase, fusion ON vs OFF) ties "
        f"within noise — AP@0.5 {sysm(tp, 'ap50_perc'):.2f} vs "
        f"{sysm(nf, 'ap50_perc'):.2f}, occlusion "
        f"{sysm(tp, 'occlusion_robustness_perc'):.2f} vs "
        f"{sysm(nf, 'occlusion_robustness_perc'):.2f} — so the detection "
        "win comes from the dense head trained under the multi-task "
        "losses, not from the GAT/partition features it fuses. The graph "
        "branch's mechanisms that DO act on outputs (region-mean logit "
        "blending over the trained partition) destroy segmentation at the "
        f"r4 operating point (best refined mango IoU {refined_best:.4f} "
        "across arms): at 64²/8-px patches the learned partition does not "
        "align with fruit boundaries.",
        "4. **r5: SUPERVISING the partition makes the graph pay.** "
        "Patch-CE on the y_p labels (pinning MinCut region 1 to fruit) is "
        "the best full-method arm on every metric: mango IoU "
        f"{mango(ps):.4f} (vs {mango(tp):.4f} for its own no-psup "
        "ablation at the identical schedule/budget), dense-head AP@0.5 "
        f"{sysm(ps, 'ap50_perc'):.2f} vs {sysm(tp, 'ap50_perc'):.2f}, "
        f"matching {sysm(ps, 'object_matching_rate_perc'):.2f} vs "
        f"{sysm(tp, 'object_matching_rate_perc'):.2f}, occlusion "
        f"{sysm(ps, 'occlusion_robustness_perc'):.2f} vs "
        f"{sysm(tp, 'occlusion_robustness_perc'):.2f}, count accuracy "
        f"{sysm(ps, 'count_accuracy_perc'):.2f} vs "
        f"{sysm(tp, 'count_accuracy_perc'):.2f} — a GRAPH mechanism "
        "beating its own ablation well beyond the fusion pair's noise "
        "band. The fusion-OFF control "
        f"(AP@0.5 {sysm(psnf, 'ap50_perc'):.2f}, mango "
        f"{mango(psnf):.4f}) attributes the gain to the FUSED graph "
        "features, not the psup loss's shared-encoder gradient: without "
        "fusion the supervised-partition arm falls back to plain-two-"
        "phase territory, so — unlike the unsupervised pair's tie in "
        "point 3 — the graph features now carry real signal. The "
        "λ grid agrees directionally: λ_partition at 0.1 or 1.0 (vs the "
        "default 0.5) also beats plain two-phase "
        f"(AP {sysm('twophase_lgrid_low', 'ap50_perc'):.2f} / "
        f"{sysm('twophase_lgrid_hi', 'ap50_perc'):.2f} vs "
        f"{sysm(tp, 'ap50_perc'):.2f}) — the unsupervised Ncut at the "
        "reference-default weight is mis-calibrated on this regime.",
        "5. **r5: the balancers and the blend envelope.** Kendall "
        "uncertainty weighting from cold does NOT replace the schedule "
        f"(mango IoU {mango('full_uncertainty'):.4f} — the collapse "
        "happens before the learned weights can adapt), confirming the "
        "cold-start diagnosis. The region-blend mechanism swept over "
        "γ × purity-gating is bounded ≤ 0 on BOTH partitions: best "
        f"full_twophase point {sweep_best(tp)[0]:.4f} "
        f"({sweep_best(tp)[1]}) vs {mango(tp):.4f} unrefined; best "
        f"supervised-partition point {sweep_best(ps)[0]:.4f} "
        f"({sweep_best(ps)[1]}) vs {mango(ps):.4f} unrefined — purity "
        "gating recovers nearly all of the γ=0.5 damage but never adds. "
        "The partition's value is as a supervised feature/training "
        "signal, not as an output-space smoother.",
        "6. **Net: the reference architecture's premise — graph "
        "refinement improving segmentation/counting — holds on this "
        "regime ONLY with the framework-added supervision of the "
        "partition; unsupervised, the graph losses subtract and the "
        "blend mechanism is a swept, bounded negative.** The "
        "paper-quoted targets (reference:experiments/metrics.py:188-192 "
        "— 95.3 % count accuracy, 5.9 % yield error) remain unreproduced "
        "on mask IoU in either framework's favor; the supervised-"
        f"partition count accuracy ({sysm(ps, 'count_accuracy_perc'):.2f}"
        " %) is the closest any arm has come on this hard regime.",
        "",
        "## Regime calibration (reported for honesty)",
        "",
        "The first regime attempted (occlusion 0.75, clutter 5, lighting ×1.6, "
        "train label noise 0.35, 64², 16-px patches) collapsed EVERY arm — "
        "baseline and full method alike — to all-background (mango IoU 0.0000): "
        "too hard to discriminate anything, so it tests nothing. Two "
        "calibration pilots later, the regime above is the hardest tried where "
        "the plain U-Net still trains (its mango IoU is well below the easy "
        "regime's 0.99 — the degradation H1 needs). Patch size is 8 px here "
        "because at 64² the reference-default 16-px patches leave a 4×4 graph "
        "whose GT patch labels y_p=(foreground fraction>0.5) are all zero for "
        "fruit-sized objects — the feature-consistency loss degenerates and "
        "the graph branch cannot possibly help at any λ.",
        "",
        f"Total wall clock: {results['wall_clock_sec']} s.", "",
    ]
    return "\n".join(lines)


if __name__ == "__main__":
    main()
