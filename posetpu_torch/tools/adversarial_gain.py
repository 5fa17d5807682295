"""The adversarial-gain protocol — the counterpart of
``tools/adversarial_gain.py``, the method's own claim: under an equal
epoch budget from the same phase-1 weights, the adversarial recipe (the
ASR scale/rotation agent with body-part AHO occlusion) should hold or beat
the baseline random-augmentation recipe on a hard validation split it
never saw (wider person scales, occluder patches over joints, a bones-only
distractor figure: ``make_synthetic_dataset(hard_val=True)``).  Both arms
train on the standard synthetic renderings, so a gap on that split is
robustness, not fitting the perturbations.

Protocol (every arm shares seed, data and schedule):
  phase 1   baseline augmentation, E1 epochs, from scratch
  arm A     baseline augmentation, E2 epochs, from phase 1's best, lr/4
  arm B     adversarial,           E2 epochs, from phase 1's best, lr/4
  report    best validation PCK (train-time) and the final PCKh@0.5 of
            each arm's best checkpoint on the hard split; each arm's
            curves are in its run directory (log.txt).

    python -m posetpu_torch.tools.adversarial_gain [--out DIR]
        [--epochs1 N] [--epochs2 N] [--stacks N] [--feats N] [--res N]
        [--batch N] [--num-train N] [--num-val N] [--seed N]
        [--skip-phase1] [--skip-arm-a] [--arm-b-tag T] [--no-occlusion]
        [--pose-ref-weight W] [--cpu] [--quick]

Runs on CUDA unless ``--cpu``; every arm trains and validates through
:class:`posetpu_torch.train.loop.Experiment` (on CUDA its train step and
its validation step are CUDA graphs).  Writes ``<out>/result.json`` (or
``result_<tag>.json``) with the JAX tool's fields; a ``--quick`` run adds
``scored`` for an arm it scored from its latest checkpoint
(:func:`scored_checkpoint`).
"""

from __future__ import annotations

import argparse
import json
import os


def build_cfg(name, ann, imgs, out_dir, args, *, adversarial, init_from=""):
    """An arm's config: hg2_mpii_mini at the study's widths, on the split
    at ``ann``/``imgs``, its run directory ``<out_dir>/<name>``."""
    from posetpu_torch.configs import named_config

    cfg = named_config("hg2_mpii_mini")
    cfg.name = name
    cfg.model.stacks = args.stacks
    cfg.model.feats = args.feats
    cfg.aug.inp_res = (args.res, args.res)
    cfg.aug.out_res = (args.res // 4, args.res // 4)
    cfg.batch_size = args.batch
    cfg.synthetic = False
    cfg.annotations = ann
    cfg.images_dir = imgs
    cfg.checkpoint_dir = out_dir
    cfg.num_devices = 1
    cfg.seed = args.seed
    if init_from:
        cfg.init_pose_from = init_from
        cfg.optim.lr = 2.5e-4 / 4  # phase 2's fine-tune learning rate
        cfg.optim.epochs = args.epochs2
        cfg.optim.schedule = (int(args.epochs2 * 0.7),)
    else:
        cfg.optim.epochs = args.epochs1
        cfg.optim.schedule = (
            int(args.epochs1 * 0.65),
            int(args.epochs1 * 0.85),
        )
    if adversarial:
        cfg.agent.enabled = True
        if not getattr(args, "no_occlusion", False):
            cfg.agent.occ_mode = "parts"
            cfg.agent.occ_nodes = 9  # 1 + sum(PART_GROUPS["mpii"] levels)
        cfg.agent.pose_ref_weight = args.pose_ref_weight
    return cfg


def scored_checkpoint(exp, quick):
    """(path, which) of the checkpoint an arm is scored from: its ``best/``,
    as the JAX tool reads it.  An arm that never wrote one (its validation
    never rose above its first reading of 0) ends the run, as it does in
    the JAX tool, unless ``quick``: a smoke run then scores its latest
    checkpoint (path None) and ``result.json`` says so under ``scored``."""
    best = exp.ckpt.best_path
    if os.path.isdir(best):
        return best, "best"
    if not quick:
        raise SystemExit(
            f"[adv-gain] {exp.ckpt.directory} holds no best/ checkpoint: the "
            "arm's validation never improved, so it has no best checkpoint to "
            "score (--quick would score its latest instead)"
        )
    return None, "latest"


def run_arm(cfg, progress, device, quick, skip=False):
    """(experiment, best validation PCK) of an arm: trained, or with
    ``skip`` its best checkpoint (:func:`scored_checkpoint`) reloaded from
    an earlier run (phase 1 and arm A are deterministic for a seed);
    ``eval_only`` keeps the reloaded arm's files as they are."""
    from posetpu_torch.train.loop import Experiment

    if skip:
        exp = Experiment(cfg, eval_only=True, device=device)
        exp.state, _, best = exp.ckpt.restore(exp.state, scored_checkpoint(exp, quick)[0])
        return exp, float(best)
    exp = Experiment(cfg, device=device)
    _, best = exp.fit(progress=progress)
    return exp, best


def final_pckh(exp, quick):
    """(PCKh@0.5, validation PCK, which checkpoint) of the arm's best
    checkpoint (:func:`scored_checkpoint`) on the hard split (keypoint head
    sizes, as the JAX tool takes them)."""
    import numpy as np

    from posetpu_torch.eval.cli import head_sizes_from_pts
    from posetpu_torch.eval.pck import pckh

    path, which = scored_checkpoint(exp, quick)
    exp.state, epoch, _ = exp.ckpt.restore(exp.state, path)
    metrics, preds = exp.validate(epoch)
    n = len(preds)
    gts = np.stack([exp.val_ds.meta(i)[2] for i in range(n)])
    vis = np.stack([exp.val_ds.meta(i)[3] for i in range(n)])
    heads = head_sizes_from_pts(gts, "mpii")
    mean_pck, _ = pckh(preds, gts, heads, vis)
    return float(mean_pck), float(metrics["acc"]), which


def trained_epochs(run_dir):
    """Rows of an arm's log.txt, its header aside."""
    with open(os.path.join(run_dir, "log.txt")) as f:
        return sum(1 for _ in f) - 1


def main(argv=None):
    """Returns the result written to ``result.json``."""
    ap = argparse.ArgumentParser(prog="python -m posetpu_torch.tools.adversarial_gain")
    ap.add_argument("--out", default="checkpoints/adversarial_gain")
    ap.add_argument("--epochs1", type=int, default=40)
    ap.add_argument("--epochs2", type=int, default=20)
    ap.add_argument("--stacks", type=int, default=2)
    ap.add_argument("--feats", type=int, default=128)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--num-train", type=int, default=96)
    ap.add_argument("--num-val", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-phase1", action="store_true",
                    help="reuse <out>/phase1 from an earlier run (deterministic)")
    ap.add_argument("--skip-arm-a", action="store_true",
                    help="reuse <out>/armA_baseline from an earlier run")
    ap.add_argument("--arm-b-tag", default="",
                    help="suffix of arm B's directory and result file (a sweep)")
    ap.add_argument("--no-occlusion", action="store_true",
                    help="arm B: the scale/rotation agent only (no AHO occlusion)")
    ap.add_argument(
        "--pose-ref-weight", type=float, default=0.0,
        help="arm B: weight of the reference crops in the pose update (0: the "
        "pose network trains on the adversarial crops only)",
    )
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="tiny shapes for a smoke run (CPU-safe)")
    args = ap.parse_args(argv)
    if args.quick:
        args.epochs1, args.epochs2 = 2, 2
        args.stacks, args.feats, args.res = 1, 16, 64
        args.num_train, args.num_val, args.batch = 16, 8, 8

    from posetpu_torch.data import make_synthetic_dataset
    from posetpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    root = os.path.join(args.out, "data")
    ann = os.path.join(root, "annotations.json")
    meta_path = os.path.join(root, "meta.json")
    data_meta = {
        "seed": args.seed,
        "num_train": args.num_train,
        "num_val": args.num_val,
        "hard_val": True,
    }
    if not os.path.exists(ann):
        make_synthetic_dataset(
            root,
            num_train=args.num_train,
            num_val=args.num_val,
            res=(320, 240),
            seed=args.seed,
            hard_val=True,
        )
        with open(meta_path, "w") as f:
            json.dump(data_meta, f)
    elif os.path.exists(meta_path):
        # a split made earlier: the arguments must describe the same data,
        # or result.json would misstate what the study ran on
        with open(meta_path) as f:
            prev = json.load(f)
        if prev != data_meta:
            raise SystemExit(
                f"[adv-gain] {root} holds a split made with {prev}, but this "
                f"invocation says {data_meta}: pick a fresh --out or match "
                "the arguments that made it"
            )
    imgs = os.path.join(root, "images")

    def log(s):
        print(f"[adv-gain] {s}", flush=True)

    log(f"phase 1: baseline, {args.epochs1} epochs"
        + (" [skip: reuse]" if args.skip_phase1 else ""))
    cfg1 = build_cfg("phase1", ann, imgs, args.out, args, adversarial=False)
    exp1, best1 = run_arm(cfg1, log, device, args.quick, skip=args.skip_phase1)
    exp1.close()
    p1_dir = os.path.join(args.out, "phase1")
    log(f"phase 1 best val acc {best1:.4f}")

    log(f"arm A: baseline fine-tune, {args.epochs2} epochs"
        + (" [skip: reuse]" if args.skip_arm_a else ""))
    if args.skip_arm_a:
        # equal budget: the reused arm must have trained the epochs that
        # this sweep's arm B is about to get
        trained = trained_epochs(os.path.join(args.out, "armA_baseline"))
        if trained != args.epochs2:
            raise SystemExit(
                f"[adv-gain] the reused arm A trained {trained} epochs but "
                f"--epochs2 is {args.epochs2}: the arms would not have an "
                "equal budget; train arm A again or match --epochs2"
            )
    cfgA = build_cfg(
        "armA_baseline", ann, imgs, args.out, args,
        adversarial=False, init_from=p1_dir,
    )
    expA, bestA = run_arm(cfgA, log, device, args.quick, skip=args.skip_arm_a)
    pckhA, accA, scoredA = final_pckh(expA, args.quick)
    expA.close()

    arm_b = "armB_adversarial" + (f"_{args.arm_b_tag}" if args.arm_b_tag else "")
    log(f"arm B ({arm_b}): adversarial fine-tune, {args.epochs2} epochs")
    cfgB = build_cfg(
        arm_b, ann, imgs, args.out, args,
        adversarial=True, init_from=p1_dir,
    )
    expB, bestB = run_arm(cfgB, log, device, args.quick)
    pckhB, accB, scoredB = final_pckh(expB, args.quick)
    expB.close()

    result = {
        "phase1_best_acc": float(best1),
        "armA_baseline": {"best_acc": float(bestA), "pckh": pckhA, "acc": accA},
        "armB_adversarial": {"best_acc": float(bestB), "pckh": pckhB, "acc": accB},
        "pckh_gain": pckhB - pckhA,
        "epochs": [args.epochs1, args.epochs2],
        "hard_val": True,
        "pose_ref_weight": args.pose_ref_weight,
        "occlusion": not args.no_occlusion,
        "seed": args.seed,
        "reused_phase1": args.skip_phase1,
        "reused_arm_a": args.skip_arm_a,
    }
    scored = {arm: which for arm, which in (("armA_baseline", scoredA),
                                             ("armB_adversarial", scoredB))
              if which != "best"}
    if scored:  # only a --quick run gets here
        result["scored"] = scored
    out_json = os.path.join(
        args.out,
        f"result_{args.arm_b_tag}.json" if args.arm_b_tag else "result.json",
    )
    with open(out_json, "w") as f:
        json.dump(result, f, indent=2)
    log(f"hard-val PCKh@0.5: baseline {pckhA:.2f} vs adversarial {pckhB:.2f} "
        f"(gain {pckhB - pckhA:+.2f}); details in {out_json}")
    return result


if __name__ == "__main__":
    main()
