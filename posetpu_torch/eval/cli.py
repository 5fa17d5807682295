"""Offline evaluation command line — the counterpart of
``posetpu/eval/cli.py``: restore a run's latest (or ``--best``)
checkpoint, run the validation split, report PCKh@0.5 (MPII) or PCK@0.2
(LSP), and write ``preds.mat``.

Head sizes: the official MPII protocol normalizes by 0.6 x the annotated
head rectangle's diagonal; where an annotation has no head box (the bearpaw
JSON), 1.2 x |head_top - upper_neck| from the keypoints stands in.

    posetpu-torch-eval --config hg2_mpii_mini --checkpoint DIR [--best]
        [--synthetic] [--cpu] [--blocks N] [--scan-stacks]

The network is built as the train command built it: pass the run's
``--stacks``, ``--features``, ``--blocks`` and ``--scan-stacks``.

(or ``python -m posetpu_torch.eval.cli``).  Runs on CUDA unless ``--cpu``,
in one process: a data-parallel config's ``num_devices`` is not read.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from posetpu_torch.configs import add_overrides, apply_overrides, named_config
from posetpu_torch.eval.export import save_preds
from posetpu_torch.eval.pck import pck_lsp, pckh


def head_sizes_from_pts(gts, dataset="mpii"):
    if dataset == "mpii":
        seg = np.linalg.norm(gts[:, 9] - gts[:, 8], axis=-1)  # head-top..neck
    else:
        seg = np.linalg.norm(gts[:, 13] - gts[:, 12], axis=-1)
    return np.maximum(seg * 1.2, 1.0)


def head_sizes(val_ds, gts, dataset="mpii"):
    """Per-sample PCKh normalizers: the official 0.6 x head-box diagonal
    where the annotation has a head rectangle, the keypoint stand-in
    elsewhere."""
    fallback = head_sizes_from_pts(gts, dataset)
    out = fallback.copy()
    n_official = 0
    for i in range(len(gts)):
        h = val_ds.head_size(i)
        if h is not None:
            out[i] = max(h, 1.0)
            n_official += 1
    if 0 < n_official < len(gts):
        print(
            f"[eval] head sizes: {n_official}/{len(gts)} official head "
            f"boxes, rest keypoint-approximated"
        )
    return out


def main(argv=None):
    """Returns the headline PCK (percent)."""
    ap = argparse.ArgumentParser(prog="posetpu-torch-eval")
    ap.add_argument("--config", default="hg2_mpii_mini")
    ap.add_argument("--best", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    add_overrides(ap)
    args = ap.parse_args(argv)

    from posetpu_torch.train.loop import Experiment

    cfg = apply_overrides(named_config(args.config), args)
    cfg.resume = ""  # restored below
    cfg.num_devices = None  # one process evaluates
    exp = Experiment(cfg, eval_only=True, device="cpu" if args.cpu else "cuda")
    try:
        path = exp.ckpt.best_path if args.best else None
        exp.state, epoch, best = exp.ckpt.restore(exp.state, path)
        print(f"[eval] restored epoch {epoch} (best_acc {best:.4f})")
        metrics, preds = exp.validate(epoch)
    finally:
        exp.close()
    n = len(preds)
    gts = np.stack([exp.val_ds.meta(i)[2] for i in range(n)])
    vis = np.stack([exp.val_ds.meta(i)[3] for i in range(n)])
    if cfg.aug.dataset == "lsp":
        mean_pck, per_joint = pck_lsp(preds, gts, vis)
        label = "PCK@0.2"
    else:
        heads = head_sizes(exp.val_ds, gts, "mpii")
        mean_pck, per_joint = pckh(preds, gts, heads, vis)
        label = "PCKh@0.5"
    out = os.path.join(cfg.checkpoint_dir, cfg.name, "preds.mat")
    save_preds(preds, out)
    print(f"[eval] val loss {metrics['loss']:.5f} acc {metrics['acc']:.4f}")
    print(f"[eval] {label} = {mean_pck:.2f}")
    print(
        "[eval] per-joint:",
        " ".join(f"{p:.1f}" for p in np.nan_to_num(per_joint)),
    )
    print(f"[eval] preds saved to {out}")
    return mean_pck


def entry(argv=None) -> int:
    """Console-script wrapper: ``main`` returns the PCK, a float, which
    ``sys.exit`` would print and turn into exit status 1."""
    main(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(entry())
