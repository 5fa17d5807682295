"""Model, augmentation and optimizer configuration, and the named configs
the port runs so far — the port's own copy of
``posetpu/configs/config.py`` (``ModelConfig``, ``AugConfig``,
``OptimConfig``, ``AgentConfig`` and the ``hg2_mpii_mini``, ``hg8_mpii``,
``hg8_mpii_asr``, ``hg8_lsp_aho`` and ``hg8_mpii_384_dp8`` entries of
``named_config``).

Only the fields the ported slices read are here.  Knobs that selected
between TPU code paths are gone: the port has one warp path (``warp_table``
had no other meaning), and the target rasterizer is chosen by the device of
its inputs (``raster_backend``); their flags (``--warp-table``,
``--raster-backend``) are not defined, so argparse rejects them.  The
agent's ``fused_step`` chose between XLA program layouts and has no
counterpart (nor has ``--agent-step``).  ``blocks`` (``--blocks``) chains
that many residual blocks at each site of the hourglass; ``remat``
recomputes each hourglass in the backward pass
(``torch.utils.checkpoint``); ``scan_stacks`` (``--scan-stacks``) selects
the JAX package's scanned checkpoint layout (every stack's parameters
stacked on a leading axis, the last stack's unused remap kept) and implies
remat, as it does there.
``num_devices`` (``--num-devices``) is the number of data-parallel ranks,
one process a GPU (:mod:`posetpu_torch.parallel`).  ``loader_backend="grain"`` selects the port's worker-process
loader (:class:`posetpu_torch.data.WorkerLoader`), so a reference command
line runs unchanged.
"""

from __future__ import annotations

import argparse
import copy
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass
class ModelConfig:
    stacks: int = 8  # reference --stacks
    blocks: int = 1  # reference --blocks
    classes: int = 16  # reference --num-classes
    feats: int = 128  # reference --features
    depth: int = 4
    remat: bool = False
    # the reference's nn.scan layout of the stacks (implies remat)
    scan_stacks: bool = False
    bf16: bool = True


@dataclass
class AugConfig:
    inp_res: Tuple[int, int] = (256, 256)
    out_res: Tuple[int, int] = (64, 64)
    sigma: float = 1.0  # reference --sigma
    scale_factor: float = 0.25  # reference --scale-factor
    rot_factor: float = 30.0  # reference --rot-factor
    rot_prob: float = 0.6
    flip_prob: float = 0.5
    scale_mode: str = "exp"  # "exp" (hourglass lineage) or "linear"
    color_jitter: bool = True
    dataset: str = "mpii"


@dataclass
class OptimConfig:
    lr: float = 2.5e-4  # reference --lr (RMSprop)
    epochs: int = 100  # reference --epochs
    schedule: Sequence[int] = (60, 90)  # reference --schedule (epoch lr drops)
    gamma: float = 0.1  # reference --gamma
    rms_decay: float = 0.99  # torch RMSprop alpha
    rms_eps: float = 1e-8
    momentum: float = 0.0
    weight_decay: float = 0.0


@dataclass
class AgentConfig:
    enabled: bool = False
    scale_bins: int = 7
    rot_bins: int = 7
    # > 0 enables the occlusion heads: 1 + sum g^2 over occ_levels for
    # "tree" and "flat", 1 + sum(part_level_sizes) = 9 for "parts"
    occ_nodes: int = 0
    occ_levels: Sequence[int] = (1, 2, 4)
    occ_mode: str = "tree"  # "tree" | "parts" | "flat"
    input_downscale: int = 2  # the agent sees the crop avg-pooled by this
    lr: float = 2.5e-4
    reward_baseline: str = "batch_mean"  # or "sign"
    update_every: int = 1  # agent updates on steps where step % N == 0
    # weight of the reference crops in the pose update (0: the pose net
    # trains on the adversarial crops only)
    pose_ref_weight: float = 0.0


@dataclass
class ExperimentConfig:
    name: str = "hg2_mpii_mini"
    model: ModelConfig = field(default_factory=ModelConfig)
    aug: AugConfig = field(default_factory=AugConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    agent: AgentConfig = field(default_factory=AgentConfig)
    # data
    annotations: str = ""  # reference --json path
    images_dir: str = ""  # reference --image-path
    # Pre-pad host canvas (the static shape the device warp reads from).
    # None: auto-sized at Experiment init so the largest person's
    # worst-case crop footprint (200*scale box x the largest aug scale x the
    # rotation bounding-box expansion) fits, capped at the largest image,
    # rounded up to a multiple of 64.  An explicit (H, W) is used as it is,
    # with a warning when too small (such crops read zero padding where the
    # reference reads pixels).
    pad_hw: Optional[Tuple[int, int]] = None
    batch_size: int = 6  # reference batch 6 per GPU
    # "host": HostLoader (decode thread, C++ pool or Pillow); "grain":
    # WorkerLoader (Pillow in worker processes), the reference's value for
    # its multi-process loader.  The same batch contract.
    loader_backend: str = "host"
    loader_workers: int = 0  # worker processes of "grain" (0: in-process)
    # run
    checkpoint_dir: str = "checkpoints"  # reference --checkpoint
    resume: str = ""  # reference --resume: a checkpoint path, or "auto"
    # initialize the pose network from a baseline run's checkpoint
    # directory before joint adversarial training (optimizer fresh)
    init_pose_from: str = ""
    seed: int = 0
    synthetic: bool = False  # build a synthetic mini-split on the fly
    steps_per_epoch: Optional[int] = None  # cap (smoke tests)
    eval_every: int = 1
    # train steps per dispatch: K > 1 replays one CUDA graph of K steps
    steps_per_dispatch: int = 1
    tensorboard: bool = False  # scalars under <checkpoint>/<name>/tb
    # data-parallel ranks, one process a GPU; None: every visible GPU on
    # CUDA, one process on the CPU.  batch_size is the global batch
    num_devices: Optional[int] = None


NAMED_CONFIGS = {
    # 2-stack hourglass, MPII mini-split
    "hg2_mpii_mini": ExperimentConfig(
        "hg2_mpii_mini",
        model=ModelConfig(stacks=2),
        optim=OptimConfig(epochs=10, schedule=(6, 8)),
        synthetic=True,
    ),
    # 8-stack hourglass, MPII full (Newell et al.'s published network)
    "hg8_mpii": ExperimentConfig("hg8_mpii", model=ModelConfig(stacks=8)),
    # 8-stack + adversarial scale/rotation agent, joint training on MPII
    "hg8_mpii_asr": ExperimentConfig(
        "hg8_mpii_asr",
        model=ModelConfig(stacks=8),
        agent=AgentConfig(enabled=True),
    ),
    # scale/rotation agent with tree occlusion over 22 nodes, LSP
    "hg8_lsp_aho": ExperimentConfig(
        "hg8_lsp_aho",
        model=ModelConfig(stacks=8, classes=14),
        aug=AugConfig(dataset="lsp"),
        agent=AgentConfig(enabled=True, occ_nodes=22),
    ),
    # 384x384 inputs, 8-stack + agent, data parallel over 8 GPUs
    "hg8_mpii_384_dp8": ExperimentConfig(
        "hg8_mpii_384_dp8",
        model=ModelConfig(stacks=8),
        aug=AugConfig(inp_res=(384, 384), out_res=(96, 96)),
        agent=AgentConfig(enabled=True),
        batch_size=48,
        num_devices=8,
    ),
}


def named_config(name) -> ExperimentConfig:
    if name not in NAMED_CONFIGS:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(NAMED_CONFIGS)}"
        )
    # deep copy: callers adjust leaves freely without touching the registry
    return copy.deepcopy(NAMED_CONFIGS[name])


# ---- argparse overrides (reference flag names) ----

_FLAGS = {
    # flag -> (path, type)
    "--stacks": ("model.stacks", int),
    "--blocks": ("model.blocks", int),
    "--num-classes": ("model.classes", int),
    "--features": ("model.feats", int),
    "--sigma": ("aug.sigma", float),
    "--scale-factor": ("aug.scale_factor", float),
    "--rot-factor": ("aug.rot_factor", float),
    "--lr": ("optim.lr", float),
    "--epochs": ("optim.epochs", int),
    "--gamma": ("optim.gamma", float),
    "--train-batch": ("batch_size", int),
    "--checkpoint": ("checkpoint_dir", str),
    "--resume": ("resume", str),
    "--init-pose-from": ("init_pose_from", str),
    "--json": ("annotations", str),
    "--image-path": ("images_dir", str),
    "--seed": ("seed", int),
    "--steps-per-epoch": ("steps_per_epoch", int),
    "--occ-mode": ("agent.occ_mode", str),  # tree | parts | flat
    "--occ-nodes": ("agent.occ_nodes", int),
    "--agent-update-every": ("agent.update_every", int),
    "--pose-ref-weight": ("agent.pose_ref_weight", float),
    "--loader-backend": ("loader_backend", str),  # host | grain
    "--loader-workers": ("loader_workers", int),
    "--steps-per-dispatch": ("steps_per_dispatch", int),
    "--num-devices": ("num_devices", int),
}


def add_overrides(parser: argparse.ArgumentParser):
    """Add the reference's override flags that the port reads."""
    for flag, (_, typ) in _FLAGS.items():
        parser.add_argument(flag, type=typ, default=None)
    parser.add_argument("--schedule", type=int, nargs="*", default=None)
    parser.add_argument("--synthetic", action="store_true", default=None)
    parser.add_argument("--tensorboard", action="store_true", default=None)
    parser.add_argument(
        "--scan-stacks", action="store_true", default=None,
        help="the JAX package's scanned stack layout (implies remat)",
    )
    parser.add_argument("--no-color-jitter", action="store_true", default=None)
    return parser


def apply_overrides(cfg: ExperimentConfig, args) -> ExperimentConfig:
    """Set the config leaves named by the flags given in ``args``."""
    for flag, (path, _) in _FLAGS.items():
        v = getattr(args, flag.lstrip("-").replace("-", "_"), None)
        if v is not None:
            head, _, leaf = path.partition(".")
            if leaf:
                setattr(getattr(cfg, head), leaf, v)
            else:
                setattr(cfg, head, v)
    if getattr(args, "schedule", None) is not None:
        cfg.optim.schedule = tuple(args.schedule)
    if getattr(args, "synthetic", None):
        cfg.synthetic = True
    if getattr(args, "tensorboard", None):
        cfg.tensorboard = True
    if getattr(args, "scan_stacks", None):
        cfg.model.scan_stacks = True
    if getattr(args, "no_color_jitter", None):
        cfg.aug.color_jitter = False
    return cfg
