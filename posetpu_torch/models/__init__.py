"""Pose network and adversarial augmentation agent."""

from posetpu_torch.models.agent import AugAgent
from posetpu_torch.models.hourglass import Bottleneck, Hourglass, HourglassNet, hg

__all__ = ["AugAgent", "Bottleneck", "Hourglass", "HourglassNet", "hg"]
