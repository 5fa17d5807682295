"""Pose network."""

from posetpu_torch.models.hourglass import Bottleneck, Hourglass, HourglassNet, hg

__all__ = ["Bottleneck", "Hourglass", "HourglassNet", "hg"]
