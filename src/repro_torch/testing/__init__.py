"""Test and smoke support: the BCD problems the kernel is held to its plain
version on (`repro_torch.testing.bcd_problems`)."""
from .bcd_problems import CHAOTIC, covariance_problems

__all__ = ["CHAOTIC", "covariance_problems"]
