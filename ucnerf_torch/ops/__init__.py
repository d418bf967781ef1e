"""Tensor ops of the port (plain PyTorch)."""
