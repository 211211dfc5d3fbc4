"""Operators of the port; each kernel beside its plain PyTorch version."""
