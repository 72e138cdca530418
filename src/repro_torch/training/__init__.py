"""Optimizers of the port (training runs plain PyTorch under autograd)."""
