"""Weights for the PyTorch port: from JAX parameter pytrees and from
reference-format ``.pth`` checkpoints."""
