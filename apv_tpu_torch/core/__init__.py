"""Probabilistic core of the PyTorch port: distributions, IWAE, metrics."""
