"""Training of the PyTorch port: losses, optimizers, step and loop."""
