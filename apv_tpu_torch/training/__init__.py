"""Loss terms of the PyTorch port."""
