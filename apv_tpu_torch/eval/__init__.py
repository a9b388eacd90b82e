"""IWAE-k evaluation of the PyTorch port."""
