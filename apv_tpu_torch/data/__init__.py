"""Input stage of the PyTorch port."""
