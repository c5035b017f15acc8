"""Runtime of the PyTorch port."""
