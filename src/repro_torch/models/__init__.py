"""Dense decoder model of the PyTorch port."""
