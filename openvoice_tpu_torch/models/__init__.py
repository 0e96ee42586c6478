"""Model graphs of the PyTorch port."""
