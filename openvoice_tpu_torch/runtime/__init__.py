"""Host-side runtime helpers of the PyTorch port."""
