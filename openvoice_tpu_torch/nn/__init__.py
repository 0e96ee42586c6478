"""Neural-network modules of the PyTorch port (reference-named parameters)."""
