"""Host-side pipeline pieces of the PyTorch port: watermark and VAD."""
