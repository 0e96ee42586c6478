"""Host-side pipeline pieces of the PyTorch port: watermark, VAD,
whisper-mode segmentation and the cached speaker-embedding entry `get_se`."""
