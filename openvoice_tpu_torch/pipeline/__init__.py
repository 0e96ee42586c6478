"""Host-side pipeline pieces of the PyTorch port: watermark, VAD and
whisper-mode segmentation."""
