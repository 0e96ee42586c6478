"""Audio front end of the PyTorch port: WAV I/O, resampling, STFT."""
