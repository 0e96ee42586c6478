"""Converter training of the PyTorch port (the port of
``openvoice_tpu/training``): losses, the discriminators, the mel/KL and GAN
train steps, the data pipeline, the training loop and the cloning-quality
metrics."""
