"""The serving tier of the PyTorch port: the request batcher, the HTTP
server and the demo app."""
