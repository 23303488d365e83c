"""Models of the port (counterpart of maskrcnn_tpu.models).

NCHW convolutions in torch.channels_last memory, so the NHWC views at
the public functions (the JAX package's layout) are free.
"""
