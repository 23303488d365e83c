"""Weights into the port: a reference `.pth` or a JAX parameter tree,
and the frozen-BN fold."""
