"""The plain fp32 PyTorch reference that decides ``correct``.  It imports
nothing of the port, of JAX or of the JAX package."""
