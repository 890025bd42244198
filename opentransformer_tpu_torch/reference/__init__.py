"""Plain PyTorch references that the port is held against in its CPU tests;
each imports nothing of the port."""
