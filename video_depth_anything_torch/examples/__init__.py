"""Examples of the library surface, the JAX package's ``examples/``: run each
with ``python -m video_depth_anything_torch.examples.<name>``."""
