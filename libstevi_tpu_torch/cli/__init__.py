"""Command-line tools of the port (`python -m libstevi_tpu_torch.cli.<tool>`),
mirroring the JAX package's `cli/` tools."""
