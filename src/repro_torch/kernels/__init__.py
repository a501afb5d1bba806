"""Hand-written CUDA kernels (``csrc/``) with their bindings, plain
PyTorch versions and public wrappers, one package per reference kernel."""
