"""Hand-written CUDA kernels of the port (``csrc/``), their wrappers and
plain PyTorch versions, the build step and the device dispatch."""
