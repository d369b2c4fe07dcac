"""PyTorch/CUDA port of the Magpie tuner (the JAX package ``repro`` is the
reference). Importing this package builds nothing and touches no device;
the CUDA learner is compiled at its first launch (``kernels/build.py``)."""
