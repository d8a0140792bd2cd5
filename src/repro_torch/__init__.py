"""PyTorch/CUDA port of the TweakLLM serving path (see ``src/repro`` for the
JAX reference it is held against).  Nothing in this package imports JAX or
the ``repro`` package."""
