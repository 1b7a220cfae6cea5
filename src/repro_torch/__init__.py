"""PyTorch and CUDA port of the futurized accelerator runtime.

``repro_torch`` mirrors the JAX package ``repro`` module for module.  It
imports torch, numpy and the standard library only; its kernels are
hand-written CUDA C++ under ``kernels/csrc``, built with ``nvcc`` at first
use.
"""
