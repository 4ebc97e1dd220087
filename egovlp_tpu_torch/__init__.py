"""EgoVLP in PyTorch + CUDA for NVIDIA Hopper (H100).

The port of ``egovlp_tpu`` (the JAX/Pallas package, kept beside it as the
reference).  Module paths and class/function names mirror the JAX
package so each counterpart is easy to find.  This package imports torch
and numpy, never jax or flax; of the JAX package it uses only the
framework-free ``egovlp_tpu.data.text`` tokenizer and
``egovlp_tpu.data.readers`` decoder front end.

Covered so far: the embedding service (``serving.py``, ``cli/serve.py``)
on the full dual encoder, forward only.  The divided space- and
time-attention of every video block runs through hand-written CUDA
kernels (``kernels/csrc``) on a CUDA device and through their plain
PyTorch twins on the CPU.
"""

__version__ = "0.1.0"
