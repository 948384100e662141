"""PyTorch + CUDA port of ``repro`` (FFT-based dynamic subspace selection
for low-rank adaptive optimization), for one NVIDIA H100.

It mirrors the JAX package module for module (``repro/<pkg>/<mod>.py`` ->
``repro_torch/<pkg>/<mod>.py``) and imports nothing of it, nor JAX. The
Pallas kernels of the training step are hand-written CUDA kernels for
Hopper under ``csrc/``, each with a plain PyTorch version beside its
wrapper. Entry points run on the card unless the caller asks for the CPU.
"""
