"""Hand-written CUDA kernels of the DCT-AdamW step and their plain PyTorch
versions: ``quantize_ef`` / ``dequant_add_ef``, ``dct_project``,
``colgather_matmul_dual``. Importing builds nothing; the kernels are
compiled at first launch (``cuda_lib``)."""
