"""Hand-written CUDA kernels of the port and their plain PyTorch versions:
``quantize_ef`` / ``dequant_add_ef``, ``dct_project`` and
``colgather_matmul_dual`` of the DCT-AdamW step, ``flash_decode`` of
serving. Importing builds nothing; the kernels are compiled at first
launch (``cuda_lib``)."""
