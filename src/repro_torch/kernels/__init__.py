"""Hand-written CUDA kernels of the port and their plain PyTorch versions:
``quantize_ef`` / ``dequant_add_ef``, ``dct_project`` and
``colgather_matmul_dual`` of the DCT-AdamW step, the Newton–Schulz
``ns_gram`` / ``ns_apply`` and the single-operand ``colgather_matmul`` of the
momentum families, ``flash_decode`` of serving, ``flash_attention`` of the
dense prefill. Importing builds nothing; the kernels are compiled at first
launch (``cuda_lib``)."""
