"""The dense llama model: config, layers, transformer."""
