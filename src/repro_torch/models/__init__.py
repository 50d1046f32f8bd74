"""Model definitions (dense LM family) for the PyTorch port."""
