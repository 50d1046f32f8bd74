"""Step functions and launchers for the PyTorch port."""
