"""LM serving for the PyTorch port."""
from .engine import Engine, ServeConfig
