"""The plain float32 reference of the benchmark's models and optimizer.

Imports torch alone: nothing of the program under test, nothing of JAX.
"""
