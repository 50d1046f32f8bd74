"""idle.prefill: idle.serve's reading (bench/metrics/idle.serve.py) in the
prefill cells, which report prefill_tokens_per_s."""
from bench import manifest

read = manifest.reader("idle.serve")
