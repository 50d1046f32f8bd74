"""peak_mem.prefill: peak_mem.serve's reading (bench/metrics/peak_mem.serve.py) in the
prefill cells, which report prefill_tokens_per_s."""
from bench import manifest

read = manifest.reader("peak_mem.serve")
