"""mfu.prefill: mfu.serve's reading (bench/metrics/mfu.serve.py) in the
prefill cells, which report prefill_tokens_per_s."""
from bench import manifest

read = manifest.reader("mfu.serve")
