"""decode_step_ms.prefill: decode_step_ms.serve's reading (bench/metrics/decode_step_ms.serve.py) in the
prefill cells, which report prefill_tokens_per_s."""
from bench import manifest

read = manifest.reader("decode_step_ms.serve")
