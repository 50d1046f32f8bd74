"""first_token_ms.prefill: first_token_ms.serve's reading
(bench/metrics/first_token_ms.serve.py) in the prefill cells, which
report prefill_tokens_per_s."""
from bench import manifest

read = manifest.reader("first_token_ms.serve")
