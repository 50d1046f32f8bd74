"""prefill_tokens_per_s: serve_tokens_per_s's arithmetic
(bench/metrics/serve_tokens_per_s.py) in the prefill cells: prompt plus
generated tokens of every generate call in the window over the host time
from the first call's start to the last call's return. A metric of its
own so that its bound follows the prefill cells' spread alone."""
from bench import manifest

read = manifest.reader("serve_tokens_per_s")
