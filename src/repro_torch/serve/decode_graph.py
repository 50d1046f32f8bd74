"""One decode step captured as a CUDA graph and replayed, for the serving
engine (``engine.Engine``).

A ``DecodeGraph`` holds what the graph reads and writes at fixed
addresses: the engine's cache of one batch (its ``pos`` a 0-d int32 on
the card, which the decode attention kernel reads there and the step
advances in place), the token buffer the step reads, and the logits it
writes. Its first call runs the step eagerly on a side stream (the
warm-up: kernels built, the RoPE table made, cuBLAS set up on that
stream; that call's logits are the warm-up's) and then captures the
same step, ``model_zoo.decode_step`` unchanged, on that stream; capture
runs nothing on the card. Every later call copies the token in and
replays the graph: one launch on the host for the step's kernels.

The kernel wrappers count their launches on the host
(``kernels.counters``), and a replay runs no Python. So the capture notes
how far every counter moved while the step was recorded and takes that
back (nothing ran), and each replay adds it again, the decode attention's
span counter of launches by regime included. A replay's kernels are
counted on the card by the device trace of chip_smoke's serve phase,
which holds them to the same expected counts.

Counter (``launch.spans.count``): ``engine.decode_graph`` = [replays,
captures, eager steps]; this module counts the first two, the engine the
third.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels import counters
from ..launch import spans

COUNTER = "engine.decode_graph"


class DecodeGraph:
    """``step(params, cache, tok)`` (``launch.steps.make_decode_step``) on
    ``params`` over ``cache``, a CUDA cache the engine prefills between
    calls, captured at the first call and replayed at the others (module
    docstring)."""

    def __init__(self, step: Callable, params, cache):
        self.step, self.params, self.cache = step, params, cache
        self.graph = self.tok = self.logits = self.moved = None

    def __call__(self, tok):
        """(logits, cache) of the decode step of ``tok`` [B] at the cache's
        ``pos``; the logits are the graph's own buffer, rewritten by the
        next call."""
        if self.graph is None:
            self.tok = tok.clone()
            spans.count(COUNTER, [0, 1, 0])
            return self._capture(), self.cache
        self.tok.copy_(tok)
        self.graph.replay()
        counters.add(self.moved)
        spans.count(COUNTER, [1, 0, 0])
        return self.logits, self.cache

    def _capture(self):
        """Run the step once on a side stream, then capture it there;
        returns the run's logits."""
        with torch.cuda.device(self.tok.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                logits, _ = self.step(self.params, self.cache, self.tok)
            main.wait_stream(side)
            logits.record_stream(main)
            before = counters.read()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                self.logits, _ = self.step(self.params, self.cache, self.tok)
            self.moved = counters.moved(before, counters.read())
            counters.add(self.moved, -1)     # recorded, not run
            self.graph = graph
        return logits
