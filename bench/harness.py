"""One run of one cell: set-up, the measured window, the readers, and the
check against the plain reference.

A traffic mix's ``kind`` picks the loop:

* ``train``: the program's ``Trainer.run`` on the benchmark's weights
  and batches. Set-up drives the trainer through the checked steps (its
  readings: each step's loss, the first gradient as the optimizer's
  first moment holds it, the parameters' change over the checked
  steps); the window goes on with the same trainer, a step at a time,
  until ``seconds`` have passed.
* ``serve``: the program's ``Engine.generate`` on the benchmark's
  weights; set-up makes one call, then one closed-loop client sends
  batch after batch until the first return after ``seconds``.

After the window the program's state is freed and the reference
(``bench.reference``, float32) recomputes what is checked from the same
seed. A traced run profiles at most ``trace_units`` units of the window.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import inputs, judge, manifest, trace
from .reference import model as ref_model
from .reference import optim as ref_optim


@dataclasses.dataclass
class Context:
    """What the metric readers read (``bench/metrics/*.py``)."""
    kind: str
    cfg: dict
    traffic: dict
    setup_s: float
    starts: List[float]             # host clock of each unit in the window
    ends: List[float]
    tokens_per_unit: int
    requests_per_unit: int
    traced: Optional[dict] = None   # trace.reduce_events output
    traced_units: int = 0
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _flat(tree, prefix="") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _norms(flat: Dict[str, torch.Tensor], n_layers: int, fn=None
           ) -> Dict[str, float]:
    """Norm of every leaf (a stacked weight per layer) of ``flat``, or of
    ``fn(name, tensor)``."""
    return {name: float(torch.linalg.vector_norm(
        (t if fn is None else fn(name, t)).float()))
        for name, t in inputs.layer_leaves(flat, n_layers)}


def _window(step: Callable[[], None], seconds: float, units: int,
            traced: bool, spans, unit: str, min_units: int = 0):
    """Run ``step`` until ``seconds`` have passed and ``min_units`` steps
    have run (traced: at most ``units`` steps, under the profiler, each in
    a span named ``unit``). Returns (starts, ends, trace summary or
    None)."""
    starts, ends = [], []

    def loop():
        t0 = time.perf_counter()
        while True:
            starts.append(time.perf_counter())
            if traced:
                with trace.span(unit):
                    step()
            else:
                step()
            ends.append(time.perf_counter())
            done = ends[-1] - t0 >= seconds and len(ends) >= min_units
            if done or (traced and len(ends) >= units):
                return

    if not traced:
        loop()
        return starts, ends, None
    with trace.Spans(spans), trace.Trace() as tr:
        with trace.span("window"):
            loop()
    return starts, ends, tr.reduce()


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def train_readings_program(tr, cfg: dict, traffic: dict, start: dict):
    """Drive trainer ``tr`` through the checked steps and read it."""
    b1 = traffic["optimizer"]["b1"]
    L = cfg["n_layers"]
    out = {"loss": [], "grad": {}, "change": {}}
    for step in range(1, traffic["checked_steps"] + 1):
        out["loss"].append(float(tr.run_to(step)["loss"]))
        if step == 1:
            mu = _flat(tr.final_state[1]["mu"])
            out["grad"] = {k: v / (1 - b1) for k, v in _norms(mu, L).items()}
    now = _flat(tr.final_state[0])
    out["change"] = _norms(now, L, lambda name, t: t - _leaf(start, name))
    return out


def _leaf(flat: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    if name.endswith("]"):
        path, i = name[:-1].split("[")
        return flat[path][int(i)]
    return flat[name]


def train_readings_reference(cfg: dict, traffic: dict, seed: int, device,
                             dots: ref_model.Dots) -> dict:
    """The reference's readings of the checked steps, one row of the
    batch at a time."""
    ref_model.strict_fp32()
    L = cfg["n_layers"]
    w = inputs.weights(cfg, seed, device)
    start = {k: v.clone() for k, v in w.items()}
    for v in w.values():
        v.requires_grad_(True)
    opt = ref_optim.AdamW(traffic["optimizer"], w)
    out = {"loss": [], "grad": {}, "raw_grad": {}, "change": {}}
    for step in range(traffic["checked_steps"]):
        batch = inputs.train_batch(traffic, cfg["vocab"], seed, step)
        tokens = torch.as_tensor(batch["tokens"], device=device)
        labels = torch.as_tensor(batch["labels"], device=device)
        rows, total = tokens.shape[0], 0.0
        for r in range(rows):
            loss = ref_model.loss(cfg, w, tokens[r], labels[r], dots) / rows
            loss.backward()
            total += float(loss.detach())
        grads = {k: torch.zeros_like(v) if v.grad is None else v.grad
                 for k, v in w.items()}
        scale = opt.update(w, grads)
        if step == 0:
            out["raw_grad"] = _norms(grads, L)
            out["grad"] = {k: v * scale for k, v in out["raw_grad"].items()}
        for v in w.values():
            v.grad = None
        out["loss"].append(total)
    with torch.no_grad():
        out["change"] = _norms(w, L, lambda name, t: t - _leaf(start, name))
    return out


def train_program(cell: manifest.Cell, seed: int, device):
    """The trainer on the seed's weights, driven through the checked
    steps: (trainer, its readings)."""
    from . import program
    cfg, traffic = cell.config, cell.traffic
    params = inputs.weights(cfg, seed, device)
    start = {k: v.clone() for k, v in params.items()}
    tr = program.BenchTrainer(cfg, traffic, inputs.nest(params), seed,
                              device)
    del params
    return tr, train_readings_program(tr, cfg, traffic, start)


def train(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
          device, t0: float, min_units: int = 0):
    from . import program
    cfg, traffic = cell.config, cell.traffic
    tr, prog = train_program(cell, seed, device)
    _free()
    _sync(device)
    setup_s = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = program.counters()
    starts, ends, summary = _window(lambda: tr.run_to(tr.step + 1), seconds,
                                    traffic["trace_units"], traced,
                                    program.train_spans(), "step",
                                    min_units)
    ctx = _context(cell, setup_s, starts, ends, summary, device, before,
                   program.counters(),
                   tokens=traffic["batch"] * traffic["seq"], requests=0)
    del tr
    _free()
    ref = train_readings_reference(cfg, traffic, seed, device,
                                   ref_model.Dots())
    return ctx, judge.train_numbers(prog, ref), len(starts), 0


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def request_gaps(cfg: dict, w: Dict[str, torch.Tensor], prompt: np.ndarray,
                 served: np.ndarray, device, control: bool = False):
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position (infinite for a token outside
    the vocabulary); with ``control``, also the widest gap of the tokens
    the float8 reference puts first at the same positions."""
    seq = np.concatenate([prompt, served[:-1]]).astype(np.int64)
    tokens = torch.as_tensor(seq, device=device)
    rows = torch.arange(len(prompt) - 1, len(seq), device=device)
    with torch.no_grad():
        z = ref_model.logits(cfg, w, tokens, rows=rows).double()
        best = z.max(-1).values

        def gap(idx):
            return float((best - z.gather(-1, idx[:, None])[:, 0]).max())

        idx = torch.as_tensor(np.asarray(served, np.int64), device=device)
        ok = int(idx.min()) >= 0 and int(idx.max()) < cfg["vocab"]
        got = gap(idx) if ok else math.inf
        if not control:
            return got, None
        low = ref_model.logits(cfg, w, tokens, ref_model.Dots(fp8=True),
                               rows=rows)
        return got, gap(low.argmax(-1))


def reference_weights(cfg: dict, seed: int, device) -> dict:
    """The served weights, widened to float32 for the reference."""
    return {k: v.float() for k, v in inputs.weights(
        cfg, seed, device, served=True).items()}


def serve_program(cell: manifest.Cell, seed: int, seconds: float,
                  traced: bool, device, t0: float, min_units: int = 0):
    """Set-up and the closed-loop window: (context, outputs of every
    call)."""
    from . import program
    cfg, traffic = cell.config, cell.traffic
    vocab, b = cfg["vocab"], traffic["batch"]
    eng = program.engine(cfg, traffic, inputs.nest(
        inputs.weights(cfg, seed, device, served=True)), seed, device)
    eng.generate(inputs.prompts(traffic, vocab, seed, 0))
    _sync(device)
    setup_s = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    outs = []

    def call():
        prompt = inputs.prompts(traffic, vocab, seed, len(outs) + 1)
        outs.append(eng.generate(prompt))

    before = program.counters()
    starts, ends, summary = _window(call, seconds, traffic["trace_units"],
                                    traced, program.serve_spans(eng),
                                    "generate", min_units)
    _sync(device)
    ctx = _context(cell, setup_s, starts, ends, summary, device, before,
                   program.counters(),
                   tokens=b * (traffic["prompt"] + traffic["new_tokens"]),
                   requests=b)
    return ctx, outs


def serve_check(cell: manifest.Cell, seed: int, outs, device,
                control: bool = False):
    """(requests without a whole answer, {"logit_gap": ...} over the
    checked sample of ``outs`` (``check_requests`` of them, drawn from
    the seed over every slot of the batch), infinite if any request
    failed); with
    ``control`` also the float8 reference's widest gap
    (``"control_gap"``)."""
    cfg, traffic = cell.config, cell.traffic
    b, new = traffic["batch"], traffic["new_tokens"]
    failed = b * sum(1 for out in outs if out.shape != (b, new))
    ref_model.strict_fp32()
    w = reference_weights(cfg, seed, device)
    gaps, lows = [], []
    for req in inputs.sample(seed, len(outs), b, traffic["check_requests"]):
        c, row = divmod(int(req), b)
        if outs[c].shape != (b, new):
            continue
        prompt = inputs.prompts(traffic, cfg["vocab"], seed, c + 1)[row]
        got, low = request_gaps(cfg, w, prompt, outs[c][row], device,
                                control)
        gaps.append(got)
        lows.append(low)
    numbers = {"logit_gap": max(gaps) if gaps and not failed else math.inf}
    if control:
        numbers["control_gap"] = max(lows) if lows else math.inf
    return failed, numbers


def serve(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
          device, t0: float, min_units: int = 0):
    ctx, outs = serve_program(cell, seed, seconds, traced, device, t0,
                              min_units)
    _free()
    failed, numbers = serve_check(cell, seed, outs, device)
    return ctx, numbers, len(outs) * cell.traffic["batch"], failed


KINDS = {"train": train, "serve": serve}


def _context(cell, setup_s, starts, ends, summary, device, before, after,
             tokens, requests) -> Context:
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    return Context(kind=cell.kind, cfg=cell.config, traffic=cell.traffic,
                   setup_s=setup_s, starts=starts, ends=ends,
                   tokens_per_unit=tokens, requests_per_unit=requests,
                   traced=summary,
                   traced_units=len(starts) if summary else 0,
                   launches={k: after[k] - before[k] for k in after
                             if k in before},
                   peak_bytes=peak)


def run(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
        device="cuda", t0: Optional[float] = None, min_units: int = 0):
    """One run: (the result line's dict, with the compared numbers and
    their limits under ``checks``, last; those numbers as text lines).
    ``min_units`` makes the window also last that many units (the tests'
    fixed amount of work; the benchmark's window is ``seconds`` alone)."""
    t0 = time.perf_counter() if t0 is None else t0
    ctx, numbers, attempted, failed = KINDS[cell.kind](
        cell, seed, seconds, traced, device, t0, min_units)
    metrics = {}
    for m in cell.metrics(traced):
        value = manifest.reader(m["name"], cell.root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": ctx.peak_bytes}
    result = {"correct": judge.judge(numbers, cell.limits),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = ctx.traced["busy_s"]
        dev["window_s"] = ctx.traced["window_s"]
        result["breakdown"] = trace.breakdown(ctx.traced)
    result["checks"] = judge.as_json(numbers, cell.limits)
    return result, judge.lines(numbers, cell.limits)
