"""The plain reference against the port's CPU path at smoke sizes, both in
float32: the weight layout, the logits, the loss and every gradient."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from bench import harness, inputs, manifest, program  # noqa: E402
from bench.reference import model as ref  # noqa: E402
from bench.reference import optim as ref_optim  # noqa: E402
from bench.smoke import shrink  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm, model_zoo  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402

CONFIGS = [c["name"] for c in manifest.load()["configs"]]


def _cell(name):
    """The first cell of configuration ``name``."""
    return manifest.cell(next(w["name"] for w in manifest.load()["workloads"]
                              if w["config"] == name))


def _cfg(name, smoke=True):
    cell = _cell(name)
    cfg = shrink(cell).config if smoke else cell.config
    return {**cfg, "compute_dtype": "float32"}


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("name", CONFIGS)
def test_layout_is_the_programs_parameter_tree(name, smoke):
    cfg = _cfg(name, smoke)
    shapes = harness._flat(model_zoo.param_shapes(
        program.model_config(cfg, {})))
    layout = {p: s for p, s, _ in ref.param_layout(cfg)}
    assert {p: tuple(t.shape) for p, t in shapes.items()} == layout


@pytest.mark.parametrize("name", CONFIGS)
def test_the_program_takes_every_model_key_and_refuses_others(name):
    cfg = _cfg(name, smoke=False)
    mcfg = program.model_config(cfg, {"remat": "full"})
    for k in set(cfg) & program.FIELDS:
        got = getattr(mcfg, k)
        assert got == (tuple(cfg[k]) if isinstance(cfg[k], list)
                       else cfg[k]), k
    assert mcfg.remat_policy == "full" and mcfg.arch_id == name
    with pytest.raises(ValueError, match="does not take"):
        program.model_config({**cfg, "tied_output": True}, {})
    with pytest.raises(ValueError, match="pads the vocabulary"):
        program.model_config({**cfg, "vocab_pad": 16}, {})


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_and_gradients_match_the_port(name):
    cfg = _cfg(name)
    mcfg = program.model_config(cfg, {})
    w = inputs.weights(cfg, 11, "cpu")
    tree = inputs.nest({k: v.clone() for k, v in w.items()})
    batch = inputs.train_batch({"batch": 2, "seq": 32}, cfg["vocab"], 11, 0)
    tokens = torch.as_tensor(batch["tokens"])
    got = lm.forward(mcfg, tree, tokens)[0][..., :cfg["vocab"]]
    for r in range(2):
        want = ref.logits(cfg, w, tokens[r])
        assert torch.allclose(got[r], want, rtol=1e-4, atol=1e-4)
    loss, _, grads = steps.value_and_grad(
        mcfg, tree, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = harness._flat(grads)
    for v in w.values():
        v.requires_grad_(True)
    total = 0.0
    for r in range(2):
        lr = ref.loss(cfg, w, tokens[r], torch.as_tensor(batch["labels"][r]))
        (lr / 2).backward()
        total += float(lr.detach()) / 2
    assert abs(float(loss) - total) < 1e-5
    for k, v in w.items():
        want = v.grad if v.grad is not None else torch.zeros_like(v)
        scale = float(want.abs().max()) + 1e-12
        assert float((grads[k] - want).abs().max()) <= 1e-4 * scale + 1e-7, k


def test_reference_adamw_matches_the_ports_update():
    o = manifest.cell("olmo_1b.train").traffic["optimizer"]
    g = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(5, 7, generator=g), "b": torch.randn(3,
                                                                    generator=g)}
    mine = {k: v.clone() for k, v in params.items()}
    port = {k: v.clone() for k, v in params.items()}
    adam = ref_optim.AdamW(o, mine)
    state = optimizer.init_opt_state(port)
    cfg = optimizer.OptimizerConfig(**o)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * 3 for k, v in
                 params.items()}
        adam.update(mine, grads)
        optimizer.adamw_update(cfg, port, grads, state)
    for k in params:
        np.testing.assert_allclose(mine[k].numpy(), port[k].numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", CONFIGS)
def test_checked_readings_agree_in_float32(name):
    """The training check, the program in float32 on the CPU: every
    number reads near zero."""
    cell = shrink(_cell(name), checked_steps=2)
    if cell.kind != "train":
        cell = dataclasses.replace(cell, traffic=json.loads(
            (manifest.ROOT / "bench/traffic/train.json").read_text()))
        cell = shrink(cell, checked_steps=2)
    cell = dataclasses.replace(
        cell, config={**cell.config, "compute_dtype": "float32"})
    _, prog = harness.train_program(cell, 5, "cpu")
    want = harness.train_readings_reference(cell.config, cell.traffic, 5,
                                            "cpu", ref.Dots())
    from bench import judge
    numbers = judge.train_numbers(prog, want)
    assert all(v < 2e-4 for v in numbers.values()), numbers
