"""The port's sharding rules and shape trees against the JAX package's,
with no process group and no devices.

``repro.launch.sharding``'s functions read only a mesh's ``shape`` (a
{name: size} map) and ``axis_names``, and ``repro_torch.launch.sharding``'s
only its ``shape`` (sizes in axis order) and ``mesh_dim_names``, so a
stand-in object for each stands for meshes of any size. Every registry
config, full and smoke, on the (data, model) meshes (4, 2), (2, 4),
(8, 1), (1, 8) and the ("pod", "data", "model") mesh (2, 16, 16): the
param specs under the three plans, the ZeRO extension of the optimizer
state, FSDP, batch and cache specs must equal the reference's leaf for
leaf (a port spec is the tuple of the reference PartitionSpec's
entries). ``param_shapes`` and ``opt_state_shapes`` (the meta device)
must equal ``jax.eval_shape``'s shapes and dtypes.
"""
import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch import sharding as jax_sharding  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import sharding, steps  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402

MESHES = [(("data", "model"), (4, 2)), (("data", "model"), (2, 4)),
          (("data", "model"), (8, 1)), (("data", "model"), (1, 8)),
          (("pod", "data", "model"), (2, 16, 16))]
CASES = [(arch, smoke) for arch in configs.ARCH_IDS
         for smoke in (True, False)]
IDS = [f"{a}-{'smoke' if s else 'full'}" for a, s in CASES]


def _meshes(names, shape):
    """(reference stand-in, port stand-in) for one mesh."""
    return (SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names),
            SimpleNamespace(shape=shape, mesh_dim_names=names))


@functools.lru_cache(maxsize=None)
def _cfgs(arch, smoke):
    return (jax_configs.get_config(arch, smoke=smoke),
            configs.get_config(arch, smoke=smoke))


@functools.lru_cache(maxsize=None)
def _shapes(arch, smoke):
    jcfg, cfg = _cfgs(arch, smoke)
    return jax_zoo.param_shapes(jcfg), model_zoo.param_shapes(cfg)


def _jax_flat(tree, leaf=lambda x: isinstance(x, P)):
    """{'/'-joined path: leaf} of a reference tree."""
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=leaf)[0]:
        out["/".join(jax_sharding._path_str(p) for p in path)] = x
    return out


def _flat(tree):
    out = {}
    tree_map(lambda path, x: out.__setitem__(path, x), tree)
    return out


def _same_specs(got, want):
    """Port spec tree == reference spec tree, leaf for leaf."""
    want = {k: tuple(v) for k, v in _jax_flat(want).items()}
    got = _flat(got)
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path] == w, (path, got[path], w)


@pytest.mark.parametrize("arch,smoke", CASES, ids=IDS)
def test_param_specs_all_plans(arch, smoke):
    jshapes, shapes = _shapes(arch, smoke)
    for names, shape in MESHES:
        jmesh, mesh = _meshes(names, shape)
        for plan in ("tp", "dp", "ep"):
            _same_specs(sharding.param_specs(shapes, mesh, plan),
                        jax_sharding.param_specs(jshapes, jmesh, plan))


@pytest.mark.parametrize("arch,smoke", CASES, ids=IDS)
def test_opt_and_fsdp_specs(arch, smoke):
    """zero_extend through opt_specs (data, and pod+data on the pod mesh)
    and fsdp_param_specs."""
    jshapes, shapes = _shapes(arch, smoke)
    for names, shape in MESHES:
        jmesh, mesh = _meshes(names, shape)
        axes_list = [("data",)] + ([("pod", "data")] if "pod" in names
                                   else [])
        for plan in ("tp", "dp", "ep"):
            ps = sharding.param_specs(shapes, mesh, plan)
            jps = jax_sharding.param_specs(jshapes, jmesh, plan)
            for axes in axes_list:
                _same_specs(sharding.opt_specs(ps, shapes, mesh, axes),
                            jax_sharding.opt_specs(jps, jshapes, jmesh,
                                                   axes))
        _same_specs(sharding.fsdp_param_specs(shapes, mesh),
                    jax_sharding.fsdp_param_specs(jshapes, jmesh))


@pytest.mark.parametrize("arch,smoke", CASES, ids=IDS)
def test_cache_specs(arch, smoke):
    """KV/SSM caches: batch over the data axes when it divides, else the
    sequence (over "data", and over "model" too when the kv heads are
    narrower than it: split-KV)."""
    jcfg, cfg = _cfgs(arch, smoke)
    for batch, max_seq in ((8, 64), (1, 64), (32, 4096), (2, 512)):
        jcache = jax.eval_shape(
            lambda: jax_zoo.init_cache(jcfg, batch, max_seq))
        cache = model_zoo.init_cache(cfg, batch, max_seq, device="meta")
        for names, shape in MESHES:
            jmesh, mesh = _meshes(names, shape)
            _same_specs(sharding.cache_specs(cfg, batch, mesh, cache),
                        jax_sharding.cache_specs(jcfg, batch, jmesh, jcache))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_batch_specs(arch):
    jcfg, cfg = _cfgs(arch, True)
    for names, shape in MESHES:
        jmesh, mesh = _meshes(names, shape)
        for batch in (1, 2, 8, 32, 512):
            for kind in ("train", "prefill"):
                _same_specs(sharding.batch_specs(cfg, batch, mesh, kind),
                            jax_sharding.batch_specs(jcfg, batch, jmesh,
                                                     kind))
            assert sharding.batch_specs(cfg, batch, mesh, "decode") == \
                tuple(jax_sharding.batch_specs(jcfg, batch, jmesh, "decode"))


def _shape_tree(tree, jax_side):
    """{path: (shape, dtype name)} of a shape tree."""
    if jax_side:
        return {k: (tuple(v.shape), str(v.dtype)) for k, v in _jax_flat(
            tree, leaf=lambda x: hasattr(x, "shape")).items()}
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _flat(tree).items()}


@pytest.mark.parametrize("arch,smoke", CASES, ids=IDS)
def test_param_shapes_match_eval_shape(arch, smoke):
    jshapes, shapes = _shapes(arch, smoke)
    assert all(t.device.type == "meta" for t in _flat(shapes).values())
    assert _shape_tree(shapes, False) == _shape_tree(jshapes, True)


@pytest.mark.parametrize("arch,smoke", CASES, ids=IDS)
def test_opt_state_shapes_match_eval_shape(arch, smoke):
    jcfg, cfg = _cfgs(arch, smoke)
    got = steps.opt_state_shapes(cfg)
    assert all(t.device.type == "meta" for t in _flat(got).values())
    assert _shape_tree(got, False) == _shape_tree(
        jax_steps.opt_state_shapes(jcfg), True)


def test_placements_keep_the_spec_axis_order():
    """A spec turns into one placement per mesh dim; a dim sharded over
    several axes keeps their (mesh) order; another order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    _, mesh = _meshes(("pod", "data", "model"), (2, 16, 16))
    assert sharding.placements((None, ("pod", "data"), "model"), mesh) == (
        Shard(1), Shard(1), Shard(2))
    assert sharding.placements((None, None, ("data", "model"), None),
                               mesh) == (Replicate(), Shard(2), Shard(2))
    assert sharding.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements((("model", "data"),), mesh)


def test_mesh_helpers_match_reference():
    from repro.launch import mesh as jax_mesh
    for names, shape in MESHES:
        jmesh, mesh = _meshes(names, shape)
        assert mesh_lib.data_axes(mesh) == jax_mesh.data_axes(jmesh)
        assert mesh_lib.model_size(mesh) == jax_mesh.model_size(jmesh)
        assert mesh_lib.batch_shard_size(mesh) == \
            jax_mesh.batch_shard_size(jmesh)


def test_param_specs_unknown_plan_raises():
    _, mesh = _meshes(("data", "model"), (4, 2))
    with pytest.raises(ValueError, match="plan"):
        sharding.param_specs(_shapes("olmo_1b", True)[1], mesh, "pp")


def test_opt_state_specs_keep_step_plain():
    """The trainer's optimizer-state specs: the moments as opt_specs, the
    step None (a plain tensor on every rank)."""
    jshapes, shapes = _shapes("granite_8b", True)
    jmesh, mesh = _meshes(("data", "model"), (4, 2))
    ps = sharding.param_specs(shapes, mesh)
    os_ = sharding.opt_state_specs(ps, shapes, mesh)
    assert os_["step"] is None
    _same_specs(os_["mu"], jax_sharding.opt_specs(
        jax_sharding.param_specs(jshapes, jmesh), jshapes, jmesh))
    assert np.all([os_["mu"][k] == os_["nu"][k] for k in os_["mu"]])
