"""The port's mesh rules against the JAX package's, as pure functions (no
process group): ``MeshSpec.resolve`` and its errors, the rank layout with
``dcn_data``, tensor parallelism's split dims against JAX's
``tp_shardings`` on the same exported tree, leaf by leaf (transposed),
and ZeRO's against ``zero_shardings`` for stages 1 and 3, alone and
composed with tensor parallelism.  The port's parameters are matched to
JAX's leaves by value: every leaf is filled with a distinct ``arange``
before the bridge (``params_from_jax``), so each torch dim is known by
the JAX dim whose stride it steps.
"""

import jax
import numpy as np
import pytest
import torch

from egovlp_tpu.core.mesh import MeshSpec as JaxMeshSpec
from egovlp_tpu.core.mesh import create_mesh as jax_create_mesh
from egovlp_tpu.core.mesh import (
    local_batch_to_global as jax_local_batch_to_global,
)
from egovlp_tpu.core.tp import tp_shardings
from egovlp_tpu.core.zero import zero_shardings
from egovlp_tpu.models import DualEncoder as JaxDualEncoder
from egovlp_tpu.train.state import create_train_state
from egovlp_tpu.train.state import make_optimizer as jax_make_optimizer
from egovlp_tpu_torch.core.mesh import (
    Axis,
    Mesh,
    MeshSpec,
    local_batch_to_global,
    mesh_ranks,
    param_shard,
    shard_batch,
)
from egovlp_tpu_torch.core.tp import shard_state_tp, split_dim
from egovlp_tpu_torch.core.zero import MeshUpdate
from egovlp_tpu_torch.models.convert import params_from_jax
from tests.test_torch_models import jax_config, port_model, random_params

SPECS = [(8, {}), (8, {"model": 2}), (8, {"data": 2, "model": 4}),
         (8, {"model": 2, "dcn_data": 2}), (4, {"data": 1, "model": 4}),
         (1, {})]


@pytest.mark.parametrize("world,spec", SPECS)
def test_resolve_matches_jax(world, spec):
    got = MeshSpec(**spec).resolve(world)
    want = JaxMeshSpec(**spec).resolve(list(range(world)))
    assert (got.data, got.model, got.dcn_data) == (want.data, want.model,
                                                   want.dcn_data)


@pytest.mark.parametrize("world,spec", [(2, {"model": 4}), (1, {"model": 2}),
                                        (8, {"data": 3}),
                                        (6, {"model": 2, "dcn_data": 2})])
def test_resolve_errors_name_the_mesh_and_the_world(world, spec):
    with pytest.raises(ValueError) as want:
        JaxMeshSpec(**spec).resolve(list(range(world)))
    with pytest.raises(ValueError) as got:
        MeshSpec(**spec).resolve(world)
    assert str(got.value) == str(want.value)
    assert f"does not cover {world} devices" in str(got.value)


@pytest.mark.parametrize("spec", [{"model": 2, "dcn_data": 2},
                                  {"data": 2, "model": 2, "dcn_data": 2},
                                  {"model": 4}])
def test_rank_layout_is_jaxs_device_layout(spec):
    """rank = (dcn * data + d) * model + m: model groups consecutive, the
    DCN slices the slowest part of the data axis, as JAX's mesh."""
    devices = jax.devices()[:8]
    jmesh = jax_create_mesh(JaxMeshSpec(**spec), devices)
    want = np.vectorize(lambda d: d.id)(jmesh.devices)
    got = mesh_ranks(MeshSpec(**spec).resolve(8))
    np.testing.assert_array_equal(got, want - min(d.id for d in devices))


def tagged():
    """The tiny JAX tree with leaf i filled by offset_i + arange, the
    port's state dict bridged from it, and for every port parameter its
    JAX path and the JAX dim of each torch dim."""
    params = random_params(0)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    offset, filled, info = 0, [], {}
    for path, leaf in leaves:
        n = int(np.prod(leaf.shape))
        filled.append((offset + np.arange(n, dtype=np.float32))
                      .reshape(leaf.shape))
        info[offset] = (path, leaf.shape)
        offset += n
    assert offset < 2 ** 24  # exact in float32
    sd = params_from_jax(jax.tree_util.tree_unflatten(
        treedef, filled))
    dims = {}
    for name, t in sd.items():
        first = int(t.flatten()[0])
        path, jshape = info[first]
        jstride = [int(np.prod(jshape[d + 1:])) for d in range(len(jshape))]
        perm = []
        for k in range(t.dim()):
            if t.shape[k] == 1:
                perm.append(None)
                continue
            idx = [0] * t.dim()
            idx[k] = 1
            step = int(t[tuple(idx)]) - first
            perm.append(jstride.index(step))
        dims[name] = (tuple(path), perm)
    return params, dims


def spec_dim(spec, perm, axis):
    """The torch dim a JAX PartitionSpec puts ``axis`` on, or None."""
    entries = list(spec)
    for k, j in enumerate(perm):
        if j is not None and j < len(entries) and entries[j] == axis:
            return k
    return None


def leaf_specs(shardings):
    return {tuple(p): s.spec for p, s in
            jax.tree_util.tree_flatten_with_path(shardings)[0]}


@pytest.fixture(scope="module")
def tree():
    return tagged()


@pytest.mark.parametrize("data,model", [(4, 2), (2, 4), (8, 1)])
def test_tp_split_dims_are_jaxs(data, model, tree):
    params, dims = tree
    jmesh = jax_create_mesh(JaxMeshSpec(data=data, model=model),
                            jax.devices()[:8])
    specs = leaf_specs(tp_shardings(params, jmesh))
    model_sd = port_model(params).state_dict()
    split = 0
    for name, (path, perm) in dims.items():
        want = spec_dim(specs[path], perm, "model")
        got = split_dim(name, tuple(model_sd[name].shape), model)
        assert got == want, (name, got, want)
        split += got is not None
    # a block: qkv (weight, bias), proj, fc1 (both), fc2, twice; a text
    # layer: q, k, v (both), out_lin, lin1 (both), lin2
    assert split == (0 if model == 1 else 2 * 9 + 2 * 10)


def fake_mesh(data, model):
    """A Mesh without a process group: shapes only."""
    return Mesh(MeshSpec(data, model).resolve(data * model), 0,
                data=Axis(0, data, tuple(range(0, data * model, model))),
                model=Axis(0, model, tuple(range(model))))


@pytest.mark.parametrize("stage", [1, 3])
@pytest.mark.parametrize("data,model", [(8, 1), (4, 2)])
def test_zero_dims_are_jaxs(stage, data, model, tree):
    params, dims = tree
    jmesh = jax_create_mesh(JaxMeshSpec(data=data, model=model),
                            jax.devices()[:8])
    state = create_train_state(JaxDualEncoder(jax_config()), params,
                               jax_make_optimizer(1e-3, (1,), 1))
    specs = zero_shardings(state, jmesh, stage=stage, min_size=256)
    param_specs = leaf_specs(specs.params)
    mu_specs = {}
    for path, s in jax.tree_util.tree_flatten_with_path(specs.opt_state)[0]:
        keys = [getattr(k, "name", getattr(k, "key", None)) for k in path]
        if "mu" in keys:
            mu_specs[tuple(path[keys.index("mu") + 1:])] = s.spec
    model_ = port_model(params)
    mesh = fake_mesh(data, model)
    if model > 1:
        shard_state_tp(model_, None, mesh)
    MeshUpdate(model_, mesh, stage, min_size=256)
    named = dict(model_.named_parameters())
    split = 0
    for name, (path, perm) in dims.items():
        s = param_shard(named[name])
        assert s.zero_dim == spec_dim(mu_specs[path], perm, "data"), name
        want_p = spec_dim(param_specs[path], perm, "data")
        assert want_p == (s.zero_dim if stage == 3 else None), name
        if model > 1:
            assert s.tp_dim == spec_dim(mu_specs[path], perm, "model"), name
        split += s.zero_dim is not None
    assert split >= 10


def test_batch_rows_of_a_data_rank():
    """``shard_batch`` gives data rank d its rows and keeps the underscore
    keys on the host; ``local_batch_to_global`` is JAX's."""
    mesh = fake_mesh(4, 2)
    jmesh = jax_create_mesh(JaxMeshSpec(data=4, model=2), jax.devices()[:8])
    assert local_batch_to_global(16, mesh) == jax_local_batch_to_global(
        16, jmesh) == 64
    batch = {"frames": np.arange(8 * 3).reshape(8, 3),
             "_index": np.arange(8)}
    got = shard_batch(batch, mesh)
    assert set(got) == {"frames"}
    np.testing.assert_array_equal(got["frames"].numpy(), batch["frames"][:2])
    with pytest.raises(ValueError, match="7 rows do not split over 4"):
        shard_batch({"frames": np.zeros((7, 3))}, mesh)


def test_tp_refuses_a_split_that_cuts_a_head(tree):
    params, _ = tree
    with pytest.raises(ValueError, match="2 heads do not split over 4"):
        shard_state_tp(port_model(params), None, fake_mesh(2, 4))
