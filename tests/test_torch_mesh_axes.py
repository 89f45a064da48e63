"""Collectives and placement over a tuple of mesh axes, and the multi-pod
mesh's ``pod`` axis, on the CPU (no JAX).

* ``Mesh.groups``, ``coord`` and ``extent`` over a tuple of axes against
  ``np.unravel_index``: the group's slots row-major over the tuple, its
  first name major (as JAX numbers the blocks of a dim a tuple
  ``PartitionSpec`` entry splits).
* Each ``axis_*`` collective over ``("pod", "data")`` and ``("data",
  "model")`` of a (2, 2, 2) mesh: its values against a plain sum, gather
  or maximum over each group, its gradient where it has one, and its count
  and bytes (one call, keyed by the tuple; the bytes summed over every
  group).
* ``device_put`` on ``("pod", "data", "model")`` places every leaf over
  both pods, and ``placed_slot_bytes`` equals ``launch.dryrun.slot_bytes``
  on the grids of ``tests/test_torch_batch_axes.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import transformer as TT
from repro_torch.utils.placed import Placed, spec_axes
from repro_torch.utils.pytree import tree_leaves_with_path

AXES = ("pod", "data", "model")
SHAPES = {("pod", "data", "model"): (2, 2, 2), ("data", "model"): (2, 3)}
GROUPS = [("pod", "data"), ("data", "model"), ("model", "pod"), ("pod", "data", "model"),
          "data"]


def _mesh(names=AXES):
    return tmesh.make_mesh(SHAPES[tuple(names)], names, device="cpu")


@pytest.mark.parametrize("names", sorted(SHAPES))
@pytest.mark.parametrize("axis", GROUPS, ids=str)
def test_tuple_groups_coords_and_extents(names, axis):
    mesh = _mesh(names)
    axes = spec_axes(axis)
    if set(axes) - set(names):
        with pytest.raises(ValueError):
            mesh.groups(axis)
        return
    shape = mesh.devices.shape
    ext = int(np.prod([shape[names.index(a)] for a in axes]))
    assert mesh.extent(axis) == ext
    for s in range(mesh.devices.size):
        idx = np.unravel_index(s, shape)
        want = 0
        for a in axes:
            want = want * shape[names.index(a)] + int(idx[names.index(a)])
        assert mesh.coord(s, axis) == want
    groups = mesh.groups(axis)
    assert sorted(s for g in groups for s in g) == list(range(mesh.devices.size))
    for g in groups:
        assert len(g) == ext and [mesh.coord(s, axis) for s in g] == list(range(ext))
        rest = [i for i, a in enumerate(names) if a not in axes]
        keys = {tuple(np.unravel_index(s, shape)[i] for i in rest) for s in g}
        assert len(keys) == 1    # one index of the other axes a group


def _parts(mesh, shape=(2, 3), grad=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).requires_grad_(grad)
            for _ in range(mesh.devices.size)]


def _counted(fn):
    tmesh.reset_collectives()
    out = fn()
    return out, dict(tmesh.collectives), dict(tmesh.collective_bytes), \
        dict(tmesh.collectives_by_axis)


@pytest.mark.parametrize("axis", [("pod", "data"), ("data", "model")], ids=str)
@pytest.mark.parametrize("kind", ["all_reduce", "all_gather", "reduce_scatter", "all_reduce_max",
                                  "send", "broadcast"])
def test_each_collective_over_a_tuple_of_axes(kind, axis):
    """Values, gradients, one counted call keyed by the tuple, and the
    bytes of a ring within each of the groups summed over all of them."""
    mesh = _mesh()
    groups = mesh.groups(axis)
    k, n_groups = len(groups[0]), len(groups)
    parts = _parts(mesh, (4, 2), grad=kind in ("all_reduce", "all_gather", "reduce_scatter",
                                                 "send"))
    nb = parts[0].numel() * 4
    if kind == "all_reduce":
        out, c, b, ax = _counted(lambda: tmesh.axis_all_reduce(parts, mesh, axis))
        want_bytes = n_groups * 2 * (k - 1) * nb
        for grp in groups:
            total = sum(parts[s].detach() for s in grp)
            for s in grp:
                torch.testing.assert_close(out[s], total, rtol=0, atol=1e-6)
        sum(o.sum() for o in out).backward()
        for p in parts:   # the identity's backward: each slot its own gradient
            assert torch.equal(p.grad, torch.ones_like(p))
    elif kind == "all_gather":
        out, c, b, ax = _counted(lambda: tmesh.axis_all_gather(parts, mesh, axis, 0))
        want_bytes = n_groups * (k - 1) * k * nb
        for grp in groups:
            cat = torch.cat([parts[s].detach() for s in grp], 0)
            for s in grp:
                assert torch.equal(out[s].detach(), cat)
        w = _parts(mesh, (4 * k, 2), seed=1)
        tmesh.reset_collectives()
        sum((o * wi).sum() for o, wi in zip(out, w)).backward()
        assert tmesh.collectives["reduce_scatter"] == 1
        for grp in groups:   # the reduce-scatter back: slot i's block of the group's sum
            total = sum(w[s] for s in grp)
            for i, s in enumerate(grp):
                torch.testing.assert_close(parts[s].grad, total[4 * i:4 * i + 4], rtol=0,
                                           atol=1e-6)
    elif kind == "reduce_scatter":
        out, c, b, ax = _counted(lambda: tmesh.axis_reduce_scatter(parts, mesh, axis, 0))
        want_bytes = n_groups * (k - 1) * nb
        blk = 4 // k
        for grp in groups:
            total = sum(parts[s].detach() for s in grp)
            for i, s in enumerate(grp):
                torch.testing.assert_close(out[s].detach(), total[blk * i:blk * (i + 1)],
                                           rtol=0, atol=1e-6)
        tmesh.reset_collectives()
        sum(o.sum() for o in out).backward()
        assert tmesh.collectives["all_gather"] == 1
        for p in parts:
            assert torch.equal(p.grad, torch.ones_like(p))
    elif kind == "all_reduce_max":
        out, c, b, ax = _counted(lambda: tmesh.axis_all_reduce_max(parts, mesh, axis))
        want_bytes = n_groups * 2 * (k - 1) * nb
        for grp in groups:
            top = torch.stack([parts[s] for s in grp]).amax(0)
            for s in grp:
                assert torch.equal(out[s], top)
    elif kind == "send":
        out, c, b, ax = _counted(lambda: tmesh.axis_send(parts, mesh, axis, 1))
        kind, want_bytes = "permute", n_groups * nb
        for grp in groups:
            assert torch.equal(out[grp[2]].detach(), parts[grp[1]].detach())
            assert all(out[s] is None for s in grp if s != grp[2])
        tmesh.reset_collectives()
        sum(o.sum() for o in out if o is not None).backward()
        assert tmesh.collectives["permute"] == 1
        for grp in groups:
            assert torch.equal(parts[grp[1]].grad, torch.ones_like(parts[0]))
            assert parts[grp[0]].grad is None
    else:
        out, c, b, ax = _counted(lambda: tmesh.axis_broadcast(parts, mesh, axis, k - 1))
        want_bytes = n_groups * (k - 1) * nb
        for grp in groups:
            for s in grp:
                assert torch.equal(out[s], parts[grp[-1]])
    name = {"all_reduce_max": "all_reduce", "send": "permute"}.get(kind, kind)
    assert c[name] == 1 and b[name] == want_bytes
    assert ax == {tmesh.axis_key(axis): 1}


def test_an_axis_of_extent_one_in_a_tuple_is_no_collective_of_its_own():
    """A tuple whose product is 1 is no collective; one whose other axes
    are 1 acts as its one live axis, keyed by the tuple."""
    mesh = tmesh.make_mesh((1, 2, 1), AXES, device="cpu")
    parts = _parts(mesh)
    out, c, _, ax = _counted(lambda: tmesh.axis_all_reduce(parts, mesh, ("pod", "model")))
    assert out == parts and c["all_reduce"] == 0 and ax == {}
    out, c, _, ax = _counted(lambda: tmesh.axis_all_reduce(parts, mesh, ("pod", "data")))
    assert c["all_reduce"] == 1 and ax == {("pod", "data"): 1}
    torch.testing.assert_close(out[0], parts[0] + parts[1])


# grid -> (mesh shape, mesh axes, data_axis, model_axis): tests/test_torch_batch_axes.py's
GRIDS = {"a": ((2, 2, 2), AXES, "data", "model"),
         "b": ((2, 2), ("data", "model"), ("data", "model"), None),
         "c": ((2, 2, 2), AXES, AXES, None),
         "d": ((2, 2, 2), AXES, ("pod", "data"), "model")}


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("g", sorted(GRIDS))
def test_placed_slot_bytes_equal_the_dry_runs_on_the_grids(g, fsdp):
    """A reduced gemma3-1b's params, its SGD state and a cache, each placed
    on the grid with its ``data_axis``/``model_axis``: every leaf placed
    over the whole grid (no pod slot left empty), the bytes a slot equal
    to ``dryrun.slot_bytes``, and each leaf read back whole."""
    shape, names, da, ma = GRIDS[g]
    mesh = tmesh.make_mesh(shape, names, device="cpu")
    cfg = reduce_config(get_config("gemma3-1b"), d_model=64)
    cfg = dataclasses.replace(cfg, num_layers=2, pattern=cfg.pattern[:2], fsdp=fsdp)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = TT.init_cache(cfg, 8, 16, device="cpu")
    trees = {"params": (params, tsh.params_shardings(mesh, params, cfg, data_axis=da,
                                                     model_axis=ma)),
             "cache": (cache, tsh.cache_shardings(mesh, cache, cfg, data_axis=da,
                                                  model_axis=ma))}
    for what, (tree, sh) in trees.items():
        placed = tsh.device_put(tree, sh)
        for (name, x), (_, w) in zip(tree_leaves_with_path(placed),
                                     tree_leaves_with_path(tree)):
            assert isinstance(x, Placed), (what, name)
            assert x.layout.mesh.axis_names == names and x.layout.n_slots == mesh.devices.size
            assert torch.equal(x.whole(), w), (what, name)
        assert tsh.placed_slot_bytes(placed, mesh) == \
            [tdry.slot_bytes(tree, sh, mesh)] * mesh.devices.size, what
