"""Device meshes, the placement rules and the wrappers that apply them
(port of ``isbfsar_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over an initialised
process group (``launch.run_ranks``, or ``torchrun``'s environment); one
process drives one device, so a rank holds only its own shard of every
batch: :func:`shard_batch` and :func:`shard_batch_sp` cut the host batch,
which every rank builds the same from its seed, to the rank's rows (and
time slice). The rules are the JAX package's, with the same arguments and
decisions:

* :func:`fsdp_spec`: the largest dim divisible by the axis size, or None
  (replicate) for leaves under ``min_size`` elements or with no divisible
  dim;
* :func:`tp_spec`: Megatron's column/row pairs by parameter-path suffix,
  on torch's ``(out, in)`` weight layout (JAX's column-parallel kernel
  ``(None, 0)`` is torch weight dim 0);
* :func:`sp_batch_spec`: the episodic batch's per-dim axis names.

:func:`shard_params_fsdp` is FSDP2 ``fully_shard`` with a
``shard_placement_fn`` that follows :func:`fsdp_spec`. FSDP2 holds every
parameter of a ``fully_shard`` group split: a leaf the rule would
replicate is split on dim 0 instead (padded where it does not divide), and
:func:`fsdp_receipt` does not count it. :func:`shard_params_tp` is
``parallelize_module`` with a plan from ``_TP_RULES``; the transformer's
reductions over the split features are in ``models/trx.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def _require_group(what: str) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"{what}: no torch.distributed process group is initialised (start "
                           "the ranks with parallel/launch.py::run_ranks or torchrun)")


def _device_type(device) -> str:
    return torch.device(device).type


def make_mesh(n: Optional[int] = None, axis: str = "dp", device="cuda"):
    """A 1-D mesh over the group's ``n`` ranks (all of them by default)."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_group("make_mesh")
    world = dist.get_world_size()
    n = n or world
    if n != world:
        raise ValueError(f"make_mesh({n}): the process group has {world} ranks; a mesh spans "
                         "all of them")
    return init_device_mesh(_device_type(device), (n,), mesh_dim_names=(axis,))


def make_mesh_2d(shape: Tuple[int, int], axes: Tuple[str, str] = ("dp", "way"), device="cuda"):
    """A 2-D mesh, ``shape`` ranks per axis, the second axis minor."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_group("make_mesh_2d")
    world = dist.get_world_size()
    if shape[0] * shape[1] != world:
        raise ValueError(f"make_mesh_2d({shape}): the process group has {world} ranks")
    return init_device_mesh(_device_type(device), tuple(shape), mesh_dim_names=tuple(axes))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def _take(x, dim: int, index: int, n: int):
    x = np.asarray(x)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of a {x.shape} leaf does not split over {n} ranks")
    size = x.shape[dim] // n
    return np.ascontiguousarray(x.take(np.arange(index * size, (index + 1) * size), axis=dim))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh, axis: str = "dp"):
    """This rank's rows of every leaf of a host batch (split on the leading
    axis over ``axis``)."""
    n, i = axis_size(mesh, axis), axis_rank(mesh, axis)
    return _map(batch, lambda x: _take(x, 0, i, n))


def sp_batch_spec(key: str, ndim: int, dp_axis: str = "dp",
                  seq_axis: str = "sp") -> Tuple[Optional[str], ...]:
    """Per-dim axis names of one episodic-batch leaf under sequence
    parallelism: support clips (b, way, L, ...) split time at dim 2,
    query/unknown clips (b, L, ...) at dim 1, labels dp only."""
    if key == "support_set":
        dims = [dp_axis, None, seq_axis]
    elif key in ("target_set", "unknown_set"):
        dims = [dp_axis, seq_axis]
    else:
        dims = [dp_axis]
    return tuple(dims[:ndim] + [None] * (ndim - len(dims)))


def shard_batch_sp(batch, mesh, dp_axis: str = "dp", seq_axis: str = "sp"):
    """This rank's rows and time slice of every leaf, per :func:`sp_batch_spec`."""
    coords = {a: (axis_size(mesh, a), axis_rank(mesh, a)) for a in (dp_axis, seq_axis)}

    def cut(key):
        def place(x):
            for dim, name in enumerate(sp_batch_spec(key, np.ndim(x), dp_axis, seq_axis)):
                if name is not None:
                    x = _take(x, dim, coords[name][1], coords[name][0])
            return np.asarray(x)
        return place

    return {key: _map(sub, cut(key)) for key, sub in batch.items()}


@torch.no_grad()
def replicate(tree, mesh):
    """Every tensor of ``tree`` (a nest of dicts, lists and tuples)
    overwritten in place with the mesh's first rank's values."""
    src = int(mesh.mesh.flatten()[0])

    def bcast(t):
        dist.broadcast(t.data, src=src)
        return t

    return _map(tree, bcast)


# ------------------------------------------------------------------ fsdp


def fsdp_spec(shape, n: int, min_size: int = 4096) -> Optional[int]:
    """The dim one parameter leaf splits on over ``n`` ranks: the largest
    divisible one; None for leaves under ``min_size`` elements or with no
    divisible dim (the JAX rule; deterministic in the shape alone)."""
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape, dtype=np.int64)) < min_size:
        return None
    dims = [d for d in range(len(shape)) if shape[d] % n == 0 and shape[d] >= n]
    if not dims:
        return None
    return max(dims, key=lambda i: shape[i])


def shard_params_fsdp(module: nn.Module, mesh, axis: str = "dp", min_size: int = 4096):
    """FSDP2 ``fully_shard`` of ``module`` over the ``axis`` ranks, each
    parameter split per :func:`fsdp_spec` (dim 0 where it says replicate)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    sub = mesh[axis] if mesh.ndim > 1 else mesh
    n = sub.size()

    def placement(param):
        dim = fsdp_spec(param.shape, n, min_size)
        return Shard(0 if dim is None else dim)

    return fully_shard(module, mesh=sub, shard_placement_fn=placement)


def fsdp_receipt(named_params, n: int, min_size: int = 4096) -> Dict[str, int]:
    """The leaves and elements that live split over the ranks as the rule
    asked (a local shard smaller than the leaf, on the rule's dim); the
    leaves FSDP2 splits where the rule says replicate are not counted."""
    leaves = elems = 0
    for _, p in named_params:
        local = getattr(p, "_local_tensor", p)
        if fsdp_spec(p.shape, n, min_size) is not None and tuple(local.shape) != tuple(p.shape):
            leaves += 1
            elems += int(p.numel())
    return {"sharded_leaves": leaves, "sharded_elems": elems}


# -------------------------------------------------------------------- tp

# (path suffix, the torch (out, in) weight dim or bias dim that splits):
# sk_extractor fc1 column -> fc2 row; the transformer's K/V linears column
# (the einsums then contract over the split features: models/trx.py adds
# the partial sums); the discriminator's reduce row (its input, the chosen
# class's tuple differences, is already feature-split), fc1 column -> fc2
# row. Everything else (norms, fc3, the ResNet trunk) stays replicated.
_TP_RULES: Tuple[Tuple[Tuple[str, ...], int], ...] = (
    (("sk_extractor", "fc1", "weight"), 0),
    (("sk_extractor", "fc1", "bias"), 0),
    (("sk_extractor", "fc2", "weight"), 1),
    (("transformer", "k_linear", "weight"), 0),
    (("transformer", "k_linear", "bias"), 0),
    (("transformer", "v_linear", "weight"), 0),
    (("transformer", "v_linear", "bias"), 0),
    (("discriminator", "reduce", "weight"), 1),
    (("discriminator", "fc1", "weight"), 0),
    (("discriminator", "fc1", "bias"), 0),
    (("discriminator", "fc2", "weight"), 1),
)
_RANK = {"weight": 2, "bias": 1}


def tp_spec(path_names: Sequence[str], shape, n: int) -> Optional[int]:
    """The dim one leaf splits on over ``n`` tp ranks: the first rule whose
    path is a suffix of ``path_names`` (so optimizer-state copies under a
    prefix land as their parameters), or None (replicated) where no rule
    matches or its dim does not divide by ``n``."""
    shape = tuple(int(s) for s in shape)
    names = tuple(path_names)
    for suffix, dim in _TP_RULES:
        if names[-len(suffix):] == suffix and _RANK[suffix[-1]] == len(shape):
            return dim if shape[dim] % n == 0 and shape[dim] >= n else None
    return None


def tp_plan(module: nn.Module, n: int) -> Dict[str, object]:
    """``parallelize_module``'s plan for ``module``: column-parallel where
    its weight splits on dim 0, row-parallel on dim 1."""
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    plan = {}
    for name, sub in module.named_modules():
        if not isinstance(sub, nn.Linear):
            continue
        dim = tp_spec(tuple(name.split(".")) + ("weight",), sub.weight.shape, n)
        if dim is not None:
            plan[name] = ColwiseParallel() if dim == 0 else RowwiseParallel()
    return plan


def shard_params_tp(module: nn.Module, mesh, axis: str = "tp") -> nn.Module:
    """Megatron-style tensor parallelism of a TRXOS over the ``axis`` ranks:
    ``parallelize_module`` with :func:`tp_plan`, and the transformer told
    its group where both K/V linears split."""
    from torch.distributed.tensor.parallel import parallelize_module

    sub = mesh[axis] if mesh.ndim > 1 else mesh
    plan = tp_plan(module, sub.size())
    parallelize_module(module, sub, plan)
    transformer = getattr(module, "transformer", None)
    if transformer is not None and {"transformer.k_linear", "transformer.v_linear"} <= set(plan):
        transformer.tp_group = sub.get_group()
    return module


def tp_receipt(named_params) -> Dict[str, int]:
    """The leaves and elements held split (a local shard smaller than the leaf)."""
    leaves = elems = 0
    for _, p in named_params:
        local = getattr(p, "_local_tensor", p)
        if tuple(local.shape) != tuple(p.shape):
            leaves += 1
            elems += int(p.numel())
    return {"sharded_leaves": leaves, "sharded_elems": elems}
