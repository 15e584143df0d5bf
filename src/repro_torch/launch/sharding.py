"""Parameter / activation sharding rules (FSDP + tensor parallel), the port
of ``repro.launch.sharding``.

A spec is a tuple with one entry a dim, as ``tuple(PartitionSpec(...))``
reads in the reference: ``None`` (replicated), an axis name, or a tuple of
axis names (a one-name tuple is written as the name, as JAX normalizes
it).  Generic rule per parameter leaf: the "model" axis goes to the largest
divisible dim, then the "data" axis to the next (FSDP-style weight
sharding); stacked-layer leading dims are never sharded.  Path-based
overrides implement expert parallelism for MoE weights and vocab-parallel
embeddings.  On the multi-pod mesh the "pod" axis joins batch sharding
only.  Leaves are named by the reference's key paths
(``"['layers']['moe']['wg']"``, ``".m['embed']['table']['q']"``).

:func:`local_block` cuts the block a rank holds from a full tensor and
:func:`gather_full` reassembles the full tensor from the blocks: the two
halves of ``shard_map``'s in/out specs.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import Mesh, axis_product, data_axes

Spec = Tuple[Any, ...]


def spec(*entries) -> Spec:
    """A spec tuple, one-name tuples written as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _leaf_spec(path: str, shape: Tuple[int, ...], mesh: Mesh,
               stacked: bool) -> Spec:
    model = _axis_size(mesh, "model")
    data = _axis_size(mesh, "data")
    ndim = len(shape)
    start = 1 if (stacked and ndim >= 2) else 0
    assign: list = [None] * ndim

    # ---- overrides ----------------------------------------------------
    # int8 optimizer moments [..., nb, bs] (+ scales [..., nb, 1]): inherit
    # the parent parameter's spec (leading dims identical; the split last
    # dim's axis moves to the nb dim when divisibility allows)
    if path.endswith("['q']") or path.endswith("['s']"):
        if ndim < 2:
            return spec()
        parent_path = path[: path.rfind("[")]
        nb = shape[-2]
        if path.endswith("['q']"):
            parent_shape = shape[:-2] + (shape[-2] * shape[-1],)
        else:
            parent_shape = shape[:-2] + (nb,)  # scale: block count only
        pspec = _leaf_spec(parent_path, parent_shape, mesh, stacked)
        entries = list(pspec) + [None] * (len(parent_shape) - len(pspec))
        last_axis = entries[-1]
        sz = 1
        for nm in entry_axes(last_axis):
            sz *= _axis_size(mesh, nm)
        assign = entries[:-1] + [last_axis if (last_axis and nb % sz == 0)
                                 else None, None]
        return spec(*assign[:ndim])
    if ("moe" in path and any(f"'{k}'" in path for k in ("wi", "wg", "wo"))
            and ndim == 4):
        # stacked expert weights [L, E, a, b]
        L, E, a, b = shape
        if E % model == 0:
            # expert parallelism over model + ZeRO-3 over data
            assign[1] = "model"
            if a % data == 0:
                assign[2] = "data"
        else:
            # tensor-parallel experts (e.g. 60 experts vs 16-way model axis)
            if "'wo'" in path:       # [L, E, F, D]: row-parallel
                if a % model == 0:
                    assign[2] = "model"
                if b % data == 0:
                    assign[3] = "data"
            else:                    # [L, E, D, F]: column-parallel
                if a % data == 0:
                    assign[2] = "data"
                if b % model == 0:
                    assign[3] = "model"
        return spec(*assign)
    if "lm_head" in path:
        if ndim >= 2:  # [D, V]: vocab-parallel output head
            D, V = shape[-2], shape[-1]
            if V % model == 0:
                assign[ndim - 1] = "model"
            if D % data == 0:
                assign[ndim - 2] = "data"
            return spec(*assign)
    if "embed" in path or "items" in path:
        if ndim >= 2:  # [V, D]
            V, D = shape[-2], shape[-1]
            if V % model == 0:
                assign[ndim - 2] = "model"
            if D % data == 0:
                assign[ndim - 1] = "data"
            return spec(*assign)
    # Megatron column/row parallel for transformer projections: inputs of
    # up-projections FSDP over data, outputs over model; down-projections
    # ('wo') the reverse (row-parallel).
    if ndim - start == 2:
        a, b = ndim - 2, ndim - 1
        if any(f"'{n}'" in path for n in ("wq", "wk", "wv", "wi", "wg",
                                          "router", "down", "rbf_proj")):
            if shape[a] % data == 0:
                assign[a] = "data"
            if shape[b] % model == 0:
                assign[b] = "model"
            return spec(*assign)
        if "'wo'" in path or "'out_proj'" in path:
            if shape[a] % model == 0:
                assign[a] = "model"
            if shape[b] % data == 0:
                assign[b] = "data"
            return spec(*assign)

    # ---- generic 2D+ rule ---------------------------------------------
    if ndim - start >= 2:
        dims = list(range(start, ndim))
        by_size = sorted(dims, key=lambda d: -shape[d])
        for d in by_size:
            if shape[d] % model == 0:
                assign[d] = "model"
                break
        for d in by_size:
            if assign[d] is None and shape[d] % data == 0:
                assign[d] = "data"
                break
        return spec(*assign)
    return spec()  # vectors / norms replicated


def _with_paths(tree, path: str = ""):
    """(key path, leaf) pairs in the reference's ``keystr`` spelling: a
    dict key ``['k']``, a list or tuple index ``[i]``, a NamedTuple field
    ``.name``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _with_paths(v, f"{path}['{k}']")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _with_paths(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _with_paths(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, values) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return None if tree is None else next(values)


def params_shardings(params: Any, mesh: Mesh, stacked_key: str = "layers"
                     ) -> Any:
    """A tree of spec tuples shaped like ``params`` (tensors, meta tensors
    or anything with a ``shape``)."""
    specs = (_leaf_spec(p, tuple(leaf.shape), mesh, stacked_key in p)
             for p, leaf in _with_paths(params))
    return _rebuild(params, iter(list(specs)))


def spec_leaves(specs: Any) -> list:
    """The spec tuples of a tree of specs (from :func:`params_shardings`),
    in the order ``models.common.tree_leaves`` gives the tensors."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in spec_leaves(v)]
    if isinstance(specs, list) or hasattr(specs, "_fields"):
        return [s for v in specs for s in spec_leaves(v)]
    return [] if specs is None else [specs]


def replicated(mesh: Mesh) -> Spec:
    return spec()


def batch_sharding(mesh: Mesh, ndim: int, batch_dim: int = 0) -> Spec:
    """Shard dim ``batch_dim`` over the pod+data axes; rest replicated."""
    entries: list = [None] * ndim
    entries[batch_dim] = data_axes(mesh)
    return spec(*entries)


def dim_sharding(mesh: Mesh, ndim: int, assignments: dict) -> Spec:
    """assignments: {dim_index: axis or tuple-of-axes}."""
    entries: list = [None] * ndim
    for d, a in assignments.items():
        entries[d] = a
    return spec(*entries)


def kv_cache_shardings(mesh: Mesh, cfg, batch: int, max_len: int
                       ) -> Dict[str, Spec]:
    """Cache [L, B, Hkv, S, Dh]: batch over data axes when divisible, else
    the sequence dim shards over every available axis (split-KV decode)."""
    daxes = data_axes(mesh)
    dsize = axis_product(mesh, daxes)
    model = _axis_size(mesh, "model")
    if batch % dsize == 0:
        spec_kv = spec(None, daxes, None,
                       "model" if max_len % model == 0 else None, None)
        spec_len = spec(daxes)
    else:
        all_axes = tuple(list(daxes) + (["model"] if model > 1 else []))
        spec_kv = spec(None, None, None, all_axes, None)
        spec_len = spec()
    return {"k": spec_kv, "v": spec_kv, "len": spec_len}


# ----------------------------------------------------- blocks of a rank

def spec_axes(sp: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over."""
    return tuple(a for e in sp for a in entry_axes(e))


def n_replicas(sp: Spec, mesh: Mesh) -> int:
    """How many ranks hold each block of a tensor with this spec."""
    return mesh.size // axis_product(mesh, spec_axes(sp))


def local_block(full: torch.Tensor, sp: Spec, mesh: Mesh) -> torch.Tensor:
    """The block of ``full`` this rank holds under ``sp`` (a view when it
    can be): along each sharded dim, the slice at this rank's row-major
    index over the entry's axes."""
    coords = mesh.coords()
    out = full
    for d, entry in enumerate(sp):
        axes = entry_axes(entry)
        if not axes:
            continue
        n = axis_product(mesh, axes)
        if out.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(full.shape)} does not split "
                             f"over {axes} ({n} ranks)")
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + coords[a]
        size = out.shape[d] // n
        out = out.narrow(d, idx * size, size)
    return out


def gather_full(block: torch.Tensor, sp: Spec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's block (differentiable)."""
    out = block
    for d, entry in enumerate(sp):
        axes = entry_axes(entry)
        if axes:
            out = C.all_gather(out, axes, mesh, axis=d)
    return out


def sum_over_replicas(x: torch.Tensor, sp: Spec, mesh: Mesh
                      ) -> torch.Tensor:
    """``x`` summed over the mesh axes ``sp`` does not shard: the
    cotangent of an input with spec ``sp``, as ``shard_map``'s transpose
    gives it, from each rank's local gradient of the global loss."""
    axes = tuple(a for a in mesh.axis_names if a not in spec_axes(sp))
    return C.psum(x, axes, mesh) if axes else x
