"""Checkpoint save/load and the reference-checkpoint importers (port of
``isbfsar_tpu/utils/checkpoint.py``).

A checkpoint is ``{step}.msgpack``, a Flax msgpack tree, plus the
``{step}.json`` sidecar. The port writes it with its own encoder
(``weights.msgpack_dumps``) and reads it with its own decoder
(``weights.msgpack_restore``), so the bytes are what
``flax.serialization.to_bytes`` writes for the same tree: each package reads
and resumes from the other's files. ``backend="orbax"`` writes an Orbax
``StandardCheckpointer`` directory ``{step}.orbax`` instead, JAX's layout, so
either package reads the other's too; orbax is imported only there, and the
card machine has none (there it raises ``ImportError``).

The importers bring the reference's upstream checkpoints to the port:
Tianxiaomo ``yolov4.pth``, the MetrABS EfficientNetV2-L variables,
torchvision ResNets and the TRXOS ``DISC.pth``. Each returns Flax-layout
variables ``{"params": ..., "batch_stats": ...}`` with numpy leaves, exactly
what JAX's importer of the same name returns for the same input;
``weights.convert_variables`` turns them into the port module's state dict
(``model.load_state_dict(convert_variables(imported))``). Those that fill a
template take one in the same layout: :func:`template_variables` makes it
from a port module. The same malformed inputs raise the same errors as in
JAX.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from isbfsar_tpu_torch.weights import (_flatten, _tensor, flax_tree, msgpack_dumps,
                                       msgpack_restore)


def save_checkpoint(directory: str, step: int, tree: Any, meta: Optional[Dict] = None,
                    backend: str = "msgpack") -> str:
    """Write one checkpoint (a tree of dicts with tensor or numpy leaves);
    returns its path.

    backend "msgpack" (default): one Flax msgpack file + JSON sidecar —
    compact, dependency-light, the live-service format. backend "orbax": an
    Orbax StandardCheckpointer directory, JAX's multi-chip training format;
    metadata goes in the same JSON sidecar. Both are discovered by
    :func:`latest_checkpoint` and read back by :func:`load_checkpoint`.
    """
    if backend not in ("msgpack", "orbax"):
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    os.makedirs(directory, exist_ok=True)
    if backend == "orbax":
        import orbax.checkpoint as ocp

        path = os.path.join(directory, f"{step}.orbax")
        with ocp.StandardCheckpointer() as ckptr:
            ckptr.save(os.path.abspath(path), _map(tree, _to_numpy), force=True)
    else:
        path = os.path.join(directory, f"{step}.msgpack")
        with open(path, "wb") as f:
            f.write(msgpack_dumps(tree))
    with open(os.path.join(directory, f"{step}.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    return path


def load_checkpoint(path: str, template: Any = None) -> Any:
    """Read a checkpoint written by :func:`save_checkpoint` of either package
    (dispatched on the path: directory = orbax, file = msgpack) as a tree of
    CPU tensors. With a ``template`` (a tree of dicts), the checkpoint must
    have the template's keys wherever the template has a dict, as Flax's
    ``from_bytes`` requires; a ``None`` in the template takes whatever the
    checkpoint holds there."""
    if os.path.isdir(path):
        import orbax.checkpoint as ocp

        with ocp.StandardCheckpointer() as ckptr:
            # restore into host numpy arrays of the saved shapes and types
            meta = ckptr.metadata(os.path.abspath(path))
            meta = getattr(getattr(meta, "item_metadata", meta), "tree", meta)
            target = _map(meta, lambda m: np.zeros(m.shape, m.dtype))
            tree = _map(ckptr.restore(os.path.abspath(path), target), _tensor)
    else:
        with open(path, "rb") as f:
            tree = msgpack_restore(f.read())
    if template is not None:
        _match(template, tree, "")
    return tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        import ml_dtypes  # orbax's own dependency

        return leaf.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return leaf.numpy()


def _match(template, tree, where: str) -> None:
    if not isinstance(template, dict):
        return
    if not isinstance(tree, dict) or set(template) != set(tree):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"checkpoint keys at {where or '/'}: {got}, expected {sorted(template)}")
    for k, v in template.items():
        _match(v, tree[k], f"{where}/{k}")


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = [
        (int(f.split(".")[0]), f)
        for f in os.listdir(directory)
        if (f.endswith(".msgpack") or f.endswith(".orbax"))
        and f.split(".")[0].isdigit()
    ]
    if not steps:
        return None
    return os.path.join(directory, max(steps)[1])


def template_variables(model) -> Dict[str, Any]:
    """A port module's Flax-layout variables with numpy leaves, every level
    in the module's registration order: the template the importers fill."""
    return _map(flax_tree(model.state_dict()), lambda t: t.numpy())


def _unflat(flat: Dict[tuple, Any]) -> Dict[str, Any]:
    """``flax.traverse_util.unflatten_dict``: nested dicts in the paths' order."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


# ------------------------------------------------------------- torch import


def strip_dataparallel(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Remove DataParallel 'module' path segments (reference ar.py:17-19).

    Segment-aware: only a whole dotted component named ``module`` is
    dropped — a plain substring replace would corrupt legitimate names
    like Tianxiaomo's ``resblock.module_list``.
    """
    return {
        ".".join(seg for seg in k.split(".") if seg != "module"): v
        for k, v in state_dict.items()
    }


def _t2n(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def _dense(sd, prefix):
    return {"kernel": _t2n(sd[f"{prefix}.weight"]).T, "bias": _t2n(sd[f"{prefix}.bias"])}


def import_trxos_torch(state_dict: Dict[str, Any], input_type: str = "skeleton") -> Dict[str, Any]:
    """Map the reference TRXOS torch state dict (reference
    modules/ar/utils/model.py parameter names) onto this framework's
    flax param tree (models/trx.py). Skeleton branch + transformer +
    discriminator; the RGB ResNet is imported via import_resnet_torch.
    """
    sd = strip_dataparallel(state_dict)
    params: Dict[str, Any] = {}
    if input_type in ("skeleton", "hybrid"):
        params["sk_extractor"] = {
            "fc1": _dense(sd, "features_extractor.sk.fc1"),
            "fc2": _dense(sd, "features_extractor.sk.fc2"),
        }
    params["transformer"] = {
        "k_linear": _dense(sd, "transformers.0.k_linear"),
        "v_linear": _dense(sd, "transformers.0.v_linear"),
        "norm_k": {
            "scale": _t2n(sd["transformers.0.norm_k.weight"]),
            "bias": _t2n(sd["transformers.0.norm_k.bias"]),
        },
    }
    if "discriminator.dimensionality_reduction.weight" in sd:
        params["discriminator"] = {
            "reduce": _dense(sd, "discriminator.dimensionality_reduction"),
            "fc1": _dense(sd, "discriminator.fc1"),
            "fc2": _dense(sd, "discriminator.fc2"),
            "fc3": _dense(sd, "discriminator.fc3"),
        }
    return {"params": params}


def import_resnet_torch(state_dict: Dict[str, Any], stage_sizes=(3, 4, 6, 3)) -> Dict[str, Any]:
    """Map a torchvision ResNet state dict onto models/resnet.py params
    (NCHW conv weights -> HWIO; BN running stats -> batch_stats)."""
    sd = strip_dataparallel(state_dict)

    def conv(name):
        return {"kernel": _t2n(sd[f"{name}.weight"]).transpose(2, 3, 1, 0)}

    def bn(name):
        return (
            {"scale": _t2n(sd[f"{name}.weight"]), "bias": _t2n(sd[f"{name}.bias"])},
            {"mean": _t2n(sd[f"{name}.running_mean"]), "var": _t2n(sd[f"{name}.running_var"])},
        )

    params: Dict[str, Any] = {"conv1": conv("conv1")}
    stats: Dict[str, Any] = {}
    params["bn1"], stats["bn1"] = bn("bn1")

    bottleneck = any(k.startswith("layer1.0.conv3") for k in sd)
    convs = ("conv1", "conv2", "conv3") if bottleneck else ("conv1", "conv2")
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            t = f"layer{i+1}.{j}"
            f = f"layer{i+1}_{j}"
            blk_p: Dict[str, Any] = {}
            blk_s: Dict[str, Any] = {}
            for ci, cname in enumerate(convs, start=1):
                blk_p[f"conv{ci}"] = conv(f"{t}.{cname}")
                blk_p[f"bn{ci}"], blk_s[f"bn{ci}"] = bn(f"{t}.bn{ci}")
            if f"{t}.downsample.0.weight" in sd:
                blk_p["downsample_conv"] = conv(f"{t}.downsample.0")
                blk_p["downsample_bn"], blk_s["downsample_bn"] = bn(f"{t}.downsample.1")
            params[f] = blk_p
            stats[f] = blk_s
    if "fc.weight" in sd:
        params["fc"] = {"kernel": _t2n(sd["fc.weight"]).T, "bias": _t2n(sd["fc.bias"])}
    return {"params": params, "batch_stats": stats}


def rename_params(tree: Dict[str, Any], renames: Dict[str, str]) -> Dict[str, Any]:
    """Checkpoint-migration utility: rename parameter path segments.

    The reference ships a torch layer-renaming migration script
    (reference utils/rename_torch_layers_and_parameters.py:1-18); this is the
    flax-tree equivalent: ``renames`` maps old path segments (or full
    '/'-joined prefixes) to new ones, applied to every leaf path.

    Example: rename_params(ckpt, {"post_resnet": "rgb_extractor/post"}).

    Matching is segment-aligned: an entry only fires when its '/'-split
    old segments match whole consecutive path segments (so renaming "fc1"
    never touches "fc10" or "myfc1").
    """
    split_renames = [
        (tuple(old.split("/")), tuple(new.split("/"))) for old, new in renames.items()
    ]

    def apply(path):
        path = list(path)
        for old, new in split_renames:
            i = 0
            while i + len(old) <= len(path):
                if tuple(path[i : i + len(old)]) == old:
                    path[i : i + len(old)] = list(new)
                    i += len(new)
                else:
                    i += 1
        return tuple(path)

    flat = _flatten(tree)
    out = {apply(path): leaf for path, leaf in flat.items()}
    return _unflat(out)


def import_ordered_convnet(state_dict: Dict[str, Any], variables: Dict[str, Any]):
    """Order-based torch->flax convnet import (generic fallback).

    CAUTION: correctness depends on the template iterating in definition
    order. In the port that is :func:`template_variables`, the module's
    registration order, which equals Flax's definition order on YOLOv4,
    EfficientNetV2 and the ResNets (tests/test_torch_upstream_import.py).
    ``weights.to_flax_variables`` sorts the keys, as ``jax.tree.map`` does,
    and is no template here. For the actual reference
    checkpoints use the explicit name-mapped importers instead:
    :func:`import_yolov4_tianxiaomo`, :func:`import_metrabs_effnetv2`
    (order-independent, auditable, tested against vendored upstream
    layouts in tests/fixtures_upstream.py).

    The reference's engine toolchain consumes upstream torch/TF checkpoints
    whose module names don't match ours (Tianxiaomo YOLOv4, MetrABS
    EffNetV2). For architectures rebuilt with the SAME layer order, torch's
    ``state_dict`` iteration order (registration order) corresponds 1:1 to
    the flax tree's definition order — so parameters can be zipped by kind:

    - 4D conv weights -> next flax conv ``kernel`` (OIHW -> HWIO; depthwise
      OIHW with I==1 -> HWIO with O in the last axis)
    - 2D linear weights (+bias) -> next flax dense kernel/bias
    - BN weight/bias/running_mean/running_var -> next flax bn
      scale/bias + batch_stats mean/var

    Every assignment is shape-checked; a mismatch raises with both paths so
    drift is caught immediately instead of silently corrupting weights.

    Returns a new variables dict (params + batch_stats filled).
    """
    sd = strip_dataparallel(state_dict)

    flat_params = dict(_flatten(variables["params"]))
    flat_stats = dict(_flatten(variables.get("batch_stats", {})))

    conv_keys = [k for k in flat_params if k[-1] == "kernel" and flat_params[k].ndim == 4]
    dense_keys = [k for k in flat_params if k[-1] == "kernel" and flat_params[k].ndim == 2]
    scale_keys = [k for k in flat_params if k[-1] == "scale"]

    def bias_for(kernel_key):
        bk = kernel_key[:-1] + ("bias",)
        return bk if bk in flat_params else None

    out_p = dict(flat_params)
    out_s = dict(flat_stats)
    ci = di = si = 0

    items = list(sd.items())
    i = 0
    while i < len(items):
        name, t = items[i]
        arr = _t2n(t)
        if name.endswith("num_batches_tracked"):
            i += 1
            continue
        if arr.ndim == 4 and name.endswith("weight"):
            key = conv_keys[ci]
            ci += 1
            want = out_p[key].shape
            # OIHW -> HWIO (depthwise OIHW with I==1 maps the same way)
            mapped = arr.transpose(2, 3, 1, 0)
            if tuple(mapped.shape) != tuple(want):
                raise ValueError(f"conv shape mismatch: torch {name} {mapped.shape} "
                                 f"vs flax {'/'.join(key)} {want}")
            out_p[key] = mapped
            bk = bias_for(key)
            if i + 1 < len(items) and items[i + 1][0].endswith("bias") and bk is not None \
                    and _t2n(items[i + 1][1]).ndim == 1 \
                    and _t2n(items[i + 1][1]).shape[0] == mapped.shape[3]:
                out_p[bk] = _t2n(items[i + 1][1])
                i += 1
        elif arr.ndim == 2 and name.endswith("weight"):
            key = dense_keys[di]
            di += 1
            mapped = arr.T
            if tuple(mapped.shape) != tuple(out_p[key].shape):
                raise ValueError(f"dense shape mismatch: torch {name} {mapped.shape} "
                                 f"vs flax {'/'.join(key)} {out_p[key].shape}")
            out_p[key] = mapped
            bk = bias_for(key)
            if i + 1 < len(items) and items[i + 1][0].endswith("bias") and bk is not None:
                out_p[bk] = _t2n(items[i + 1][1])
                i += 1
        elif arr.ndim == 1 and name.endswith("weight"):
            # BatchNorm gamma; expect bias/mean/var to follow
            key = scale_keys[si]
            si += 1
            if arr.shape != out_p[key].shape:
                raise ValueError(f"bn shape mismatch: torch {name} {arr.shape} "
                                 f"vs flax {'/'.join(key)} {out_p[key].shape}")
            out_p[key] = arr
            base = key[:-1]
            fields = {"bias": base + ("bias",)}
            j = i + 1
            while j < len(items) and j <= i + 3:
                n2, t2 = items[j]
                a2 = _t2n(t2)
                if n2.endswith("bias") and fields.get("bias") in out_p:
                    out_p[fields["bias"]] = a2
                elif n2.endswith("running_mean"):
                    sk = _match_stat(flat_stats, base, "mean")
                    if sk is not None:
                        out_s[sk] = a2
                elif n2.endswith("running_var"):
                    sk = _match_stat(flat_stats, base, "var")
                    if sk is not None:
                        out_s[sk] = a2
                else:
                    break
                j += 1
            i = j - 1
        i += 1

    params = _unflat(out_p)
    result = {"params": params}
    if flat_stats:
        result["batch_stats"] = _unflat(out_s)
    return result


def _match_stat(flat_stats, param_base, leaf):
    """Find the batch_stats key corresponding to a params bn path.

    flax stores bn params under .../<bn_name>/{scale,bias} and stats under
    .../<bn_name>/{mean,var}; the path prefix is identical."""
    key = param_base + (leaf,)
    return key if key in flat_stats else None


def import_tf_vars(tf_vars, variables: Dict[str, Any], strict: bool = True):
    """Layer-grouped TF->flax convnet import (the MetrABS EffNetV2-L path).

    ``tf_vars``: list of (name, numpy array) as yielded by the reference's
    extraction script (``model.crop_model.variables``,
    setup/2_extract_bbone_heads.py:36-47, consumed via Keras
    ``set_weights``). Keras ``Model.variables`` lists all TRAINABLE weights
    (kernels/gammas/betas/biases) in layer-creation order first, followed by
    the non-trainable BN moving statistics — so a purely positional zip
    would scramble the moving means/variances. This importer instead groups
    variables by their layer prefix (name minus the trailing leaf), orders
    layer groups by first appearance, and zips groups onto the flax tree in
    definition order (it therefore accepts both the trainable-first and the
    per-layer-interleaved layouts):

    - group with a 4D kernel -> next flax conv kernel (TF kernels are
      already HWIO; depthwise (h, w, c, 1) transposed to flax (h, w, 1, c));
      a 1-D 'bias' in the same group -> that conv's bias
    - group with a 2D kernel -> next flax dense kernel (+bias)
    - group with 'gamma' -> next flax bn: gamma->scale, beta->bias,
      moving_mean->batch_stats mean, moving_variance->batch_stats var

    Every assignment is shape-checked, and any unconsumed TF variable raises
    (``strict=True``) so import drift cannot pass silently.
    """
    flat_params = dict(_flatten(variables["params"]))
    flat_stats = dict(_flatten(variables.get("batch_stats", {})))
    conv_keys = [k for k in flat_params if k[-1] == "kernel" and flat_params[k].ndim == 4]
    dense_keys = [k for k in flat_params if k[-1] == "kernel" and flat_params[k].ndim == 2]
    scale_keys = [k for k in flat_params if k[-1] == "scale"]

    # --- group variables by layer prefix, in order of first appearance
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    group_order = []
    for name, val in tf_vars:
        arr = np.asarray(val)
        base, _, leaf = name.rpartition("/")
        leaf = leaf.split(":")[0]
        if base not in groups:
            groups[base] = {}
            group_order.append(base)
        if leaf in groups[base]:
            raise ValueError(f"duplicate tf variable leaf {name!r}")
        groups[base][leaf] = arr

    out_p = dict(flat_params)
    out_s = dict(flat_stats)
    ci = di = si = 0

    def check(name, arr, key, store):
        if tuple(arr.shape) != tuple(store[key].shape):
            raise ValueError(
                f"shape mismatch: tf {name} {arr.shape} vs flax "
                f"{'/'.join(key)} {store[key].shape}"
            )

    for base in group_order:
        g = groups[base]
        consumed = set()
        kernels4 = [l for l, a in g.items() if a.ndim == 4]
        kernels2 = [l for l, a in g.items() if a.ndim == 2]
        if kernels4:
            (leaf,) = kernels4  # one conv per TF layer scope
            arr = g[leaf]
            if ci >= len(conv_keys):
                raise ValueError(f"tf conv {base}/{leaf} has no flax conv left")
            key = conv_keys[ci]
            ci += 1
            want = out_p[key].shape
            if tuple(arr.shape) != tuple(want) and arr.shape[-1] == 1 and want[-2] == 1:
                arr = arr.transpose(0, 1, 3, 2)  # TF depthwise HWC1 -> flax HW1C
            check(f"{base}/{leaf}", arr, key, out_p)
            out_p[key] = arr
            consumed.add(leaf)
            if "bias" in g:
                bk = key[:-1] + ("bias",)
                if bk not in out_p:
                    raise ValueError(
                        f"tf {base}/bias but flax conv {'/'.join(key[:-1])} has no bias"
                    )
                check(f"{base}/bias", g["bias"], bk, out_p)
                out_p[bk] = g["bias"]
                consumed.add("bias")
        elif kernels2:
            (leaf,) = kernels2
            if di >= len(dense_keys):
                raise ValueError(f"tf dense {base}/{leaf} has no flax dense left")
            key = dense_keys[di]
            di += 1
            check(f"{base}/{leaf}", g[leaf], key, out_p)
            out_p[key] = g[leaf]
            consumed.add(leaf)
            if "bias" in g:
                bk = key[:-1] + ("bias",)
                check(f"{base}/bias", g["bias"], bk, out_p)
                out_p[bk] = g["bias"]
                consumed.add("bias")
        elif "gamma" in g or "beta" in g or "moving_mean" in g:
            if si >= len(scale_keys):
                raise ValueError(f"tf bn {base} has no flax bn left")
            key = scale_keys[si]
            si += 1
            bn_base = key[:-1]
            mapping = {
                "gamma": ("p", key),
                "beta": ("p", bn_base + ("bias",)),
                "moving_mean": ("s", bn_base + ("mean",)),
                "moving_variance": ("s", bn_base + ("var",)),
            }
            for leaf, (store_kind, k) in mapping.items():
                if leaf not in g:
                    continue
                store = out_p if store_kind == "p" else out_s
                if k not in store:
                    if store_kind == "s" and not flat_stats:
                        consumed.add(leaf)  # caller passed a params-only template
                        continue
                    raise ValueError(f"tf bn leaf {base}/{leaf}: no flax slot {'/'.join(k)}")
                check(f"{base}/{leaf}", g[leaf], k, store)
                store[k] = g[leaf]
                consumed.add(leaf)
        unconsumed = set(g) - consumed
        if unconsumed and strict:
            raise ValueError(
                f"unconsumed tf variables in layer {base!r}: {sorted(unconsumed)}"
            )

    result = {"params": _unflat(out_p)}
    if flat_stats:
        result["batch_stats"] = _unflat(out_s)
    return result


# --------------------------------------------------- name-mapped importers
#
# The order-based importers above zip parameters by (kind, iteration order),
# which is provably correct only when the template's iteration order equals
# the upstream registration order — an invariant that silently breaks if the
# variables dict has been rebuilt in sorted-key order (to_flax_variables and
# jax.tree.map do this) or if two identically-shaped layers swap. The name-mapped importers
# below take an EXPLICIT correspondence (upstream layer prefix -> flax
# module path) generated per-architecture (models/yolov4.py
# tianxiaomo_name_map, models/effnetv2.py metrabs_tf_name_map), making the
# mapping order-independent and auditable layer by layer against the
# upstream sources.


def _assign_checked(store, key, arr, src_name):
    if key not in store:
        raise KeyError(f"{src_name}: no flax slot {'/'.join(key)}")
    if tuple(arr.shape) != tuple(store[key].shape):
        raise ValueError(
            f"shape mismatch: {src_name} {arr.shape} vs flax "
            f"{'/'.join(key)} {store[key].shape}"
        )
    store[key] = arr


def import_named_convnet(
    state_dict: Dict[str, Any],
    variables: Dict[str, Any],
    name_map: Dict[str, tuple],
    strict: bool = True,
):
    """Torch->flax import driven by an explicit module-prefix map.

    ``name_map`` maps a torch parameter prefix (the module path, e.g.
    ``"down1.conv1.conv.0"``) to the flax module path tuple it corresponds
    to (e.g. ``("backbone", "stem", "conv")``). Per prefix, the torch
    parameter kinds decide the leaf mapping:

    - 4D ``{p}.weight``  -> conv ``kernel`` (OIHW -> HWIO; depthwise OIHW
      with I==1 -> flax (h, w, 1, c)), optional ``{p}.bias``
    - 2D ``{p}.weight``  -> dense ``kernel`` (transposed), ``{p}.bias``
    - 1D ``{p}.weight`` + ``{p}.running_mean`` present -> batchnorm:
      weight->scale, bias->bias, running_mean/var -> batch_stats mean/var

    strict=True raises if any torch parameter (except num_batches_tracked)
    is not consumed or any map entry matched nothing — import drift is loud.
    """
    sd = strip_dataparallel(state_dict)
    flat_p = dict(_flatten(variables["params"]))
    flat_s = dict(_flatten(variables.get("batch_stats", {})))
    consumed = set()

    for prefix, flax_path in name_map.items():
        flax_path = tuple(flax_path)
        wk = f"{prefix}.weight"
        if wk not in sd:
            if strict:
                raise KeyError(f"name_map prefix {prefix!r}: no {wk} in state dict")
            continue
        w = _t2n(sd[wk])
        if w.ndim == 4:
            # OIHW -> HWIO; depthwise OIHW with I==1 lands on flax (h, w, 1, c)
            # under the same transpose.
            _assign_checked(flat_p, flax_path + ("kernel",), w.transpose(2, 3, 1, 0), wk)
            consumed.add(wk)
            bk = f"{prefix}.bias"
            if bk in sd:
                _assign_checked(flat_p, flax_path + ("bias",), _t2n(sd[bk]), bk)
                consumed.add(bk)
        elif w.ndim == 2:
            _assign_checked(flat_p, flax_path + ("kernel",), w.T, wk)
            consumed.add(wk)
            bk = f"{prefix}.bias"
            if bk in sd:
                _assign_checked(flat_p, flax_path + ("bias",), _t2n(sd[bk]), bk)
                consumed.add(bk)
        elif w.ndim == 1 and f"{prefix}.running_mean" in sd:
            _assign_checked(flat_p, flax_path + ("scale",), w, wk)
            _assign_checked(flat_p, flax_path + ("bias",), _t2n(sd[f"{prefix}.bias"]), f"{prefix}.bias")
            _assign_checked(flat_s, flax_path + ("mean",), _t2n(sd[f"{prefix}.running_mean"]), f"{prefix}.running_mean")
            _assign_checked(flat_s, flax_path + ("var",), _t2n(sd[f"{prefix}.running_var"]), f"{prefix}.running_var")
            consumed |= {wk, f"{prefix}.bias", f"{prefix}.running_mean", f"{prefix}.running_var"}
        else:
            raise ValueError(f"{wk}: unsupported kind (ndim={w.ndim})")

    leftover = [k for k in sd if k not in consumed and not k.endswith("num_batches_tracked")]
    if leftover and strict:
        raise ValueError(f"unconsumed torch parameters ({len(leftover)}): {leftover[:8]}...")

    result = {"params": _unflat(flat_p)}
    if flat_s:
        result["batch_stats"] = _unflat(flat_s)
    return result


def import_tf_name_map(
    tf_vars,
    variables: Dict[str, Any],
    name_map: Dict[str, tuple],
    strict: bool = True,
):
    """TF->flax import driven by an explicit layer-scope map.

    ``tf_vars``: list of (name, array) (reference extraction contract,
    setup/2_extract_bbone_heads.py:36-47). ``name_map`` maps a TF layer
    scope (e.g. ``"blocks_0/conv2d"``) to a flax module path tuple. A
    leading model-name scope component on the variable (e.g.
    ``"efficientnetv2-l/"``) is stripped automatically when the full name
    has no map entry. Leaf mapping: kernel/depthwise_kernel -> conv kernel
    (TF HWIO kept; depthwise HWC1 -> flax HW1C), bias -> bias, 2D kernel ->
    dense, gamma/beta/moving_mean/moving_variance -> bn + batch_stats.
    """
    flat_p = dict(_flatten(variables["params"]))
    flat_s = dict(_flatten(variables.get("batch_stats", {})))
    matched_scopes = set()

    for name, val in tf_vars:
        arr = np.asarray(val)
        base, _, leaf = name.rpartition("/")
        leaf = leaf.split(":")[0]
        scope = base
        if scope not in name_map and "/" in scope:
            scope = scope.split("/", 1)[1]  # strip the model-name scope
        if scope not in name_map:
            if strict:
                raise KeyError(f"tf variable {name!r}: scope {base!r} not in name_map")
            continue
        flax_path = tuple(name_map[scope])
        matched_scopes.add(scope)
        if leaf in ("kernel", "depthwise_kernel") and arr.ndim == 4:
            want = flat_p.get(flax_path + ("kernel",))
            if want is None:
                raise KeyError(f"{name}: no flax conv at {'/'.join(flax_path)}")
            if tuple(arr.shape) != tuple(want.shape) and arr.shape[-1] == 1 and want.shape[-2] == 1:
                arr = arr.transpose(0, 1, 3, 2)  # TF depthwise HWC1 -> flax HW1C
            _assign_checked(flat_p, flax_path + ("kernel",), arr, name)
        elif leaf == "kernel" and arr.ndim == 2:
            _assign_checked(flat_p, flax_path + ("kernel",), arr, name)
        elif leaf == "bias":
            _assign_checked(flat_p, flax_path + ("bias",), arr, name)
        elif leaf == "gamma":
            _assign_checked(flat_p, flax_path + ("scale",), arr, name)
        elif leaf == "beta":
            _assign_checked(flat_p, flax_path + ("bias",), arr, name)
        elif leaf == "moving_mean":
            _assign_checked(flat_s, flax_path + ("mean",), arr, name)
        elif leaf == "moving_variance":
            _assign_checked(flat_s, flax_path + ("var",), arr, name)
        else:
            raise ValueError(f"tf variable {name!r}: unrecognized leaf {leaf!r}")

    unused = set(name_map) - matched_scopes
    if unused and strict:
        raise ValueError(f"name_map entries matched no tf variable: {sorted(unused)[:8]}...")

    result = {"params": _unflat(flat_p)}
    if flat_s:
        result["batch_stats"] = _unflat(flat_s)
    return result


def trxos_extract_rgb(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Extract the rgb branch of a reference TRXOS checkpoint as a
    torchvision-named ResNet state dict.

    The reference wraps torchvision resnet50's children in an nn.Sequential
    (reference model.py:275-276: ``nn.Sequential(*list(resnet.children())[:-1])``),
    so DISC.pth keys look like ``features_extractor.rgb.0.weight``. Children
    indices: 0=conv1, 1=bn1, 4..7=layer1..4 (2/3 are param-free relu/pool,
    8=avgpool; fc was dropped). Returns {} when no rgb branch is present.
    """
    sd = strip_dataparallel(state_dict)
    index_names = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
                   "6": "layer3", "7": "layer4"}
    out = {}
    prefix = "features_extractor.rgb."
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        rest = k[len(prefix):]
        idx, _, tail = rest.partition(".")
        if idx not in index_names:
            raise KeyError(f"unexpected rgb child index in {k!r}")
        out[f"{index_names[idx]}.{tail}" if tail else index_names[idx]] = v
    return out


def import_yolov4_tianxiaomo(state_dict: Dict[str, Any], variables: Dict[str, Any],
                             strict: bool = True):
    """Import the Tianxiaomo ``yolov4.pth`` checkpoint (the file the
    reference's engine toolchain consumes, setup/1_extract_yolo_onnx.py)
    onto models/yolov4.py. Accepts both the raw upstream key spelling
    (``neek.*``) and the reference's rewritten one (``neck.*``)."""
    from isbfsar_tpu_torch.models.yolov4 import tianxiaomo_name_map

    prefix = "neck" if any(k.startswith("neck.") for k in state_dict) else "neek"
    return import_named_convnet(state_dict, variables,
                                tianxiaomo_name_map(neck_prefix=prefix), strict=strict)


def import_metrabs_effnetv2(tf_vars, variables: Dict[str, Any], strict: bool = True):
    """Import the MetrABS EfficientNetV2-L backbone variables (the list the
    reference extracts via ``model.crop_model.variables`` and pours into a
    fresh Keras model, setup/2_extract_bbone_heads.py:36-47) onto
    models/effnetv2.py."""
    from isbfsar_tpu_torch.models.effnetv2 import metrabs_tf_name_map

    return import_tf_name_map(tf_vars, variables, metrabs_tf_name_map(), strict=strict)


def import_trxos_full(state_dict: Dict[str, Any], input_type: str = "skeleton"):
    """Assemble the COMPLETE flax TRXOS variables from a reference DISC/EXP
    checkpoint: skeleton MLP + transformer + discriminator
    (:func:`import_trxos_torch`) plus, for rgb/hybrid checkpoints, the
    ResNet-50 rgb branch (``features_extractor.rgb.*`` Sequential children,
    reference model.py:275-276) and the PostResNet projection
    (``post_resnet.l1``, model.py:207-216)."""
    out = import_trxos_torch(state_dict, input_type)
    if input_type not in ("rgb", "hybrid"):
        return out
    sd = strip_dataparallel(state_dict)
    rgb = trxos_extract_rgb(sd)
    if not rgb:
        raise KeyError(f"input_type={input_type!r} but no features_extractor.rgb.* keys")
    rn = import_resnet_torch(rgb)
    out["params"]["rgb_extractor"] = {
        "ResNet_0": rn["params"],
        "post": _dense(sd, "post_resnet.l1"),
    }
    out["batch_stats"] = {"rgb_extractor": {"ResNet_0": rn["batch_stats"]}}
    return out
