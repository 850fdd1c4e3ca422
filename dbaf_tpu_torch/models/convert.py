"""Weight loaders for the port's :class:`~dbaf_tpu_torch.models.net.DroidNet`.

Two sources:

* :func:`from_jax_params` takes the JAX package's Flax parameter tree (numpy
  arrays, HWIO kernels, fused GRU/head convs of its ``models/net.py``) and
  returns the port's ``state_dict`` -- the port's modules carry the same
  fused layout, so this is a transpose to OIHW (the GraphAgg head
  ``update.agg`` included, where the tree has it);
* :func:`load_reference_state_dict` takes a reference-format checkpoint
  (``module.``-prefixed keys, 3-channel update heads, dbaf.py:38-48),
  checks its keys and shapes against a manifest, strips the prefix, slices
  the heads to 2 channels, fuses the GRU/head convs and returns the same
  ``state_dict``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

# update heads that are sliced to 2 output channels (dbaf.py:42-45)
_HEAD_SLICE = {
    ("update", "delta_2", "kernel"): 2,
    ("update", "delta_2", "bias"): 2,
    ("update", "weight_2", "kernel"): 2,
    ("update", "weight_2", "bias"): 2,
}

def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params tree (``{'fnet':..., 'cnet':..., 'update':...}``, numpy
    or array-likes) -> the port's ``state_dict`` (f32 tensors)."""
    sd = {}
    for path, value in _flatten(params):
        arr = np.asarray(value, dtype=np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise ValueError(f"from_jax_params: unexpected leaf {'.'.join(path)}")
        sd[".".join(path[:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def _translate_key(key: str) -> Tuple[str, ...]:
    """Reference state-dict key -> path in the fused tree."""
    key = re.sub(r"^module\.", "", key)
    key = re.sub(r"\.layer(\d)\.(\d)\.", r".layer\1_\2.", key)
    key = key.replace(".downsample.0.", ".downsample.")
    key = re.sub(
        r"\.(corr_encoder|flow_encoder|weight|delta|eta|upmask)\.(\d)\.",
        r".\1_\2.",
        key,
    )
    parts = key.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}[parts[-1]]
    return tuple(parts[:-1]) + (leaf,)


def _fuse_heads(tree: Dict) -> None:
    """Repack the reference's GRU convz/convr/convq, the *_glo convs and
    the delta_0/weight_0 heads into the fused layout (slices and concats of
    HWIO kernels only)."""
    for v in tree.values():
        if isinstance(v, dict):
            _fuse_heads(v)
    if all(isinstance(tree.get(n), dict) for n in ("convz", "convr", "convq")):
        kz, kr, kq = (tree.pop(n) for n in ("convz", "convr", "convq"))
        h = kz["kernel"].shape[-1]
        tree["convzrq_i"] = {
            "kernel": np.concatenate([k["kernel"][:, :, h:] for k in (kz, kr, kq)], axis=-1),
            "bias": np.concatenate([k["bias"] for k in (kz, kr, kq)]),
        }
        tree["convzr_n"] = {
            "kernel": np.concatenate([kz["kernel"][:, :, :h], kr["kernel"][:, :, :h]], axis=-1)
        }
        tree["convq_n"] = {"kernel": kq["kernel"][:, :, :h]}
    if all(n in tree for n in ("convz_glo", "convr_glo", "convq_glo")):
        gz, gr, gq = (tree.pop(n) for n in ("convz_glo", "convr_glo", "convq_glo"))
        tree["convzrq_glo"] = {
            "kernel": np.concatenate([g["kernel"] for g in (gz, gr, gq)], axis=-1),
            "bias": np.concatenate([g["bias"] for g in (gz, gr, gq)]),
        }
    if "delta_0" in tree and "weight_0" in tree:
        d0, w0 = tree.pop("delta_0"), tree.pop("weight_0")
        tree["dw_0"] = {
            "kernel": np.concatenate([d0["kernel"], w0["kernel"]], axis=-1),
            "bias": np.concatenate([d0["bias"], w0["bias"]]),
        }


def load_reference_state_dict(
    state: Mapping[str, object],
    manifest: Optional[Sequence[Tuple[str, Sequence[int]]]] = None,
) -> Dict[str, torch.Tensor]:
    """Reference-format checkpoint (tensors or numpy arrays) -> the port's
    ``state_dict``.  With ``manifest`` (the ``[key, shape]`` list of the
    published checkpoint) the keys and shapes must match it exactly."""
    if manifest is not None:
        want = {k: tuple(s) for k, s in manifest}
        got = {k: tuple(np.shape(v)) for k, v in state.items()}
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        if missing or extra:
            raise ValueError(f"checkpoint keys differ from the manifest: missing "
                             f"{missing[:5]}, unexpected {extra[:5]}")
        bad = [k for k in want if want[k] != got[k]]
        if bad:
            raise ValueError(f"checkpoint shapes differ from the manifest at {bad[:5]}")
    tree: Dict = {}
    for key, value in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        arr = np.asarray(value, dtype=np.float32)
        path = _translate_key(key)
        if path[-1] == "kernel" and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        nch = _HEAD_SLICE.get(path)
        if nch is not None:
            arr = arr[..., :nch] if path[-1] == "kernel" else arr[:nch]
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    _fuse_heads(tree)
    return from_jax_params(tree)


def synth_reference_state_dict(manifest: Sequence[Tuple[str, Sequence[int]]], seed: int):
    """He-scaled random weights in the reference checkpoint format, made
    from ``seed`` with numpy (conv kernels N(0, 1/fan_in), norm scales
    1 + 0.1 N, other vectors 0.02 N)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in manifest:
        shape = tuple(shape)
        if key.endswith("num_batches_tracked") or not shape:
            sd[key] = np.zeros(shape, np.int64)
        elif len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            sd[key] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        elif len(shape) == 1 and key.endswith(".weight"):
            sd[key] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif len(shape) == 1:
            sd[key] = (0.02 * rng.standard_normal(shape)).astype(np.float32)
        else:
            sd[key] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return sd
